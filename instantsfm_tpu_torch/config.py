"""Pipeline configuration.

Counterpart of ``instantsfm_tpu/config.py``: the same option groups and
default values as plain dicts on a dataclass; per-feature presets resolve by
name and user overrides merge on top.  The module-level groups
(``INLIER_THRESHOLD_OPTIONS``, ``GLOBAL_POSITIONER_OPTIONS``,
``BUNDLE_ADJUSTER_OPTIONS``) are the colmap preset's own dicts.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

GENERAL_OPTIONS = {
    "skip_preprocessing": False,
    "skip_view_graph_calibration": False,
    "skip_relative_pose_estimation": False,
    "skip_rotation_averaging": False,
    "skip_track_establishment": False,
    "skip_global_positioning": False,
    "skip_bundle_adjustment": False,
    "num_iteration_bundle_adjustment": 3,
    "skip_retriangulation": True,
    "num_iteration_retriangulation": 1,
    "skip_pruning": True,
    "uniform_camera": True,
}

COLMAP_CONFIG = {
    "VIEW_GRAPH_CALIBRATOR_OPTIONS": {
        "thres_lower_ratio": 0.1,
        "thres_higher_ratio": 10,
        "thres_two_view_error": 2.0,
        "thres_loss_function": 1e-2,
        "max_num_iterations": 100,
        "function_tolerance": 5e-4,
    },
    "INLIER_THRESHOLD_OPTIONS": {
        "max_angle_error": 1.0,
        "max_reprojection_error": 1e-2,
        "min_triangulation_angle": 1.0,
        "max_epipolar_error_E": 1.0,
        "max_epipolar_error_F": 4.0,
        "max_epipolar_error_H": 4.0,
        "min_inlier_num": 30,
        "min_inlier_ratio": 0.25,
        "max_rotation_error": 10.0,
    },
    "ROTATION_ESTIMATOR_OPTIONS": {
        "max_num_l1_iterations": 10,
        "l1_step_convergence_threshold": 0.001,
        "max_num_irls_iterations": 100,
        "irls_step_convergence_threshold": 0.001,
        "irls_loss_parameter_sigma": 5.0,
    },
    "L1_SOLVER_OPTIONS": {
        "max_num_iterations": 1000,
        "rho": 1.0,
        "alpha": 1.0,
        "absolute_tolerance": 1e-4,
        "relative_tolerance": 1e-2,
    },
    "TRACK_ESTABLISHMENT_OPTIONS": {
        "thres_inconsistency": 10.0,
        "min_num_view_per_track": 3,
        "max_num_view_per_track": 200,
    },
    "GLOBAL_POSITIONER_OPTIONS": {
        "min_num_view_per_track": 3,
        "thres_loss_function": 1e-1,
        "max_num_iterations": 100,
        "function_tolerance": 5e-4,
    },
    "BUNDLE_ADJUSTER_OPTIONS": {
        "optimize_poses": True,
        "optimize_points": True,
        "min_num_view_per_track": 2,
        "thres_loss_function": 1.0,
        "max_num_iterations": 200,
        "function_tolerance": 5e-4,
        # terminate on parameter stagnation (relative step < step_tolerance
        # for a window of iterations) instead of the cost window; None
        # restores the cost-window test
        "step_tolerance": 1e-6,
    },
    "TRIANGULATOR_OPTIONS": {
        "min_num_view_per_track": 2,
        "complete_max_reproj_error": 3.0,
        "merge_max_reproj_error": 3.0,
        "filter_max_reproj_error": 3.0,
        "filter_min_tri_angle": 1.5,
        "ba_global_max_refinements": 5,
        "ba_global_max_refinement_change": 0.0005,
    },
    "FEATURE_HANDLER_OPTIONS": {
        "min_num_matches": 30,
    },
}

INLIER_THRESHOLD_OPTIONS = COLMAP_CONFIG["INLIER_THRESHOLD_OPTIONS"]
GLOBAL_POSITIONER_OPTIONS = COLMAP_CONFIG["GLOBAL_POSITIONER_OPTIONS"]
BUNDLE_ADJUSTER_OPTIONS = COLMAP_CONFIG["BUNDLE_ADJUSTER_OPTIONS"]

_PRESETS = {"colmap": COLMAP_CONFIG}


@dataclass
class Config:
    feature_name: str = "colmap"
    OPTIONS: dict = field(default_factory=lambda: copy.deepcopy(GENERAL_OPTIONS))
    VIEW_GRAPH_CALIBRATOR_OPTIONS: dict = None
    INLIER_THRESHOLD_OPTIONS: dict = None
    ROTATION_ESTIMATOR_OPTIONS: dict = None
    L1_SOLVER_OPTIONS: dict = None
    TRACK_ESTABLISHMENT_OPTIONS: dict = None
    GLOBAL_POSITIONER_OPTIONS: dict = None
    BUNDLE_ADJUSTER_OPTIONS: dict = None
    TRIANGULATOR_OPTIONS: dict = None
    FEATURE_HANDLER_OPTIONS: dict = None

    def __post_init__(self):
        preset_name = self.feature_name if self.feature_name in _PRESETS else "colmap"
        preset = copy.deepcopy(_PRESETS[preset_name])
        for key, val in preset.items():
            if getattr(self, key) is None:
                setattr(self, key, val)

    @staticmethod
    def register_preset(name: str, config: dict) -> None:
        _PRESETS[name] = config
