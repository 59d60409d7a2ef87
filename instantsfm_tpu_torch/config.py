"""Option groups of the solver stages.

Counterpart of the option dicts in ``instantsfm_tpu/config.py`` that this
port's stages read; same keys and defaults.
"""

from __future__ import annotations

INLIER_THRESHOLD_OPTIONS = {
    "max_angle_error": 1.0,
    "max_reprojection_error": 1e-2,
    "min_triangulation_angle": 1.0,
    "max_epipolar_error_E": 1.0,
    "max_epipolar_error_F": 4.0,
    "max_epipolar_error_H": 4.0,
    "min_inlier_num": 30,
    "min_inlier_ratio": 0.25,
    "max_rotation_error": 10.0,
}

GLOBAL_POSITIONER_OPTIONS = {
    "min_num_view_per_track": 3,
    "thres_loss_function": 1e-1,
    "max_num_iterations": 100,
    "function_tolerance": 5e-4,
}

BUNDLE_ADJUSTER_OPTIONS = {
    "optimize_poses": True,
    "optimize_points": True,
    "min_num_view_per_track": 2,
    "thres_loss_function": 1.0,
    "max_num_iterations": 200,
    "function_tolerance": 5e-4,
    # terminate on parameter stagnation (relative step < step_tolerance for
    # a window of iterations) instead of the cost window; None restores the
    # cost-window test
    "step_tolerance": 1e-6,
}
