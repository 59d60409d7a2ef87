"""Global mapper: runs the SfM stages in order.

Counterpart of ``instantsfm_tpu/pipeline/mapper.py``, with the same stage
sequence and cadence:
preprocess -> view-graph calibration -> relative pose + inlier filters + LCC
-> 2x (rotation averaging + rotation filter + LCC) -> track establishment ->
global positioning + angle filter + normalize ->
3x (BA + reprojection filter with eps*max(1, 3-iter)) ->
final filters + normalize -> [retriangulation + BA + filters] -> [pruning].

Retriangulation and pruning are off by default, as in JAX
(``skip_retriangulation`` / ``skip_pruning``).
"""

from __future__ import annotations

import contextlib
import time

import torch

from instantsfm_tpu_torch.config import Config
from instantsfm_tpu_torch.pipeline import (ba, filters, positioning,
                                           preprocess, pruning, relpose,
                                           retriangulation,
                                           rotation_averaging, track_filters,
                                           tracks as tracks_mod, vgc)
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks, ViewGraph
from instantsfm_tpu_torch.utils import debug
from instantsfm_tpu_torch.utils.device import resolve_device


class PipelineError(RuntimeError):
    pass


@contextlib.contextmanager
def _stage(name: str, key: str, timings: dict, log, dev):
    """Log the stage, run it inside the span ``stage:<name>``
    (``utils/debug.span``) and record its host seconds (after the device has
    finished)."""
    log("-------------------------------------")
    log(f"Running {name} ...")
    log("-------------------------------------")
    t0 = time.perf_counter()
    with debug.span(f"stage:{name}"):
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    timings[key] = time.perf_counter() - t0


@debug.traced("mapper")
def solve_global_mapper(view_graph: ViewGraph, cameras: Cameras,
                        images: Images, config: Config,
                        depths_available: bool = False, visualizer=None,
                        dtype=torch.float64, log=print, stage_hook=None,
                        device="cuda", ransac_uniforms=None):
    """Run the full global-SfM stage sequence; returns (cameras, images,
    tracks, timings) with ``timings`` in host seconds per stage.

    The whole run is the span ``mapper`` and each stage the span
    ``stage:<name>`` inside it (``utils/debug.span``), which a caller's
    ``torch.profiler.profile`` shows as ``record_function`` scopes.
    ``stage_hook(name, cameras, images, tracks)``, if given, is called after
    each completed stage.  ``ransac_uniforms`` replaces the relative-pose
    RANSAC draws (``relpose.estimate_relative_pose``'s ``uniforms``)."""
    dev = resolve_device(device)
    opts = config.OPTIONS
    inl_opts = config.INLIER_THRESHOLD_OPTIONS
    tracks = tracks_orig = Tracks.empty()
    timings = {}
    stage = lambda name, key: _stage(name, key, timings, log, dev)

    def _viz(name):
        if visualizer is not None:
            visualizer.add_step(cameras, images, tracks, name)

    def _hook(name):
        if stage_hook is not None:
            stage_hook(name, cameras, images, tracks)

    if not opts["skip_preprocessing"]:
        with stage("preprocessing", "preprocessing"):
            preprocess.update_image_pairs_config(view_graph, cameras, images)
            n_pure = preprocess.decompose_relpose(view_graph, cameras, images)
            log(f"Decompose relative pose done. {n_pure} pairs are pure "
                "rotation.")

    if not opts["skip_view_graph_calibration"]:
        with stage("view graph calibration", "view_graph_calibration"):
            vgc.solve_view_graph_calibration(
                view_graph, cameras, images,
                config.VIEW_GRAPH_CALIBRATOR_OPTIONS, dtype=dtype, device=dev)

    if not opts["skip_relative_pose_estimation"]:
        with stage("relative pose estimation", "relative_pose_estimation"):
            relpose.undistort_images(cameras, images, device=dev)
            relpose.estimate_relative_pose(view_graph, cameras, images,
                                           dtype=dtype, device=dev,
                                           uniforms=ransac_uniforms)
            n1 = filters.filter_inlier_num(view_graph,
                                           inl_opts["min_inlier_num"])
            n2 = filters.filter_inlier_ratio(view_graph,
                                             inl_opts["min_inlier_ratio"])
            log(f"Filtered {n1} pairs by inlier count, {n2} by inlier ratio")
            if not view_graph.keep_largest_connected_component(images):
                raise PipelineError("no connected component after relpose "
                                    "filtering")
        _hook("relpose")

    if not opts["skip_rotation_averaging"]:
        with stage("rotation averaging", "rotation_averaging"):
            for _ in range(2):
                if not rotation_averaging.estimate_rotations(
                        view_graph, images, config.ROTATION_ESTIMATOR_OPTIONS,
                        config.L1_SOLVER_OPTIONS, dtype=dtype, device=dev):
                    raise PipelineError("rotation averaging failed")
                filters.filter_rotations(view_graph, images,
                                         inl_opts["max_rotation_error"])
                if not view_graph.keep_largest_connected_component(images):
                    raise PipelineError("failed to keep largest connected "
                                        "component")
            log(f"{int(images.registered.sum())} / {images.num_images} images "
                "are within the connected component.")
        _hook("rotation_averaging")

    if not opts["skip_track_establishment"]:
        with stage("track establishment", "track_establishment"):
            tracks, tracks_orig = tracks_mod.establish_tracks(
                view_graph, images, config.TRACK_ESTABLISHMENT_OPTIONS,
                return_full=True, device=dev)
            log(f"Established {tracks.num_tracks} tracks "
                f"({tracks.num_observations} observations; "
                f"{tracks_orig.num_tracks} before filtering)")

    if not opts["skip_global_positioning"]:
        with stage("global positioning", "global_positioning"):
            relpose.undistort_images(cameras, images, device=dev)
            tracks = positioning.global_positioning(
                cameras, images, tracks, config.GLOBAL_POSITIONER_OPTIONS,
                depths_available=depths_available, dtype=dtype,
                view_graph=view_graph, device=dev)
            _viz("global_positioning")
            tracks = track_filters.filter_tracks_by_angle(
                cameras, images, tracks, inl_opts["max_angle_error"])
            track_filters.normalize_reconstruction(
                images, tracks, depths=depths_available or None)
        _hook("global_positioning")

    if not opts["skip_bundle_adjustment"]:
        with stage("bundle adjustment", "bundle_adjustment"):
            n_rounds = opts["num_iteration_bundle_adjustment"]
            if visualizer is None:
                # device-resident rounds: observations ship once, the
                # inter-round filters run as device-side valid-mask updates
                tracks = ba.bundle_adjustment_rounds(
                    cameras, images, tracks, config.BUNDLE_ADJUSTER_OPTIONS,
                    inl_opts["max_reprojection_error"], rounds=n_rounds,
                    dtype=dtype, device=dev)
            else:
                # per-round loop (per-round snapshots for the live view)
                for it in range(n_rounds):
                    ba.bundle_adjustment(cameras, images, tracks,
                                         config.BUNDLE_ADJUSTER_OPTIONS,
                                         dtype=dtype, device=dev)
                    relpose.undistort_images(cameras, images, device=dev)
                    tracks = track_filters.filter_tracks_by_reprojection_normalized(
                        cameras, images, tracks,
                        inl_opts["max_reprojection_error"] * max(1, 3 - it))
                    _viz("bundle_adjustment")
            log(f"{int(images.registered.sum())} images are registered after "
                "BA.")

            relpose.undistort_images(cameras, images, device=dev)
            tracks = track_filters.filter_tracks_by_reprojection_normalized(
                cameras, images, tracks, inl_opts["max_reprojection_error"])
            tracks = track_filters.filter_tracks_triangulation_angle(
                cameras, images, tracks, inl_opts["min_triangulation_angle"])
            track_filters.normalize_reconstruction(
                images, tracks, depths=depths_available or None)
        _hook("bundle_adjustment")

    if not opts["skip_retriangulation"]:
        with stage("retriangulation", "retriangulation"):
            tracks = retriangulation.retriangulate_tracks(
                cameras, images, tracks, tracks_orig,
                config.TRIANGULATOR_OPTIONS, config.BUNDLE_ADJUSTER_OPTIONS,
                dtype=dtype, log=log, device=dev)
            ba.bundle_adjustment(cameras, images, tracks,
                                 config.BUNDLE_ADJUSTER_OPTIONS, dtype=dtype,
                                 device=dev)
            relpose.undistort_images(cameras, images, device=dev)
            tracks = track_filters.filter_tracks_by_reprojection_normalized(
                cameras, images, tracks, inl_opts["max_reprojection_error"])
            tracks = track_filters.filter_tracks_triangulation_angle(
                cameras, images, tracks, inl_opts["min_triangulation_angle"])
        _hook("retriangulation")

    if not opts["skip_pruning"]:
        with stage("pruning", "pruning"):
            pruning.prune_weakly_connected_images(images, tracks, log=log)
        _hook("pruning")

    for name, dt in timings.items():
        log(f"{name} took: {dt:.2f}s")
    return cameras, images, tracks, timings
