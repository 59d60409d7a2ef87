"""Bundle adjustment stage on torch tensors.

Counterpart of ``instantsfm_tpu/pipeline/ba.py``: pack the scene into flat
blocks and solve with ``parallel.sharded.optimize_auto`` (bucketed tracks,
on one device or point-local over every rank of a process group); per-image
camera blocks = [pose (6-dof tangent) ++ optimizable intrinsics], principal
point frozen, Huber loss.  On one device ``bundle_adjustment_rounds`` ships
the observations to the device once and runs the inter-round filters
(cheirality, track length, normalized reprojection with a per-round
threshold) as valid-mask updates on the device; over several ranks it runs
JAX's per-round loop: ``bundle_adjustment``, undistortion and the
normalized reprojection filter on the host.  Spans: ``ba.prepare`` (the
observations gathered and shipped), ``ba.optimize`` (one solve),
``ba.bucketize``, ``ba.round`` and ``ba.readback``; host reads
``ba.cameras`` and ``ba.points`` (with the rounds' valid mask).
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.parallel.sharded import optimize_auto, shard_world
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks
from instantsfm_tpu_torch.solve import robust
from instantsfm_tpu_torch.solve.block_lm import (LMConfig, Observations,
                                                 Params, optimize)
from instantsfm_tpu_torch.solve.blocked import (bucketize_problem, gather_pt,
                                                seg_by_pt)
from instantsfm_tpu_torch.solve.problems import make_ba_problem
from instantsfm_tpu_torch.utils import debug as _dbg
from instantsfm_tpu_torch.utils.device import resolve_device


def _pack(cameras: Cameras, images: Images, u_img, pts, cam_idx, pt_idx, xy,
          dtype, device):
    O = len(cam_idx)

    def t(a, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dt)

    params = Params(
        cam={"q": t(images.qvec[u_img]), "t": t(images.tvec[u_img]),
             "intr": t(cameras.params[images.cam_idx[u_img]])},
        pts=t(pts),
        scales=torch.zeros((O, 1), dtype=dtype, device=device),
        scales_free=torch.zeros(O, dtype=torch.bool, device=device))
    obs = Observations(
        cam_idx=t(cam_idx, torch.int32), pt_idx=t(pt_idx, torch.int32),
        data={"x": t(xy[:, 0]), "y": t(xy[:, 1])},
        valid=torch.ones(O, dtype=torch.bool, device=device))
    return params, obs


def _lm_config(opts: dict) -> LMConfig:
    return LMConfig(max_iterations=int(opts["max_num_iterations"]),
                    function_tolerance=float(opts["function_tolerance"]),
                    step_tol=opts.get("step_tolerance"),
                    radius_init=1e4, radius_max=1e10)


def _write_back(cameras, images, u_img, cam):
    q, t, intr = _dbg.read("ba.cameras", (cam["q"], cam["t"], cam["intr"]))
    images.qvec[u_img] = q.astype(np.float64)
    images.tvec[u_img] = t.astype(np.float64)
    intr = intr.astype(np.float64)
    cam_of_img = images.cam_idx[u_img]
    for c in np.unique(cam_of_img):
        cameras.params[c] = intr[cam_of_img == c].mean(axis=0)


def bundle_adjustment(cameras: Cameras, images: Images, tracks: Tracks,
                      opts: dict, dtype=torch.float64, device="cuda",
                      verbose: bool = False) -> None:
    """One BA solve over the registered images (updates the scene in place)."""
    dev = resolve_device(device)
    model_id = cameras.uniform_model_id
    optimize_poses = bool(opts.get("optimize_poses", True))

    with _dbg.span("ba.prepare"):
        track_ok = tracks.track_lengths() \
            >= int(opts["min_num_view_per_track"])
        obs_ok = track_ok[tracks.obs_track_idx()] \
            & images.registered[tracks.obs_image]
        oi = tracks.obs_image[obs_ok]
        of = tracks.obs_feature[obs_ok]
        ot = tracks.obs_track_idx()[obs_ok]

        # cheirality cull z > 0.1 on the host
        pt_cam = lie.se3_action_np(images.qvec[oi], images.tvec[oi],
                                   tracks.xyz[ot])
        front = pt_cam[:, 2] > 0.1
        oi, of, ot = oi[front], of[front], ot[front]
        if len(oi) == 0:
            return

        u_img, cam_idx = np.unique(oi, return_inverse=True)
        u_trk, pt_idx = np.unique(ot, return_inverse=True)
        xy = images.kp_xy[images.kp_index(oi, of)]
        params, obs = _pack(cameras, images, u_img, tracks.xyz[u_trk],
                            cam_idx, pt_idx, xy, dtype, dev)

    problem = make_ba_problem(model_id, optimize_poses=optimize_poses)
    kernel = robust.huber(float(opts["thres_loss_function"]))
    with _dbg.span("ba.optimize"):
        cam, pts, history = optimize_auto(
            problem, kernel, _lm_config(opts), params, obs, verbose=verbose,
            device=dev)
    _dbg.stat_add("ba_lm_iters", len(history))

    with _dbg.span("ba.readback"):
        _write_back(cameras, images, u_img, cam)
        tracks.xyz[u_trk] = _dbg.read("ba.points", pts).astype(np.float64)


def _pre_mask(cam, pts, obs, base_valid, min_view: int, buckets):
    """Round-entry mask: cheirality z > 0.1 + track length >= min_view."""
    xyz = lie.quat_rotate(cam["q"][obs.cam_idx], pts[obs.pt_idx]) \
        + cam["t"][obs.cam_idx]
    valid = base_valid & (xyz[:, 2] > 0.1)
    counts = seg_by_pt(valid.to(pts.dtype)[:, None], buckets, pts.shape[0])
    return valid & (gather_pt(counts, buckets, valid.shape[0])[:, 0] >= min_view)


def _post_mask(model_id, cam, pts, obs, valid, thr):
    """Normalized reprojection filter at the current per-image intrinsics."""
    eps = 1e-12
    xyz = lie.quat_rotate(cam["q"][obs.cam_idx], pts[obs.pt_idx]) \
        + cam["t"][obs.cam_idx]
    xy = torch.stack([obs.data["x"], obs.data["y"]], dim=-1)
    b = cam_models.bearing_from_img(model_id, cam["intr"][obs.cam_idx], xy)
    feat_uv = b[:, :2] / (b[:, 2:] + eps)
    proj_uv = xyz[:, :2] / (xyz[:, 2:] + eps)
    err = torch.linalg.norm(proj_uv - feat_uv, dim=-1)
    return valid & (xyz[:, 2] > eps) & (err < thr)


def bundle_adjustment_rounds(cameras: Cameras, images: Images, tracks: Tracks,
                             opts: dict, max_reproj_error: float,
                             rounds: int = 3, dtype=torch.float64,
                             device="cuda", verbose: bool = False) -> Tracks:
    """Run ``rounds`` BA solves with device-side inter-round filtering;
    round r filters at ``max_reproj_error * max(1, rounds - r)``.

    Updates cameras/images/track points in place and returns the
    reprojection-filtered tracks."""
    dev = resolve_device(device)
    if shard_world() > 1:
        from instantsfm_tpu_torch.pipeline import relpose, track_filters
        for r in range(rounds):
            bundle_adjustment(cameras, images, tracks, opts, dtype=dtype,
                              device=dev, verbose=verbose)
            relpose.undistort_images(cameras, images, device=dev)
            tracks = track_filters.filter_tracks_by_reprojection_normalized(
                cameras, images, tracks, max_reproj_error * max(1, rounds - r))
        return tracks
    model_id = cameras.uniform_model_id
    optimize_poses = bool(opts.get("optimize_poses", True))
    min_view = int(opts["min_num_view_per_track"])

    with _dbg.span("ba.prepare"):
        obs_ok = images.registered[tracks.obs_image]
        oi = tracks.obs_image[obs_ok]
        of = tracks.obs_feature[obs_ok]
        ot = tracks.obs_track_idx()[obs_ok]
        if len(oi) == 0:
            return tracks

        u_img, cam_idx = np.unique(oi, return_inverse=True)
        u_trk, pt_idx = np.unique(ot, return_inverse=True)
        xy = images.kp_xy[images.kp_index(oi, of)]
        O = len(oi)
        params, obs = _pack(cameras, images, u_img, tracks.xyz[u_trk],
                            cam_idx, pt_idx, xy, dtype, dev)

    problem = make_ba_problem(model_id, optimize_poses=optimize_poses)
    cfg = _lm_config(opts)
    kernel = robust.huber(float(opts["thres_loss_function"]))
    with _dbg.span("ba.bucketize"):
        params_b, obs_b, buckets, point_slots, (obs_order, obs_dest) = \
            bucketize_problem(params, obs, return_mapping=True)

    valid = obs_b.valid          # registered + real (non-padded) rows
    for r in range(rounds):
        valid = _pre_mask(params_b.cam, params_b.pts, obs_b, valid,
                          min_view, buckets)
        obs_b = obs_b._replace(valid=valid)
        with _dbg.span("ba.round"):
            state, history = optimize(problem, kernel, cfg, params_b, obs_b,
                                      verbose=verbose, buckets=buckets,
                                      device=dev)
        params_b = state.params
        _dbg.stat_add("ba_lm_iters", len(history))
        thr = max_reproj_error * max(1, rounds - r)
        valid = _post_mask(model_id, params_b.cam, params_b.pts, obs_b,
                           valid, thr)

    with _dbg.span("ba.readback"):
        _write_back(cameras, images, u_img, params_b.cam)
        pts_b, valid_np = _dbg.read("ba.points", (params_b.pts, valid))
        tracks.xyz[u_trk] = pts_b[point_slots].astype(np.float64)

        # bucketed mask -> original observation order -> filtered tracks
        keep_sub = np.empty(O, bool)
        keep_sub[obs_order] = valid_np[obs_dest]
        keep_full = np.zeros(tracks.num_observations, bool)
        keep_full[np.nonzero(obs_ok)[0]] = keep_sub
        return tracks.filter_observations(keep_full)
