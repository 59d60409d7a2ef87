"""Track retriangulation: completion and a frozen-pose BA refinement loop.

Counterpart of ``instantsfm_tpu/pipeline/retriangulation.py``:
* ``complete_tracks`` reprojects each surviving track's current xyz into
  every observation of its original (unfiltered) track; the observations
  within ``complete_max_reproj_error`` px and in front of the camera
  replace the track's observation set.  The projection of all candidate
  observations is one batch of torch ops on the given device (float64);
  the CSR rebuild (lexsort, bincount) stays on the host, as in JAX;
* ``retriangulate_tracks`` runs at most ``ba_global_max_refinements``
  rounds of {frozen-pose BA, completion, pixel reprojection and
  triangulation-angle filters} and stops once the changed share falls
  below ``ba_global_max_refinement_change``.  The frozen-pose BA's camera
  block is the optimizable intrinsics alone (PC = 2 for SIMPLE_RADIAL), so
  K1 runs there at that width whenever the solve takes the PCG path.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.pipeline import ba as ba_mod
from instantsfm_tpu_torch.pipeline import track_filters
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks
from instantsfm_tpu_torch.utils import debug as _dbg
from instantsfm_tpu_torch.utils.device import resolve_device

_EPS = 1e-7


def complete_tracks(cameras: Cameras, images: Images, tracks: Tracks,
                    tracks_orig: Tracks, opts: dict,
                    device="cuda") -> tuple:
    """Returns (new_tracks, num_changed_observations)."""
    dev = resolve_device(device)
    if tracks.num_tracks == 0 or tracks_orig.num_tracks == 0:
        return tracks, 0
    thres = float(opts["complete_max_reproj_error"])

    # map original tracks to surviving ones by stable id
    id2idx = {tid: i for i, tid in enumerate(tracks.track_id.tolist())}
    keep_orig = np.array([tid in id2idx for tid in tracks_orig.track_id.tolist()],
                         bool)
    orig = tracks_orig.filter_tracks(keep_orig)
    new_idx = np.array([id2idx[tid] for tid in orig.track_id.tolist()],
                       np.int64)

    cand_track = new_idx[orig.obs_track_idx()]           # current track index
    cand_img = orig.obs_image
    cand_feat = orig.obs_feature

    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64),
                                    device=dev)
    pt_cam = lie.se3_action(f64(images.qvec[cand_img]),
                            f64(images.tvec[cand_img]),
                            f64(tracks.xyz[cand_track]))
    proj = cam_models.img_from_cam(
        cameras.uniform_model_id,
        f64(cameras.params[images.cam_idx[cand_img]]), pt_cam)
    feat_xy = f64(images.kp_xy[images.kp_index(cand_img, cand_feat)])
    err = torch.linalg.norm(proj - feat_xy, dim=-1)
    passing = ((err <= thres) & (pt_cam[:, 2] > _EPS)).cpu().numpy() \
        & images.registered[cand_img]

    # rebuild the observation CSR of the surviving tracks from the passing
    # candidates
    ct, ci, cf = cand_track[passing], cand_img[passing], cand_feat[passing]
    order = np.lexsort((ci, ct))
    ct, ci, cf = ct[order], ci[order], cf[order]
    lengths = np.bincount(ct, minlength=tracks.num_tracks)
    offset = np.zeros(tracks.num_tracks + 1, np.int64)
    np.cumsum(lengths, out=offset[1:])
    num_changed = int(np.abs(lengths - tracks.track_lengths()).sum())

    new_tracks = Tracks(xyz=tracks.xyz, color=tracks.color,
                        obs_image=ci.astype(np.int32),
                        obs_feature=cf.astype(np.int32),
                        obs_offset=offset, track_id=tracks.track_id)
    return new_tracks, num_changed


def retriangulate_tracks(cameras: Cameras, images: Images, tracks: Tracks,
                         tracks_orig: Tracks, tri_opts: dict, ba_opts: dict,
                         dtype=torch.float64, log=print,
                         device="cuda") -> Tracks:
    """The refinement loop.  Each round's changed share goes to the run
    counter ``retri_changed_share`` (``utils/debug.py``)."""
    dev = resolve_device(device)
    registered_before = images.registered.copy()

    tracks, n_completed = complete_tracks(cameras, images, tracks,
                                          tracks_orig, tri_opts, device=dev)
    log(f"Number of completed observations: {n_completed}")

    local_ba = dict(ba_opts, optimize_poses=False)
    max_rounds = int(tri_opts["ba_global_max_refinements"])
    for i in range(max_rounds):
        log(f"Running bundle adjustment iteration {i + 1} / {max_rounds}")
        ba_mod.bundle_adjustment(cameras, images, tracks, local_ba,
                                 dtype=dtype, device=dev)
        tracks, n_changed = complete_tracks(cameras, images, tracks,
                                            tracks_orig, tri_opts, device=dev)
        before = tracks.num_tracks
        tracks = track_filters.filter_tracks_by_reprojection(
            cameras, images, tracks, float(tri_opts["filter_max_reproj_error"]))
        tracks = track_filters.filter_tracks_triangulation_angle(
            cameras, images, tracks, float(tri_opts["filter_min_tri_angle"]))
        n_changed += before - tracks.num_tracks
        if tracks.num_tracks == 0:
            break
        share = n_changed / tracks.num_tracks
        _dbg.stat_add("retri_changed_share", share)
        if share < float(tri_opts["ba_global_max_refinement_change"]):
            break

    images.registered = registered_before
    return tracks
