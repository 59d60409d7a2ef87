"""Track filtering stages, batched on the host (counterpart of
``instantsfm_tpu/pipeline/track_filters.py``): each filter flattens the
observations into one array pass, and each is the span
``track_filters.<name>`` (``utils/debug``)."""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.scene.types import Cameras, Images, Tracks
from instantsfm_tpu_torch.utils.debug import traced

_EPS = 1e-10


def _obs_cam_points(images: Images, tracks: Tracks):
    """Each observation's point in its camera's frame, [O, 3]."""
    oi = tracks.obs_image
    xyz = tracks.xyz[tracks.obs_track_idx()]
    return lie.se3_action_np(images.qvec[oi], images.tvec[oi], xyz)


def _obs_bearings(images: Images, tracks: Tracks):
    return images.kp_bearing[images.kp_index(tracks.obs_image,
                                             tracks.obs_feature)]


@traced("track_filters.angle")
def filter_tracks_by_angle(cameras: Cameras, images: Images, tracks: Tracks,
                           max_angle_error_deg: float) -> Tracks:
    """Drop observations whose viewing ray deviates from the bearing by more
    than ``max_angle_error`` degrees."""
    if tracks.num_observations == 0:
        return tracks
    thres = np.cos(np.deg2rad(max_angle_error_deg))
    pt_cam = _obs_cam_points(images, tracks)
    norm = np.linalg.norm(pt_cam, axis=-1, keepdims=True)
    cos = np.sum(pt_cam / np.maximum(norm, _EPS) * _obs_bearings(images, tracks),
                 axis=-1)
    keep = (pt_cam[:, 2] >= _EPS) & (cos > thres)
    return tracks.filter_observations(keep)


@traced("track_filters.reprojection_normalized")
def filter_tracks_by_reprojection_normalized(cameras: Cameras, images: Images,
                                             tracks: Tracks,
                                             max_reproj_error: float) -> Tracks:
    """Drop observations with a normalized-plane reprojection error above
    the threshold."""
    if tracks.num_observations == 0:
        return tracks
    pt_cam = _obs_cam_points(images, tracks)
    bearings = _obs_bearings(images, tracks)
    feat_uv = bearings[:, :2] / (bearings[:, 2:] + _EPS)
    proj_uv = pt_cam[:, :2] / (pt_cam[:, 2:] + _EPS)
    err = np.linalg.norm(proj_uv - feat_uv, axis=-1)
    keep = (pt_cam[:, 2] > _EPS) & (err < max_reproj_error)
    return tracks.filter_observations(keep)


@traced("track_filters.reprojection")
def filter_tracks_by_reprojection(cameras: Cameras, images: Images,
                                  tracks: Tracks,
                                  max_reproj_error_px: float) -> Tracks:
    """Pixel-space variant of the reprojection filter."""
    if tracks.num_observations == 0:
        return tracks
    pt_cam = _obs_cam_points(images, tracks)
    params = cameras.params[images.cam_idx[tracks.obs_image]]
    proj = cam_models.img_from_cam(cameras.uniform_model_id,
                                   torch.as_tensor(params),
                                   torch.as_tensor(pt_cam)).numpy()
    feat = images.kp_xy[images.kp_index(tracks.obs_image, tracks.obs_feature)]
    err = np.linalg.norm(proj - feat, axis=-1)
    keep = (pt_cam[:, 2] > _EPS) & (err < max_reproj_error_px)
    return tracks.filter_observations(keep)


@traced("track_filters.triangulation_angle")
def filter_tracks_triangulation_angle(cameras: Cameras, images: Images,
                                      tracks: Tracks,
                                      min_angle_deg: float) -> Tracks:
    """Drop whole tracks whose maximum pairwise triangulation angle is below
    ``min_angle_deg``: a pairwise Gram check per track, bucketed by track
    length so the padded [Tb, L, L] Gram matrices stay small."""
    if tracks.num_tracks == 0:
        return tracks
    thres = np.cos(np.deg2rad(min_angle_deg))
    centers = images.centers()
    vec = tracks.xyz[tracks.obs_track_idx()] - centers[tracks.obs_image]
    vec = vec / np.maximum(np.linalg.norm(vec, axis=-1, keepdims=True), _EPS)

    lengths = tracks.track_lengths()
    tr_idx = tracks.obs_track_idx()
    pos_in_track = np.arange(tracks.num_observations) - np.repeat(
        tracks.obs_offset[:-1], lengths)
    keep = np.ones(tracks.num_tracks, bool)
    lo = 0
    for L in (4, 8, 16, 32, 64, 128, 256, 1 << 30):
        sel_t = np.nonzero((lengths > lo) & (lengths <= L))[0]
        lo = L
        if len(sel_t) == 0:
            continue
        Lc = min(L, int(lengths[sel_t].max()))
        remap = -np.ones(tracks.num_tracks, np.int64)
        remap[sel_t] = np.arange(len(sel_t))
        sel_o = remap[tr_idx] >= 0
        rows = remap[tr_idx[sel_o]]
        cols = pos_in_track[sel_o]
        rays = np.zeros((len(sel_t), Lc, 3))
        rays[rows, cols] = vec[sel_o]
        mask = np.zeros((len(sel_t), Lc), bool)
        mask[rows, cols] = True
        gram = np.einsum("tld,tmd->tlm", rays, rays)
        pair_mask = mask[:, :, None] & mask[:, None, :]
        small = np.where(pair_mask, gram > thres, True)
        keep[sel_t] = ~np.all(small, axis=(1, 2))
    keep |= lengths == 0
    return tracks.filter_tracks(keep)


@traced("track_filters.normalize")
def normalize_reconstruction(images: Images, tracks: Tracks, depths=None,
                             fixed_scale: bool = False, extent: float = 10.0,
                             p0: float = 0.1, p1: float = 0.9) -> None:
    """Percentile-bbox recenter/rescale, or median log-scale alignment to
    metric depth."""
    coords = images.centers()
    n = len(coords)
    coords_sorted = np.sort(coords, axis=0)
    P0 = int(p0 * (n - 1)) if n > 3 else 0
    P1 = int(p1 * (n - 1)) if n > 3 else n - 1
    bbox_min, bbox_max = coords_sorted[P0], coords_sorted[P1]
    mean_coord = np.mean(coords_sorted[P0:P1 + 1], axis=0)

    scale = 1.0
    if depths is not None and images.kp_depth is not None \
            and tracks.num_observations:
        d_gt = images.kp_depth[images.kp_index(tracks.obs_image,
                                               tracks.obs_feature)]
        valid = d_gt > 0
        if valid.any():
            C = coords[tracks.obs_image[valid]]
            P = tracks.xyz[tracks.obs_track_idx()[valid]]
            d_pred = np.linalg.norm(P - C, axis=-1)
            scale = float(np.exp(np.median(np.log(d_gt[valid])
                                           - np.log(np.maximum(d_pred, 1e-12)))))
    elif not fixed_scale:
        old_extent = np.linalg.norm(bbox_max - bbox_min)
        if old_extent >= 1e-6:
            scale = extent / old_extent

    new_centers = (coords - mean_coord) * scale
    images.tvec = -lie.quat_rotate_np(images.qvec, new_centers)
    tracks.xyz = (tracks.xyz - mean_coord) * scale
