"""Relative-pose filters, vectorized on the host (counterpart of
``instantsfm_tpu/pipeline/filters.py``).  Each reads nothing from the
device and is a span (``utils/debug``) named for the stage it serves:
``relpose.filter_inlier_num``, ``relpose.filter_inlier_ratio`` and
``ra.filter_rotations``."""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene.types import Images, ViewGraph
from instantsfm_tpu_torch.utils.debug import traced


@traced("relpose.filter_inlier_num")
def filter_inlier_num(view_graph: ViewGraph, min_inlier_num: int) -> int:
    """Invalidate pairs with too few RANSAC inliers."""
    inl = view_graph.num_inliers_per_pair()
    bad = view_graph.valid & (inl < min_inlier_num)
    view_graph.valid &= ~bad
    return int(bad.sum())


@traced("relpose.filter_inlier_ratio")
def filter_inlier_ratio(view_graph: ViewGraph, min_inlier_ratio: float) -> int:
    """Invalidate pairs with a low inlier ratio."""
    inl = view_graph.num_inliers_per_pair().astype(np.float64)
    tot = view_graph.num_matches_per_pair().astype(np.float64)
    ratio = np.where(tot > 0, inl / np.maximum(tot, 1), 0.0)
    bad = view_graph.valid & (ratio < min_inlier_ratio)
    view_graph.valid &= ~bad
    return int(bad.sum())


@traced("ra.filter_rotations")
def filter_rotations(view_graph: ViewGraph, images: Images,
                     max_angle_deg: float) -> int:
    """Invalidate pairs whose relative rotation disagrees with the current
    global rotations by more than ``max_angle_deg``:
    angle(R_j R_i^T, R_ij) computed on quaternions."""
    mask = view_graph.valid & images.registered[view_graph.pair_i] \
        & images.registered[view_graph.pair_j]
    if not mask.any():
        return 0
    qi = torch.as_tensor(images.qvec[view_graph.pair_i[mask]])
    qj = torch.as_tensor(images.qvec[view_graph.pair_j[mask]])
    q_global_rel = lie.quat_mul(qj, lie.quat_conj(qi))
    ang = lie.rotation_geodesic_angle(
        q_global_rel, torch.as_tensor(view_graph.qvec[mask])).numpy()
    bad_sub = np.rad2deg(ang) > max_angle_deg
    idx = np.nonzero(mask)[0][bad_sub]
    view_graph.valid[idx] = False
    return int(len(idx))
