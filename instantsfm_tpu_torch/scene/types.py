"""Flat structure-of-arrays scene model (host side, numpy).

Counterpart of ``instantsfm_tpu/scene/types.py`` (``Cameras``, ``Images``,
``ViewGraph``, ``Tracks``).  Ragged collections (keypoints per image, matches
per pair, observations per track) are stored flat with CSR offsets; ids are
dense 0..N-1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.scene import cameras as cam_models

# Configuration types for two-view geometry (COLMAP convention).
CONFIG_UNDEFINED = 0
CONFIG_DEGENERATE = 1
CONFIG_CALIBRATED = 2
CONFIG_UNCALIBRATED = 3
CONFIG_PLANAR = 4
CONFIG_PANORAMIC = 5
CONFIG_PLANAR_OR_PANORAMIC = 6
CONFIG_WATERMARK = 7
CONFIG_MULTIPLE = 8

_PAIR_BASE = 2**31 - 1  # COLMAP pair-id packing


def ids_to_pair_id(id1, id2):
    id1, id2 = np.minimum(id1, id2), np.maximum(id1, id2)
    return id1.astype(np.int64) * _PAIR_BASE + id2 if isinstance(id1, np.ndarray) \
        else int(id1) * _PAIR_BASE + int(id2)


def pair_id_to_ids(pair_id):
    """COLMAP stores pair_id = id1 * MAX + id2 with id1 < id2."""
    return pair_id // _PAIR_BASE, pair_id % _PAIR_BASE


@dataclass
class Cameras:
    """All cameras in the scene; params padded to MAX_CAM_PARAMS."""
    model_ids: np.ndarray          # [C] int32
    widths: np.ndarray             # [C] int64
    heights: np.ndarray            # [C] int64
    params: np.ndarray             # [C, MAX_CAM_PARAMS] float64 (COLMAP order)
    has_prior_focal: np.ndarray    # [C] bool
    has_refined_focal: np.ndarray  # [C] bool

    @property
    def num_cameras(self) -> int:
        return len(self.model_ids)

    def num_params(self, cam_idx: int) -> int:
        return cam_models.get_camera_model_info(int(self.model_ids[cam_idx]))["num_params"]

    def active_params(self, cam_idx: int) -> np.ndarray:
        return self.params[cam_idx, : self.num_params(cam_idx)]

    def focal(self, cam_idx: int) -> float:
        info = cam_models.get_camera_model_info(int(self.model_ids[cam_idx]))
        return float(np.mean(self.params[cam_idx, info["focal"]]))

    def set_focal(self, cam_idx: int, f: float) -> None:
        info = cam_models.get_camera_model_info(int(self.model_ids[cam_idx]))
        self.params[cam_idx, info["focal"]] = f

    def principal_point(self, cam_idx: int) -> np.ndarray:
        info = cam_models.get_camera_model_info(int(self.model_ids[cam_idx]))
        return self.params[cam_idx, info["pp"]]

    @property
    def uniform_model_id(self) -> int:
        """Scene-wide camera model (the solvers assume a single model)."""
        mid = int(self.model_ids[0])
        if not np.all(self.model_ids == mid):
            raise ValueError("mixed camera models in one scene are not supported")
        return mid

    @staticmethod
    def empty() -> "Cameras":
        z = np.zeros(0)
        return Cameras(z.astype(np.int32), z.astype(np.int64), z.astype(np.int64),
                       np.zeros((0, cam_models.MAX_CAM_PARAMS)),
                       z.astype(bool), z.astype(bool))


@dataclass
class Images:
    """All images; keypoints stored flat with CSR offsets."""
    cam_idx: np.ndarray      # [N] int32
    names: list              # [N] str
    qvec: np.ndarray         # [N, 4] float64, world->cam rotation, xyzw
    tvec: np.ndarray         # [N, 3] float64, world->cam translation
    registered: np.ndarray   # [N] bool
    cluster_id: np.ndarray   # [N] int32
    kp_xy: np.ndarray        # [K_total, 2] float64 pixel coords
    kp_offset: np.ndarray    # [N+1] int64
    kp_depth: Optional[np.ndarray] = None    # [K_total] float32 metric depth (0 = none)
    kp_bearing: Optional[np.ndarray] = None  # [K_total, 3] unit bearings (undistorted)

    @property
    def num_images(self) -> int:
        return len(self.cam_idx)

    def keypoints(self, image_idx: int) -> np.ndarray:
        return self.kp_xy[self.kp_offset[image_idx]: self.kp_offset[image_idx + 1]]

    def num_keypoints(self, image_idx: int) -> int:
        return int(self.kp_offset[image_idx + 1] - self.kp_offset[image_idx])

    def kp_index(self, image_idx, feature_idx):
        """Flat index into kp_xy for (image, feature) pairs (vectorized)."""
        return self.kp_offset[image_idx] + feature_idx

    def world2cam(self, image_idx: int) -> np.ndarray:
        m = np.eye(4)
        m[:3, :3] = lie.quat_to_matrix_np(self.qvec[image_idx])
        m[:3, 3] = self.tvec[image_idx]
        return m

    def centers(self) -> np.ndarray:
        """Camera centers -R^T t for all images, [N, 3]."""
        return -lie.quat_rotate_inv_np(self.qvec, self.tvec)


def _components(n, vi, vj):
    """(number of components, label per node) of the undirected graph."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components

    adj = sp.coo_matrix((np.ones(len(vi)), (vi, vj)), shape=(n, n))
    return connected_components(adj, directed=False)


@dataclass
class ViewGraph:
    """Image pairs + matches, flat CSR layout; connectivity queries use
    scipy.sparse.csgraph."""
    pair_i: np.ndarray        # [E] int32 (i < j)
    pair_j: np.ndarray        # [E] int32
    valid: np.ndarray         # [E] bool
    config: np.ndarray        # [E] int8
    E_mat: np.ndarray         # [E, 3, 3] float64
    F_mat: np.ndarray         # [E, 3, 3] float64
    H_mat: np.ndarray         # [E, 3, 3] float64
    qvec: np.ndarray          # [E, 4] relative rotation cam1->cam2, xyzw
    tvec: np.ndarray          # [E, 3] relative translation cam1->cam2
    matches: np.ndarray       # [M_total, 2] int32 (feat_idx1, feat_idx2)
    match_offset: np.ndarray  # [E+1] int64
    inlier_mask: np.ndarray   # [M_total] bool

    @property
    def num_pairs(self) -> int:
        return len(self.pair_i)

    def pair_matches(self, e: int) -> np.ndarray:
        return self.matches[self.match_offset[e]: self.match_offset[e + 1]]

    def num_matches_per_pair(self) -> np.ndarray:
        return np.diff(self.match_offset)

    def num_inliers_per_pair(self) -> np.ndarray:
        counts = np.diff(self.match_offset)
        pair_of_match = np.repeat(np.arange(self.num_pairs), counts)
        return np.bincount(pair_of_match, weights=self.inlier_mask.astype(np.float64),
                           minlength=self.num_pairs).astype(np.int64)

    def match_pair_idx(self) -> np.ndarray:
        """[M_total] pair index for each match row."""
        return np.repeat(np.arange(self.num_pairs, dtype=np.int32),
                         np.diff(self.match_offset))

    def keep_largest_connected_component(self, images: Images) -> bool:
        """Mark images outside the largest valid-pair component unregistered
        and invalidate pairs touching them."""
        n = images.num_images
        vi, vj = self.pair_i[self.valid], self.pair_j[self.valid]
        if len(vi) == 0:
            return False
        ncomp, labels = _components(n, vi, vj)
        # only images that appear in some valid pair belong to any component
        in_graph = np.zeros(n, dtype=bool)
        in_graph[vi] = True
        in_graph[vj] = True
        counts = np.bincount(labels[in_graph], minlength=ncomp)
        if counts.size == 0 or counts.max() == 0:
            return False
        best = int(np.argmax(counts))
        images.registered = in_graph & (labels == best)
        self.valid &= images.registered[self.pair_i] & images.registered[self.pair_j]
        return True

    def mark_connected_components(self, images: Images) -> int:
        """Assign cluster ids by component size rank."""
        n = images.num_images
        vi, vj = self.pair_i[self.valid], self.pair_j[self.valid]
        images.cluster_id = np.full(n, -1, dtype=np.int32)
        if len(vi) == 0:
            return 0
        ncomp, labels = _components(n, vi, vj)
        in_graph = np.zeros(n, dtype=bool)
        in_graph[vi] = True
        in_graph[vj] = True
        counts = np.bincount(labels[in_graph], minlength=ncomp)
        order = np.argsort(-counts)
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        images.cluster_id[in_graph] = rank[labels[in_graph]].astype(np.int32)
        return int((counts > 0).sum())


@dataclass
class Tracks:
    """3D tracks with flat observation arrays sorted by track (CSR):
    observations of track t are ``obs_*[obs_offset[t]:obs_offset[t+1]]``."""
    xyz: np.ndarray          # [T, 3] float64
    color: np.ndarray        # [T, 3] uint8
    obs_image: np.ndarray    # [O] int32
    obs_feature: np.ndarray  # [O] int32
    obs_offset: np.ndarray   # [T+1] int64
    track_id: np.ndarray     # [T] int64 external ids (stable across filtering)

    @property
    def num_tracks(self) -> int:
        return len(self.xyz)

    @property
    def num_observations(self) -> int:
        return len(self.obs_image)

    def track_lengths(self) -> np.ndarray:
        return np.diff(self.obs_offset)

    def obs_track_idx(self) -> np.ndarray:
        """[O] int32 track index for each observation."""
        return np.repeat(np.arange(self.num_tracks, dtype=np.int32),
                         self.track_lengths())

    def filter_observations(self, keep_obs_mask: np.ndarray) -> "Tracks":
        """Drop observations by mask and rebuild offsets (tracks kept even if empty)."""
        new_lengths = np.bincount(self.obs_track_idx()[keep_obs_mask],
                                  minlength=self.num_tracks).astype(np.int64)
        offset = np.zeros(self.num_tracks + 1, dtype=np.int64)
        np.cumsum(new_lengths, out=offset[1:])
        return Tracks(self.xyz, self.color,
                      self.obs_image[keep_obs_mask], self.obs_feature[keep_obs_mask],
                      offset, self.track_id)

    def filter_tracks(self, keep_track_mask: np.ndarray) -> "Tracks":
        """Drop whole tracks (and their observations)."""
        keep_obs = np.repeat(keep_track_mask, self.track_lengths())
        lengths = self.track_lengths()[keep_track_mask]
        offset = np.zeros(len(lengths) + 1, dtype=np.int64)
        np.cumsum(lengths, out=offset[1:])
        return Tracks(self.xyz[keep_track_mask], self.color[keep_track_mask],
                      self.obs_image[keep_obs], self.obs_feature[keep_obs],
                      offset, self.track_id[keep_track_mask])

    @staticmethod
    def empty() -> "Tracks":
        return Tracks(np.zeros((0, 3)), np.zeros((0, 3), np.uint8),
                      np.zeros(0, np.int32), np.zeros(0, np.int32),
                      np.zeros(1, np.int64), np.zeros(0, np.int64))
