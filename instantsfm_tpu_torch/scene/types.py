"""Flat structure-of-arrays scene model (host side, numpy).

Counterpart of ``instantsfm_tpu/scene/types.py`` (``Cameras``, ``Images``,
``Tracks``).  Ragged collections (keypoints per image, observations per
track) are stored flat with CSR offsets; ids are dense 0..N-1.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from instantsfm_tpu_torch.math import lie


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

    @property
    def uniform_model_id(self) -> int:
        """Scene-wide camera model (the solvers assume a single model)."""
        mid = int(self.model_ids[0])
        if not np.all(self.model_ids == mid):
            raise ValueError("mixed camera models in one scene are not supported")
        return mid


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

    @property
    def num_images(self) -> int:
        return len(self.cam_idx)

    def kp_index(self, image_idx, feature_idx):
        """Flat index into kp_xy for (image, feature) pairs (vectorized)."""
        return self.kp_offset[image_idx] + feature_idx

    def centers(self) -> np.ndarray:
        """Camera centers -R^T t for all images, [N, 3]."""
        return -lie.quat_rotate_inv_np(self.qvec, self.tvec)


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
