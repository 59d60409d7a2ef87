"""Dataset path probing + depth loading (counterpart of
``instantsfm_tpu/pipeline/data_reader.py``)."""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np

from instantsfm_tpu_torch.io.image import imread
from instantsfm_tpu_torch.scene.types import Cameras, Images


@dataclass
class PathInfo:
    image_path: str = ""
    database_path: str = ""
    output_path: str = ""
    database_exists: bool = False
    depth_path: str = ""
    record_path: str = ""


def read_data(path: str) -> PathInfo:
    """Probe COLMAP (`images/`) or ScanNet (`color/`,`depth/`) layout."""
    info = PathInfo()
    if os.path.exists(os.path.join(path, "images")):
        info.image_path = os.path.join(path, "images")
    elif os.path.exists(os.path.join(path, "color")):
        info.image_path = os.path.join(path, "color")
    info.database_path = os.path.join(path, "database.db")
    info.output_path = os.path.join(path, "sparse")
    info.database_exists = os.path.exists(info.database_path)
    if os.path.exists(os.path.join(path, "depth")):
        info.depth_path = os.path.join(path, "depth")
    info.record_path = os.path.join(path, "record")
    return info


def sample_depth_at_pixels(depth_map: np.ndarray, xy: np.ndarray,
                           width: int, height: int) -> np.ndarray:
    """Nearest-neighbor depth lookup with scaling from image to depth-map
    resolution, vectorized."""
    dh, dw = depth_map.shape[:2]
    x = np.clip((xy[:, 0] * dw / width).astype(int), 0, dw - 1)
    y = np.clip((xy[:, 1] * dh / height).astype(int), 0, dh - 1)
    return depth_map[y, x]


def read_depths_into_features(depth_path: str, cameras: Cameras,
                              images: Images) -> bool:
    """Load ScanNet-style mm PNG depth maps and sample per keypoint; False
    (no depths) when they are missing or cannot be read (16-bit PNG needs
    imageio, as in the JAX package)."""
    depth_files = sorted(glob.glob(os.path.join(depth_path, "*.png")))
    if len(depth_files) < images.num_images:
        return False
    kp_depth = np.zeros(len(images.kp_xy), np.float32)
    for i in range(images.num_images):
        try:
            depth = np.asarray(imread(depth_files[i])).astype(np.float32) / 1000.0
        except (OSError, ValueError, RuntimeError):
            return False
        sl = slice(images.kp_offset[i], images.kp_offset[i + 1])
        c = images.cam_idx[i]
        kp_depth[sl] = sample_depth_at_pixels(
            depth, images.kp_xy[sl], int(cameras.widths[c]),
            int(cameras.heights[c]))
    images.kp_depth = kp_depth
    return True
