"""3DGS data layer: COLMAP sparse model -> training views.

Counterpart of ``instantsfm_tpu/gs/data.py`` (reference
``vis/utils/colmap.py`` ``Parser`` + ``Dataset``): loads the sparse model
through the port's COLMAP I/O, reads images with the port's PNG codec
(``io/image.py``), undistorts non-pinhole cameras with the port's camera
models, normalizes the world frame, and serves train/val splits with
optional depth supervision from projected SfM points.  Everything here is
host-side numpy.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from instantsfm_tpu_torch.gs import normalize as norm_mod
from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.io.image import imread
from instantsfm_tpu_torch.scene import cameras as cam_models


def _qvec_wxyz_to_R(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * z * w, 2 * x * z + 2 * y * w],
        [2 * x * y + 2 * z * w, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * x * w],
        [2 * x * z - 2 * y * w, 2 * y * z + 2 * x * w, 1 - 2 * x * x - 2 * y * y]])


@dataclass
class Parser:
    """Loads the sparse model and the image list; normalizes world space."""
    data_dir: str
    factor: int = 1
    normalize: bool = True
    test_every: int = 8
    image_folder_name: str = "images"

    image_names: List[str] = field(default_factory=list)
    image_paths: List[str] = field(default_factory=list)
    camtoworlds: np.ndarray = None        # [N, 4, 4]
    Ks: np.ndarray = None                 # [N, 3, 3]
    params_per_image: np.ndarray = None   # [N, 12] (for undistortion)
    model_id: int = cam_models.PINHOLE
    widths: np.ndarray = None
    heights: np.ndarray = None
    points: np.ndarray = None             # [P, 3]
    points_rgb: np.ndarray = None         # [P, 3] uint8
    point_indices: dict = field(default_factory=dict)  # name -> point rows
    transform: np.ndarray = None
    scene_scale: float = 1.0

    def __post_init__(self):
        sparse = os.path.join(self.data_dir, "sparse", "0")
        if not os.path.exists(sparse):
            sparse = os.path.join(self.data_dir, "sparse")
        cams, imgs, pts = cmio.read_model(sparse)

        img_dir = os.path.join(self.data_dir, self.image_folder_name)
        items = sorted(imgs.values(), key=lambda im: im.name)
        self.image_names = [im.name for im in items]
        self.image_paths = [os.path.join(img_dir, im.name) for im in items]

        w2c, Ks, params_list, widths, heights = [], [], [], [], []
        model_ids = set()
        for im in items:
            M = np.eye(4)
            M[:3, :3] = _qvec_wxyz_to_R(im.qvec_wxyz)
            M[:3, 3] = im.tvec
            w2c.append(M)
            cam = cams[im.camera_id]
            model_ids.add(cam.model_id)
            info = cam_models.get_camera_model_info(cam.model_id)
            params = cam_models.pad_params(cam.params)
            fx = params[info["focal"][0]]
            fy = params[info["focal"][-1]]
            cx, cy = params[info["pp"][0]], params[info["pp"][1]]
            K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]]) / self.factor
            K[2, 2] = 1.0
            Ks.append(K)
            params_list.append(params)
            widths.append(cam.width // self.factor)
            heights.append(cam.height // self.factor)
        self.model_id = model_ids.pop()
        self.camtoworlds = np.linalg.inv(np.stack(w2c))
        self.Ks = np.stack(Ks)
        self.params_per_image = np.stack(params_list)
        self.widths = np.array(widths)
        self.heights = np.array(heights)

        pts_sorted = sorted(pts.values(), key=lambda p: p.id)
        self.points = np.stack([p.xyz for p in pts_sorted]) \
            if pts_sorted else np.zeros((0, 3))
        self.points_rgb = np.stack([p.rgb for p in pts_sorted]) \
            if pts_sorted else np.zeros((0, 3), np.uint8)
        pid2row = {p.id: i for i, p in enumerate(pts_sorted)}
        name_by_id = {im.id: im.name for im in items}
        self.point_indices = {im.name: [] for im in items}
        for p in pts_sorted:
            for iid in p.image_ids:
                if iid in name_by_id:
                    self.point_indices[name_by_id[iid]].append(pid2row[p.id])
        self.point_indices = {k: np.array(v, np.int64)
                              for k, v in self.point_indices.items()}

        if self.normalize:
            T1 = norm_mod.similarity_from_cameras(self.camtoworlds)
            self.camtoworlds, _ = norm_mod.transform_cameras(T1, self.camtoworlds)
            self.points = norm_mod.transform_points(T1, self.points)
            if len(self.points):
                T2 = norm_mod.align_principle_axes(self.points)
                self.camtoworlds, _ = norm_mod.transform_cameras(
                    T2, self.camtoworlds)
                self.points = norm_mod.transform_points(T2, self.points)
                self.transform = T2 @ T1
            else:
                self.transform = T1
        else:
            self.transform = np.eye(4)

        centers = self.camtoworlds[:, :3, 3]
        dists = np.linalg.norm(centers - centers.mean(0), axis=-1)
        self.scene_scale = float(np.max(dists)) * 1.1 if len(dists) else 1.0

    def load_image(self, idx: int) -> np.ndarray:
        """[H, W, 3] float32 in [0, 1], resized by ``factor`` and undistorted
        to an ideal pinhole of the same K."""
        img = imread(self.image_paths[idx])
        if img.ndim == 2:
            img = np.stack([img] * 3, -1)
        img = img[..., :3]
        if self.factor > 1:
            try:
                from PIL import Image
            except ImportError as e:
                raise RuntimeError("data_factor > 1 resizes with PIL, which "
                                   "is not installed") from e
            h, w = img.shape[:2]
            img = np.asarray(Image.fromarray(img).resize(
                (w // self.factor, h // self.factor), Image.BILINEAR))
        if cam_models.get_camera_model_info(self.model_id)["name"] not in (
                "SIMPLE_PINHOLE", "PINHOLE"):
            img = self._undistort(img, idx)
        return img.astype(np.float32) / 255.0

    def _undistort(self, img, idx):
        h, w = img.shape[:2]
        K = self.Ks[idx]
        yy, xx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5,
                             indexing="ij")
        uv = np.stack([(xx - K[0, 2]) / K[0, 0], (yy - K[1, 2]) / K[1, 1]], -1)
        # ideal pinhole ray -> distorted pixel in the source image
        src = cam_models.img_from_plane(
            self.model_id, torch.as_tensor(self.params_per_image[idx] / 1.0),
            torch.as_tensor(uv.reshape(-1, 2))).numpy().reshape(h, w, 2) \
            / self.factor
        x0 = np.clip(np.floor(src[..., 0] - 0.5).astype(int), 0, w - 2)
        y0 = np.clip(np.floor(src[..., 1] - 0.5).astype(int), 0, h - 2)
        fx = np.clip(src[..., 0] - 0.5 - x0, 0, 1)[..., None]
        fy = np.clip(src[..., 1] - 0.5 - y0, 0, 1)[..., None]
        out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
               + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
        return out.astype(img.dtype)

    def depths_for(self, idx: int) -> tuple:
        """Project this image's SfM points -> (pixels [M,2], depths [M])."""
        name = self.image_names[idx]
        rows = self.point_indices.get(name, np.zeros(0, np.int64))
        if len(rows) == 0:
            return np.zeros((0, 2)), np.zeros(0)
        w2c = np.linalg.inv(self.camtoworlds[idx])
        p_cam = self.points[rows] @ w2c[:3, :3].T + w2c[:3, 3]
        z = p_cam[:, 2]
        ok = z > 1e-6
        K = self.Ks[idx]
        uv = p_cam[ok, :2] / z[ok, None]
        pix = uv * np.array([K[0, 0], K[1, 1]]) + np.array([K[0, 2], K[1, 2]])
        return pix, z[ok]


class Dataset:
    """Train/val split by ``idx % test_every`` (reference
    ``vis/utils/colmap.py:301-385``)."""

    def __init__(self, parser: Parser, split: str = "train",
                 load_depths: bool = False):
        self.parser = parser
        self.load_depths = load_depths
        idx = np.arange(len(parser.image_names))
        if parser.test_every > 0:
            if split == "train":
                self.indices = idx[idx % parser.test_every != 0]
            else:
                self.indices = idx[idx % parser.test_every == 0]
        else:
            self.indices = idx

    def __len__(self):
        return len(self.indices)

    def meta(self, i):
        """Item ``i`` without its image: K, camtoworld, image_id and, with
        depths, the SfM points' pixels and depths."""
        idx = int(self.indices[i])
        data = {
            "K": self.parser.Ks[idx],
            "camtoworld": self.parser.camtoworlds[idx],
            "image_id": idx,
        }
        if self.load_depths:
            pix, depths = self.parser.depths_for(idx)
            data["points"] = pix
            data["depths"] = depths
        return data

    def image(self, i):
        """Item ``i``'s image, decoded (``Parser.load_image``)."""
        return self.parser.load_image(int(self.indices[i]))

    def __getitem__(self, i):
        return dict(self.meta(i), image=self.image(i))
