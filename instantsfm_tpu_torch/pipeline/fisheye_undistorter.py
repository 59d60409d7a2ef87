"""Offline fisheye image rectification + geo-location export (standalone tool,
reference ``processors/fisheye_undistorter.py``).

Counterpart of ``instantsfm_tpu/pipeline/fisheye_undistorter.py``: the
remap grid comes from the camera-model library (``img_from_plane`` on the
ideal-pinhole ray grid, in torch on ``device``, float64) instead of
``cv2.fisheye.initUndistortRectifyMap``; bilinear sampling in numpy.  Images
are read and written through the port's ``io/image.py`` (PNG needs no
package).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from instantsfm_tpu_torch.io import colmap_model as cmio
from instantsfm_tpu_torch.io.image import imread, imwrite
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.utils.device import resolve_device

_FISHEYE_NAMES = ("OPENCV_FISHEYE", "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE",
                  "THIN_PRISM_FISHEYE")


def extract_colmap_geolocation(colmap_dir: str, output_path: str) -> None:
    """Per-image tvec dump (reference ``extract_colmap_geolocation``)."""
    _, images, _ = cmio.read_model(colmap_dir)
    with open(output_path, "w") as f:
        for im in sorted(images.values(), key=lambda im: im.id):
            t = im.tvec
            f.write(f"{im.name} {t[0]} {t[1]} {t[2]}\n")


def _remap_bilinear(img, src_xy):
    h, w = img.shape[:2]
    x = src_xy[..., 0] - 0.5
    y = src_xy[..., 1] - 0.5
    x0 = np.clip(np.floor(x).astype(int), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(int), 0, h - 2)
    fx = np.clip(x - x0, 0, 1)[..., None]
    fy = np.clip(y - y0, 0, 1)[..., None]
    out = (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
           + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)
    oob = (x < 0) | (x >= w - 1) | (y < 0) | (y >= h - 1)
    out[oob] = 0
    return out.astype(img.dtype)


def remap_grid(model_id, params, width, height, device="cuda") -> np.ndarray:
    """[H, W, 2] fisheye pixel of each undistorted pixel centre: the
    ideal-pinhole ray of (x + 0.5, y + 0.5) through ``img_from_plane``."""
    dev = resolve_device(device)
    info = cam_models.get_camera_model_info(model_id)
    f_idx, pp_idx = info["focal"], info["pp"]
    fx, fy = params[f_idx[0]], params[f_idx[-1]]
    cx, cy = params[pp_idx[0]], params[pp_idx[1]]
    yy, xx = np.meshgrid(np.arange(height) + 0.5, np.arange(width) + 0.5,
                         indexing="ij")
    uv = np.stack([(xx - cx) / fx, (yy - cy) / fy], -1)
    src = cam_models.img_from_plane(
        model_id, torch.as_tensor(params, dtype=torch.float64, device=dev),
        torch.as_tensor(uv.reshape(-1, 2), device=dev))
    return src.cpu().numpy().reshape(height, width, 2)


def undistort_fisheye_images(colmap_dir: str, image_path: str,
                             output_path: str = None, log=print,
                             device="cuda") -> dict:
    dev = resolve_device(device)
    cams, images, _ = cmio.read_model(colmap_dir)
    out = {}
    if output_path:
        os.makedirs(output_path, exist_ok=True)
    for im in sorted(images.values(), key=lambda im: im.id):
        cam = cams[im.camera_id]
        info = cam_models.get_camera_model_info(cam.model_id)
        if info["name"] not in _FISHEYE_NAMES:
            continue
        src = remap_grid(cam.model_id, cam_models.pad_params(cam.params),
                         cam.width, cam.height, dev)
        src_path = os.path.join(image_path, im.name)
        if not os.path.exists(src_path):
            continue
        img = np.asarray(imread(src_path))
        if img.ndim == 2:
            img = img[..., None]
        rect = _remap_bilinear(img, src)
        out[im.id] = rect
        if output_path:
            dst = os.path.join(output_path, im.name)
            os.makedirs(os.path.dirname(dst) or output_path, exist_ok=True)
            imwrite(dst, rect.squeeze())
    if output_path:
        extract_colmap_geolocation(
            colmap_dir, os.path.join(os.path.dirname(output_path),
                                     "geo_locs.txt"))
    log(f"undistorted {len(out)} fisheye images")
    return out
