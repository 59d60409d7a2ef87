"""Camera model library: the 11 COLMAP-compatible models on torch tensors.

Counterpart of ``instantsfm_tpu/scene/cameras.py``: same parameter layouts,
same distortion formulas (including the reference's quirks), the same
fixed-iteration undistortion.  ``model_id`` is a Python int, so each model's
branch is chosen on the host; params are ``(..., P)``, points ``(..., 2|3)``.
Nothing mutates in place, so the functions run under ``torch.func``.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-10

INVALID = -1
SIMPLE_PINHOLE = 0
PINHOLE = 1
SIMPLE_RADIAL = 2
RADIAL = 3
OPENCV = 4
OPENCV_FISHEYE = 5
FULL_OPENCV = 6
FOV = 7
SIMPLE_RADIAL_FISHEYE = 8
RADIAL_FISHEYE = 9
THIN_PRISM_FISHEYE = 10

MAX_CAM_PARAMS = 12

CAMERA_MODEL_INFO = {
    SIMPLE_PINHOLE: dict(name="SIMPLE_PINHOLE", num_params=3, focal=[0], pp=[1, 2],
                         k=[], p=[], omega=[], sx=[], optimize=[0]),
    PINHOLE: dict(name="PINHOLE", num_params=4, focal=[0, 1], pp=[2, 3],
                  k=[], p=[], omega=[], sx=[], optimize=[0, 1]),
    SIMPLE_RADIAL: dict(name="SIMPLE_RADIAL", num_params=4, focal=[0], pp=[1, 2],
                        k=[3], p=[], omega=[], sx=[], optimize=[0, 3]),
    RADIAL: dict(name="RADIAL", num_params=5, focal=[0], pp=[1, 2],
                 k=[3, 4], p=[], omega=[], sx=[], optimize=[0, 3, 4]),
    OPENCV: dict(name="OPENCV", num_params=8, focal=[0, 1], pp=[2, 3],
                 k=[4, 5], p=[6, 7], omega=[], sx=[], optimize=[0, 1, 4, 5, 6, 7]),
    OPENCV_FISHEYE: dict(name="OPENCV_FISHEYE", num_params=8, focal=[0, 1], pp=[2, 3],
                         k=[4, 5, 6, 7], p=[], omega=[], sx=[],
                         optimize=[0, 1, 4, 5, 6, 7]),
    FULL_OPENCV: dict(name="FULL_OPENCV", num_params=12, focal=[0, 1], pp=[2, 3],
                      k=[4, 5, 8, 9, 10, 11], p=[6, 7], omega=[], sx=[],
                      optimize=[0, 1, 4, 5, 6, 7, 8, 9, 10, 11]),
    FOV: dict(name="FOV", num_params=5, focal=[0, 1], pp=[2, 3],
              k=[], p=[], omega=[4], sx=[], optimize=[0, 1, 4]),
    SIMPLE_RADIAL_FISHEYE: dict(name="SIMPLE_RADIAL_FISHEYE", num_params=4, focal=[0],
                                pp=[1, 2], k=[3], p=[], omega=[], sx=[],
                                optimize=[0, 3]),
    RADIAL_FISHEYE: dict(name="RADIAL_FISHEYE", num_params=5, focal=[0], pp=[1, 2],
                         k=[3, 4], p=[], omega=[], sx=[], optimize=[0, 3, 4]),
    THIN_PRISM_FISHEYE: dict(name="THIN_PRISM_FISHEYE", num_params=12, focal=[0, 1],
                             pp=[2, 3], k=[4, 5, 8, 9], p=[6, 7], omega=[],
                             sx=[10, 11], optimize=[0, 1, 4, 5, 6, 7, 8, 9, 10, 11]),
}

MODEL_NAME_TO_ID = {v["name"]: k for k, v in CAMERA_MODEL_INFO.items()}

_FISHEYE_MODELS = (OPENCV_FISHEYE, SIMPLE_RADIAL_FISHEYE, RADIAL_FISHEYE,
                   THIN_PRISM_FISHEYE)


def get_camera_model_info(model_id: int) -> dict:
    return CAMERA_MODEL_INFO[int(model_id)]


def focal_lengths(model_id, params):
    """(..., P) -> (..., 2) (fx, fy)."""
    f_idx = CAMERA_MODEL_INFO[model_id]["focal"]
    if len(f_idx) == 1:
        f = params[..., f_idx[0]]
        return torch.stack([f, f], dim=-1)
    return params[..., f_idx[0]:f_idx[1] + 1]


def principal_point(model_id, params):
    pp_idx = CAMERA_MODEL_INFO[model_id]["pp"]
    return params[..., pp_idx[0]:pp_idx[1] + 1]


def mean_focal(model_id, params):
    return torch.mean(focal_lengths(model_id, params), dim=-1)


def _k(model_id, params, i):
    return params[..., CAMERA_MODEL_INFO[model_id]["k"][i], None]


def _p(model_id, params):
    p_idx = CAMERA_MODEL_INFO[model_id]["p"]
    return params[..., p_idx[0]:p_idx[1] + 1]


def _fisheye_from_normal(uv):
    """Equidistant mapping: scale uv on the z=1 plane by theta/r."""
    r = torch.linalg.norm(uv, dim=-1, keepdim=True).clamp_min(1e-8)
    return uv * torch.atan(r) / r


def _normal_from_fisheye(uv):
    theta = torch.linalg.norm(uv, dim=-1, keepdim=True).clamp_min(1e-8)
    return uv * torch.tan(theta) / theta


def _tangential(p, uv, r2):
    """Tangential terms shared by the OpenCV-style models."""
    uvx = (uv[..., 0] * uv[..., 1])[..., None]
    return 2 * p * uvx + torch.flip(p, dims=(-1,)) * (r2 + 2 * uv ** 2)


def distortion_delta(model_id, params, uv):
    """Additive distortion d(uv) on normalized coords: distorted = uv + d."""
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    if model_id in (SIMPLE_RADIAL, SIMPLE_RADIAL_FISHEYE):
        return uv * _k(model_id, params, 0) * r2
    if model_id in (RADIAL, RADIAL_FISHEYE):
        return uv * (_k(model_id, params, 0) * r2
                     + _k(model_id, params, 1) * r2 ** 2)
    if model_id == OPENCV:
        k1, k2 = _k(model_id, params, 0), _k(model_id, params, 1)
        radial = k1 * r2 + k2 * r2 ** 2
        return uv * radial + _tangential(_p(model_id, params), uv, r2)
    if model_id == OPENCV_FISHEYE:
        k1, k2, k3 = (_k(model_id, params, i) for i in range(3))  # k4 ignored, as in ref
        return uv * (k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3)
    if model_id == FULL_OPENCV:
        k1, k2, k3, k4, k5, k6 = (_k(model_id, params, i) for i in range(6))
        radial = (1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3) / (
            1 + k4 * r2 + k5 * r2 ** 2 + k6 * r2 ** 3) - 1
        return uv * radial + _tangential(_p(model_id, params), uv, r2)
    if model_id == FOV:
        omega = params[..., 4, None]
        omega2 = omega * omega
        small_omega = omega2 < 1e-4
        small_r = r2 < 1e-4
        tan_half = torch.tan(omega / 2)
        factor_small_omega = (omega2 * r2) / 3 - omega2 / 12 + 1
        factor_small_r = (-2 * tan_half * (4 * r2 * tan_half ** 2 - 3)) / (
            3 * omega + _EPS)
        radius = torch.sqrt(r2.clamp_min(_EPS))
        factor_big = torch.atan(radius * 2 * tan_half) / (radius * omega + _EPS)
        factor = torch.where(small_omega, factor_small_omega,
                             torch.where(small_r, factor_small_r, factor_big))
        return uv * factor - uv
    if model_id == THIN_PRISM_FISHEYE:
        k1, k2, k3 = (_k(model_id, params, i) for i in range(3))  # 4th k ignored
        radial = k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        d = uv * radial + _tangential(_p(model_id, params), uv, r2)
        return d + params[..., 10:12] * r2
    return torch.zeros_like(uv)


def distort(model_id, params, uv):
    """Normalized coords (z=1 plane) -> distorted normalized coords
    (equidistant mapping first for the fisheye models)."""
    if model_id in _FISHEYE_MODELS:
        uv = _fisheye_from_normal(uv)
    return uv + distortion_delta(model_id, params, uv)


def undistort(model_id, params, uv_dist, num_iters: int = 20):
    """Distorted normalized coords -> undistorted z=1 plane coords: fixed
    iteration count of the fixed-point compensation (cv2.undistortPoints'
    scheme); analytic inverse for FOV; inverse equidistant map last for the
    fisheye models."""
    if model_id in (SIMPLE_PINHOLE, PINHOLE):
        return uv_dist
    if model_id == FOV:
        omega = params[..., 4, None]
        r2 = torch.sum(uv_dist * uv_dist, dim=-1, keepdim=True)
        omega2 = omega * omega
        small_omega = omega2 < 1e-4
        small_r = r2 < 1e-4
        tan_half = torch.tan(omega / 2)
        factor_small_omega = (omega2 * r2) / 3 - omega2 / 12 + 1
        factor_small_r = (omega * (omega2 * r2 + 3)) / (6 * tan_half + _EPS)
        radius = torch.sqrt(r2.clamp_min(_EPS))
        factor_big = torch.tan(radius * omega) / (radius * 2 * tan_half + _EPS)
        factor = torch.where(small_omega, factor_small_omega,
                             torch.where(small_r, factor_small_r, factor_big))
        return uv_dist * factor

    uv = uv_dist
    for _ in range(num_iters):
        uv = uv_dist - distortion_delta(model_id, params, uv)
    if model_id in _FISHEYE_MODELS:
        uv = _normal_from_fisheye(uv)
    return uv


def img_from_cam(model_id, params, xyz):
    """Camera-frame 3D points (..., 3) -> pixel coords (..., 2)."""
    uv = xyz[..., :2] / (xyz[..., 2:3] + _EPS)
    return img_from_plane(model_id, params, uv)


def img_from_plane(model_id, params, uv):
    """z=1-plane coords -> pixel coords (distortion + K)."""
    uv_d = distort(model_id, params, uv)
    pp = principal_point(model_id, params)
    info = CAMERA_MODEL_INFO[model_id]
    if len(info["focal"]) == 1:
        return uv_d * params[..., info["focal"][0], None] + pp
    return uv_d * focal_lengths(model_id, params) + pp


def cam_from_img(model_id, params, xy, num_iters: int = 20):
    """Pixel coords -> undistorted z=1 plane coords (reference ``img2cam``)."""
    pp = principal_point(model_id, params)
    info = CAMERA_MODEL_INFO[model_id]
    if model_id == SIMPLE_PINHOLE:
        return (xy - pp) / mean_focal(model_id, params)[..., None]
    if model_id == FOV:
        return undistort(model_id, params,
                         (xy - pp) / focal_lengths(model_id, params))
    if len(info["focal"]) == 1:
        uv = (xy - pp) / params[..., info["focal"][0], None]
    else:
        uv = (xy - pp) / focal_lengths(model_id, params)
    return undistort(model_id, params, uv, num_iters=num_iters)


def bearing_from_img(model_id, params, xy, num_iters: int = 20):
    """Pixel coords -> unit bearing vectors in the camera frame (..., 3)."""
    uv = cam_from_img(model_id, params, xy, num_iters=num_iters)
    v = torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def pad_params(params, dtype=None):
    """Pad a 1D param vector to MAX_CAM_PARAMS (numpy)."""
    params = np.asarray(params, dtype=dtype if dtype is not None else np.float64)
    out = np.zeros(MAX_CAM_PARAMS, dtype=params.dtype)
    out[: len(params)] = params
    return out
