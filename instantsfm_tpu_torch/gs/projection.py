"""3DGS projection: 3D gaussians -> screen-space means and conics (EWA).

Counterpart of ``instantsfm_tpu/gs/projection.py`` with the same camera
models (``pinhole``, ``ortho``, ``fisheye`` equidistant), the same clamped
EWA Jacobian and the same 3-sigma radius.  The JAX code spells every
intermediate as a [G] scalar component for the TPU's lanes; here the
rotation and covariance are plain [G, 3, 3] tensor algebra.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from instantsfm_tpu_torch.math import lie


class Projected(NamedTuple):
    means2d: torch.Tensor   # [G, 2] pixel coords
    conics: torch.Tensor    # [G, 3] upper triangle of the inverse 2D covariance
    depths: torch.Tensor    # [G]
    radii: torch.Tensor     # [G] screen-space extent (pixels), 0 where invalid
    valid: torch.Tensor     # [G] bool: in front and on screen


def quat_scale_to_cov(quats, scales):
    """[G,4] xyzw + [G,3] -> [G,3,3] world covariance R S S Rᵀ."""
    R = lie.quat_to_matrix(lie.quat_normalize(quats))
    M = R * scales[..., None, :]
    return M @ M.transpose(-1, -2)


def _jacobian(camera_model, px, py, z, z_safe, fx, fy, width, height):
    """Rows (j0, j1) of d(pixel)/d(camera point), each [G, 3]."""
    zero = torch.zeros_like(z_safe)
    if camera_model == "pinhole":
        lim_x = 1.3 * (width / (2 * fx))
        lim_y = 1.3 * (height / (2 * fy))
        tx = z_safe * torch.clamp(px / z_safe, -lim_x, lim_x)
        ty = z_safe * torch.clamp(py / z_safe, -lim_y, lim_y)
        j0 = torch.stack([fx / z_safe, zero, -fx * tx / (z_safe * z_safe)], -1)
        j1 = torch.stack([zero, fy / z_safe, -fy * ty / (z_safe * z_safe)], -1)
    elif camera_model == "ortho":
        j0 = torch.stack([zero + fx, zero, zero], -1)
        j1 = torch.stack([zero, zero + fy, zero], -1)
    else:  # fisheye (gsplat's equidistant Jacobian)
        x2, y2, xy = px * px, py * py, px * py
        x2y2 = torch.clamp(x2 + y2, min=1e-12)
        inv_x2y2z2 = 1.0 / (x2y2 + z * z)
        rr = torch.sqrt(x2y2)
        b = torch.atan2(rr, z) / rr            # theta / r
        a = z * inv_x2y2z2                     # d(theta)/d(r)
        j0 = torch.stack([fx * (x2 * a + y2 * b) / x2y2,
                          fx * xy * (a - b) / x2y2,
                          -fx * px * inv_x2y2z2], -1)
        j1 = torch.stack([fy * xy * (a - b) / x2y2,
                          fy * (y2 * a + x2 * b) / x2y2,
                          -fy * py * inv_x2y2z2], -1)
    return j0, j1


def project(means, quats, scales, viewmat, K, width: int, height: int,
            eps2d: float = 0.3, near: float = 0.01, far: float = 1e10,
            camera_model: str = "pinhole") -> Projected:
    """means [G,3] world, quats [G,4] xyzw, scales [G,3] linear; viewmat
    [4,4] world->cam; K [3,3] intrinsics."""
    if camera_model not in ("pinhole", "ortho", "fisheye"):
        raise ValueError(f"unknown camera_model {camera_model!r}")
    Rcw, tcw = viewmat[:3, :3], viewmat[:3, 3]
    pc = means @ Rcw.T + tcw
    px, py, z = pc[:, 0], pc[:, 1], pc[:, 2]

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z_safe = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    if camera_model == "pinhole":
        u = fx * px / z_safe + cx
        v = fy * py / z_safe + cy
    elif camera_model == "ortho":
        u = fx * px + cx
        v = fy * py + cy
    else:
        r2 = px * px + py * py
        r = torch.sqrt(torch.clamp(r2, min=1e-16))
        theta = torch.atan2(r, z)
        s_fe = torch.where(r2 < 1e-12, 1.0 / z_safe, theta / r)
        u = fx * px * s_fe + cx
        v = fy * py * s_fe + cy

    # camera-frame covariance W diag(s^2) Wᵀ with W = Rcw R_g
    W = Rcw @ lie.quat_to_matrix(lie.quat_normalize(quats))
    WS = W * (scales * scales)[:, None, :]
    cov = WS @ W.transpose(-1, -2)                              # [G, 3, 3]

    j0, j1 = _jacobian(camera_model, px, py, z, z_safe, fx, fy, width, height)
    cj0 = (cov @ j0[:, :, None])[:, :, 0]
    cj1 = (cov @ j1[:, :, None])[:, :, 0]
    a = torch.sum(j0 * cj0, -1) + eps2d
    b = torch.sum(j1 * cj0, -1)
    c = torch.sum(j1 * cj1, -1) + eps2d
    det = a * c - b * b
    det_safe = torch.where(det <= 0, torch.ones_like(det), det)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], -1)

    # 3-sigma radius from the larger eigenvalue
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.01))
    radii = torch.ceil(3.0 * torch.sqrt(lam))

    valid = (z > near) & (z < far) & (det > 0)
    valid = valid & (u + radii > 0) & (u - radii < width) \
        & (v + radii > 0) & (v - radii < height)
    return Projected(means2d=torch.stack([u, v], -1), conics=conics,
                     depths=z, radii=torch.where(valid, radii,
                                                 torch.zeros_like(radii)),
                     valid=valid)
