"""Spherical-harmonics colour for 3DGS (degrees 0..3) on torch tensors.

Counterpart of ``instantsfm_tpu/gs/sh.py``: the same real SH basis and
constants, the same order of terms.
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)


def rgb_to_sh(rgb):
    return (rgb - 0.5) / C0


def sh_to_rgb(sh):
    return sh * C0 + 0.5


def sh_basis(deg: int, dirs):
    """Real SH basis values [..., (deg+1)^2] for unit directions."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if deg >= 1:
        out += [-C1 * y, C1 * z, -C1 * x]
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        out += [C2[0] * x * y, C2[1] * y * z, C2[2] * (2 * zz - xx - yy),
                C2[3] * x * z, C2[4] * (xx - yy)]
    if deg >= 3:
        xx, yy, zz = x * x, y * y, z * z
        out += [C3[0] * y * (3 * xx - yy), C3[1] * x * y * z,
                C3[2] * y * (4 * zz - xx - yy),
                C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
                C3[4] * x * (4 * zz - xx - yy), C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3 * yy)]
    return torch.stack(out, dim=-1)


def eval_sh(deg: int, sh_coeffs, dirs):
    """sh_coeffs: [..., K, 3] with K >= (deg+1)^2; dirs: [..., 3] unit
    vectors.  Returns [..., 3]."""
    result = C0 * sh_coeffs[..., 0, :]
    if deg < 1:
        return result
    x, y, z = dirs[..., 0:1], dirs[..., 1:2], dirs[..., 2:3]
    result = (result - C1 * y * sh_coeffs[..., 1, :]
              + C1 * z * sh_coeffs[..., 2, :]
              - C1 * x * sh_coeffs[..., 3, :])
    if deg < 2:
        return result
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    result = (result
              + C2[0] * xy * sh_coeffs[..., 4, :]
              + C2[1] * yz * sh_coeffs[..., 5, :]
              + C2[2] * (2 * zz - xx - yy) * sh_coeffs[..., 6, :]
              + C2[3] * xz * sh_coeffs[..., 7, :]
              + C2[4] * (xx - yy) * sh_coeffs[..., 8, :])
    if deg < 3:
        return result
    result = (result
              + C3[0] * y * (3 * xx - yy) * sh_coeffs[..., 9, :]
              + C3[1] * xy * z * sh_coeffs[..., 10, :]
              + C3[2] * y * (4 * zz - xx - yy) * sh_coeffs[..., 11, :]
              + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh_coeffs[..., 12, :]
              + C3[4] * x * (4 * zz - xx - yy) * sh_coeffs[..., 13, :]
              + C3[5] * z * (xx - yy) * sh_coeffs[..., 14, :]
              + C3[6] * x * (xx - 3 * yy) * sh_coeffs[..., 15, :])
    return result
