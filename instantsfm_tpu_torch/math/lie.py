"""Quaternion / SO(3) / SE(3) operations on torch tensors.

Counterpart of ``instantsfm_tpu/math/lie.py``.  Shapes are ``(..., k)`` and
every function is dtype- and device-polymorphic; none mutates its inputs, so
all of them run under ``torch.func.vmap``/``jacfwd``.

Quaternion convention: ``(x, y, z, w)`` (scalar-last), as scipy's
``Rotation.as_quat``.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-12


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp_min(_EPS)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_mul(q1, q2):
    """Hamilton product, scalar-last convention."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_rotate(q, v):
    """Rotate ``v`` (..., 3) by ``q`` (..., 4): v + 2 w (u x v) + 2 u x (u x v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_rotate_inv(q, v):
    return quat_rotate(quat_conj(q), v)


def quat_to_matrix(q):
    """(..., 4) -> (..., 3, 3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m):
    """(..., 3, 3) -> (..., 4) scalar-last; branch-free (Shepperd via max trace)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    tw = 1.0 + m00 + m11 + m22
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    sw = torch.sqrt(tw.clamp_min(_EPS)) * 2.0
    qw = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw,
                      sw / 4.0], -1)
    sx = torch.sqrt(tx.clamp_min(_EPS)) * 2.0
    qx = torch.stack([sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx,
                      (m21 - m12) / sx], -1)
    sy = torch.sqrt(ty.clamp_min(_EPS)) * 2.0
    qy = torch.stack([(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy,
                      (m02 - m20) / sy], -1)
    sz = torch.sqrt(tz.clamp_min(_EPS)) * 2.0
    qz = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0,
                      (m10 - m01) / sz], -1)

    t = torch.stack([tx, ty, tz, tw], -1)
    best = torch.argmax(t, dim=-1)
    cand = torch.stack([qx, qy, qz, qw], -2)            # (..., 4 cand, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.take_along_dim(cand, idx, dim=-2)[..., 0, :]
    return quat_normalize(q)


def so3_exp(w):
    """Axis-angle (..., 3) -> quaternion (..., 4); Taylor-safe near zero."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq.clamp_min(_EPS))
    half = 0.5 * theta
    small = theta_sq < 1e-8
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([w * k, cw], dim=-1)


def so3_log(q):
    """Quaternion (..., 4) -> axis-angle (..., 3); Taylor-safe near identity."""
    q = torch.where(q[..., 3:4] < 0, -q, q)             # shortest arc
    u = q[..., :3]
    w = q[..., 3]
    n_sq = torch.sum(u * u, dim=-1)
    n = torch.sqrt(n_sq.clamp_min(_EPS))
    angle = 2.0 * torch.atan2(n, w)
    small = n_sq < 1e-12
    scale = torch.where(small, 2.0 / w.clamp_min(_EPS), angle / n)
    return u * scale[..., None]


def rotvec_to_matrix(w):
    return quat_to_matrix(so3_exp(w))


def matrix_to_rotvec(m):
    return so3_log(matrix_to_quat(m))


def se3_action(q, t, p):
    """Apply world->cam transform: R(q) p + t."""
    return quat_rotate(q, p) + t


def camera_center(q, t):
    """Center c = -R^T t for world->cam (q, t)."""
    return -quat_rotate_inv(q, t)


def rotation_geodesic_angle(q1, q2):
    """Angle in radians between two rotations given as quaternions."""
    d = torch.abs(torch.sum(q1 * q2, dim=-1)).clamp(0.0, 1.0)
    return 2.0 * torch.arccos(d)


def se3_retract(q, t, delta):
    """Left-multiplicative retraction of the LM engine: with
    ``delta = (omega, dt)``, q_new = Exp(omega) q and
    t_new = R(Exp(omega)) t + dt."""
    dq = so3_exp(delta[..., :3])
    q_new = quat_normalize(quat_mul(dq, q))
    t_new = quat_rotate(dq, t) + delta[..., 3:6]
    return q_new, t_new


# ----------------------------------------------------------- numpy twins
# Host-side stages (cheirality culls, scene setup) run these on numpy arrays.

def quat_rotate_np(q, v):
    u = q[..., :3]
    w = q[..., 3:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_rotate_inv_np(q, v):
    qc = np.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)
    return quat_rotate_np(qc, v)


def se3_action_np(q, t, p):
    """numpy twin of ``se3_action``: R(q) p + t."""
    return quat_rotate_np(q, p) + t


def quat_to_matrix_np(q):
    """numpy twin of ``quat_to_matrix``."""
    return quat_to_matrix(torch.as_tensor(np.asarray(q, np.float64))).numpy()
