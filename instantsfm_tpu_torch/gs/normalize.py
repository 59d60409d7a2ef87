"""Scene normalization for 3DGS training (reference ``vis/utils/normalize.py``):
similarity transform from camera poses (up-axis + center + scale) and PCA
alignment of the point cloud."""

from __future__ import annotations

import numpy as np


def similarity_from_cameras(c2w: np.ndarray, strict_scaling: bool = False,
                            center_method: str = "focus") -> np.ndarray:
    """c2w: [N, 4, 4] camera-to-world.  Returns a 4x4 similarity T aligning
    average up to +z, centering and scaling the scene (same algorithm family
    as the reference: rotate up, translate focus/poses center, scale by
    camera distance)."""
    t = c2w[:, :3, 3]
    R = c2w[:, :3, :3]

    # world up from camera -y axes
    ups = -R[:, :3, 1]
    up = ups.mean(0)
    up = up / np.linalg.norm(up)
    # rotation taking `up` to +z
    z = np.array([0.0, 0.0, 1.0])
    v = np.cross(up, z)
    s = np.linalg.norm(v)
    c = float(up @ z)
    if s < 1e-8:
        R_align = np.eye(3) if c > 0 else np.diag([1.0, -1.0, -1.0])
    else:
        vx = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        R_align = np.eye(3) + vx + vx @ vx * ((1 - c) / (s * s))

    R_new = np.einsum("ij,njk->nik", R_align, R)
    t_new = np.einsum("ij,nj->ni", R_align, t)

    if center_method == "focus":
        # approximate focus point: closest point to all optical axes
        dirs = R_new[:, :3, 2]
        nearest = t_new + dirs * (-t_new * dirs).sum(-1, keepdims=True)
        translate = -np.median(nearest, axis=0)
    else:
        translate = -np.median(t_new, axis=0)

    T = np.eye(4)
    T[:3, :3] = R_align
    T[:3, 3] = translate

    dists = np.linalg.norm(t_new + translate, axis=-1)
    scale = 1.0 / (np.max(dists) if strict_scaling else np.median(dists))
    T[:3] *= scale
    return T


def align_principle_axes(points: np.ndarray) -> np.ndarray:
    """PCA alignment of a point cloud: rotate principal axes onto xyz,
    centered at the median (reference ``align_principle_axes``)."""
    center = np.median(points, axis=0)
    centered = points - center
    cov = centered.T @ centered / len(points)
    w, v = np.linalg.eigh(cov)
    # sort descending, right-handed
    order = np.argsort(w)[::-1]
    v = v[:, order]
    if np.linalg.det(v) < 0:
        v[:, -1] *= -1
    T = np.eye(4)
    T[:3, :3] = v.T
    T[:3, 3] = -v.T @ center
    return T


def transform_points(T: np.ndarray, points: np.ndarray) -> np.ndarray:
    return points @ T[:3, :3].T + T[:3, 3]


def transform_cameras(T: np.ndarray, c2w: np.ndarray):
    """Apply similarity to camera-to-world matrices; returns (c2w', scale)."""
    out = np.einsum("ij,njk->nik", T, c2w)
    scaling = np.linalg.norm(T[:3, :3], axis=0).mean()
    # re-orthonormalize rotation part
    R = out[:, :3, :3] / np.linalg.norm(out[:, :3, :3], axis=1, keepdims=True)
    out[:, :3, :3] = R
    return out, scaling
