"""Render-trajectory generation (reference ``vis/utils/traj.py``):
pose interpolation, ellipse and spiral paths through the training cameras.

Counterpart of ``instantsfm_tpu/gs/traj.py`` (numpy and scipy)."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation, Slerp
from scipy.interpolate import CubicSpline


def generate_interpolated_path(camtoworlds: np.ndarray, n_interp: int,
                               spline_degree: int = 5, smoothness: float = 0.03):
    """Smooth spline through the given camera poses; returns [M, 4, 4]."""
    n = len(camtoworlds)
    t_in = np.linspace(0, 1, n)
    t_out = np.linspace(0, 1, n_interp * (n - 1))
    pos = CubicSpline(t_in, camtoworlds[:, :3, 3], axis=0)(t_out)
    slerp = Slerp(t_in, Rotation.from_matrix(camtoworlds[:, :3, :3]))
    rots = slerp(t_out).as_matrix()
    out = np.tile(np.eye(4), (len(t_out), 1, 1))
    out[:, :3, :3] = rots
    out[:, :3, 3] = pos
    return out


def generate_ellipse_path(camtoworlds: np.ndarray, n_frames: int = 120,
                          variation: float = 0.0, phase: float = 0.0,
                          height_percentile: float = 10.0):
    """Elliptical orbit fitted to the camera positions, looking at the scene
    center (reference ``generate_ellipse_path_z`` family)."""
    centers = camtoworlds[:, :3, 3]
    center = centers.mean(0)
    offset = centers - center
    sc_x, sc_y = np.percentile(np.abs(offset[:, 0]), 90), \
        np.percentile(np.abs(offset[:, 1]), 90)
    z_height = np.percentile(centers[:, 2], height_percentile)
    theta = np.linspace(0, 2 * np.pi, n_frames, endpoint=False) + phase

    positions = np.stack([
        center[0] + sc_x * np.cos(theta),
        center[1] + sc_y * np.sin(theta),
        np.full(n_frames, z_height)
        + variation * np.sin(2 * theta) * (centers[:, 2].std() + 1e-8),
    ], -1)

    look_at = center
    up_guess = np.array([0.0, 0.0, 1.0])
    out = []
    for p in positions:
        z = look_at - p
        z = z / np.linalg.norm(z)
        x = np.cross(z, up_guess)
        if np.linalg.norm(x) < 1e-8:
            x = np.array([1.0, 0, 0])
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        M = np.eye(4)
        M[:3, 0], M[:3, 1], M[:3, 2], M[:3, 3] = x, y, z, p
        out.append(M)
    return np.stack(out)


def generate_spiral_path(camtoworlds: np.ndarray, n_frames: int = 120,
                         n_rots: int = 2, zrate: float = 0.5,
                         radius_percentile: float = 90.0):
    """Forward-facing spiral (LLFF style)."""
    centers = camtoworlds[:, :3, 3]
    center_pose = camtoworlds[len(camtoworlds) // 2]
    radii = np.percentile(np.abs(centers - centers.mean(0)),
                          radius_percentile, axis=0)
    out = []
    for th in np.linspace(0, 2 * np.pi * n_rots, n_frames, endpoint=False):
        offs = np.array([np.cos(th), -np.sin(th), -np.sin(th * zrate)]) * radii
        p = center_pose[:3, 3] + center_pose[:3, :3] @ offs
        z = center_pose[:3, 2]
        x = np.cross(center_pose[:3, 1], z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        M = np.eye(4)
        M[:3, 0], M[:3, 1], M[:3, 2], M[:3, 3] = x, y, z, p
        out.append(M)
    return np.stack(out)
