"""The 3DGS scene of a configuration, drawn from the seed and written to
disk as a trainer reads it.

The ground truth is a splat scene: ``num_gaussians`` gaussians on the
faces of a cube of half-side ``cube_half`` (SH degree 3, the DC term from
a colour of checkerboards and noise, the rest small), seen by
``num_views`` PINHOLE cameras on a ring around it, looking at its
centre.  The views are rendered by the plain reference
(``gs_reference``, float32) and written as 8-bit PNG; the sparse model
(COLMAP's binary ``cameras.bin``, ``images.bin``, ``points3D.bin``) holds
the cameras and ``num_points`` SfM points: the centres of as many
gaussians drawn without replacement (a coarser model than the scene, when
there are fewer points than gaussians), moved by seeded noise, with their
colours.  numpy, ``zlib`` and ``struct``, and
torch for the render; nothing of the program.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from yardstick import gs_reference as ref

SH_C0 = 0.28209479177387814


def look_at(centre):
    """World-to-camera rotation of a camera at ``centre`` looking at the
    origin, x right, y down, z forward, the world's z up."""
    f = -centre / np.linalg.norm(centre)
    x = np.cross(f, [0.0, 0.0, 1.0])
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(f, x), f])


def checker(x, cell: float, phase) -> np.ndarray:
    """+1 or -1 on the cells of a 3-D checkerboard of side ``cell`` at
    points ``x`` [n, 3], shifted by ``phase`` [3] cells."""
    return np.sign(np.prod(np.sin(np.pi * (x / cell + phase)), axis=1))


def make_scene(cfg: dict, seed: int) -> dict:
    """The ground truth of ``cfg`` (the configuration's ``scene``) from
    ``seed``: gaussians, cameras and SfM points, numpy.  The gaussians lie
    on the faces of a cube of half-side ``cube_half``, the surfaces a
    camera sees, coloured by checkerboards (``checker_cells``, each with
    its own colour contrast) and a little noise: edges at several scales,
    which a coarse model fits only by densifying."""
    rng = np.random.default_rng([seed, 0])
    n, h = cfg["num_gaussians"], cfg["cube_half"]
    means = rng.uniform(-h, h, (n, 3))
    face = rng.integers(0, 6, n)
    means[np.arange(n), face // 2] = np.where(face % 2 == 1, h, -h)
    colors = np.full((n, 3), 0.5)
    for cell, amp in zip(cfg["checker_cells"], cfg["checker_contrast"]):
        colors += amp * checker(means, cell, rng.uniform(0, 1, 3))[:, None] \
            * rng.choice([-1.0, 1.0], 3)
    colors = np.clip(colors + cfg["color_noise"] * rng.standard_normal(
        (n, 3)), 0.05, 0.95)
    sh = cfg["sh_rest_sigma"] * rng.standard_normal((n, 16, 3))
    sh[:, 0] = (colors - 0.5) / SH_C0
    g = dict(means=means,
             quats=rng.standard_normal((n, 4)),
             scales=rng.uniform(*cfg["scale_range"], (n, 3)),
             opacities=rng.uniform(*cfg["opacity_range"], n),
             sh=sh, colors=colors)
    W, H, f = cfg["width"], cfg["height"], cfg["focal"]
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    views = []
    for a in np.linspace(0, 2 * np.pi, cfg["num_views"], endpoint=False):
        c = np.array([cfg["ring_radius"] * np.cos(a),
                      cfg["ring_radius"] * np.sin(a), cfg["ring_height"]])
        R = look_at(c)
        views.append((R, -R @ c))
    m = cfg["num_points"]
    pick = rng.choice(n, m, replace=m > n)
    points = g["means"][pick] + cfg["point_noise"] * rng.standard_normal(
        (m, 3))
    points_rgb = np.round(colors[pick] * 255).astype(np.uint8)
    return dict(gauss=g, K=K, views=views, points=points,
                points_rgb=points_rgb, width=W, height=H)


@torch.no_grad()
def render_views(scene: dict, device) -> list:
    """Each view of the ground truth, [H, W, 3] uint8."""
    g = scene["gauss"]
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    prec = ref.Precision(torch.float32)
    means, sh, opac = t(g["means"]), t(g["sh"]), t(g["opacities"])
    out = []
    with ref.no_tf32():
        for R, tvec in scene["views"]:
            view = np.eye(4)
            view[:3, :3], view[:3, 3] = R, tvec
            view = t(view)
            proj = ref.project(means, t(g["quats"]), t(g["scales"]), view,
                               t(scene["K"]), scene["width"], scene["height"],
                               prec=prec)
            campos = -view[:3, :3].T @ view[:3, 3]
            img = ref.render(proj, ref.sh_colors(3, sh, means, campos), opac,
                             scene["width"], scene["height"])
            out.append(torch.round(torch.clamp(img, 0, 1) * 255)
                       .to(torch.uint8).cpu().numpy())
    return out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG, every row with the Sub filter."""
    H, W, _ = img.shape
    rows = img.reshape(H, W * 3).astype(np.int16)
    sub = (rows - np.concatenate([np.zeros((H, 3), np.int16),
                                  rows[:, :-3]], 1)) % 256
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub.astype(np.uint8)],
                         1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def rotation_to_quat_wxyz(R):
    """A rotation matrix as a unit quaternion (w, x, y, z), w >= 0."""
    w = np.sqrt(max(1.0 + np.trace(R), 0.0)) / 2
    if w > 1e-3:
        q = np.array([w, (R[2, 1] - R[1, 2]) / (4 * w),
                      (R[0, 2] - R[2, 0]) / (4 * w),
                      (R[1, 0] - R[0, 1]) / (4 * w)])
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2
        q = np.empty(4)
        q[1 + i] = s / 4
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        q[0] = (R[k, j] - R[j, k]) / s
    q /= np.linalg.norm(q)
    return q if q[0] >= 0 else -q


def write_model(path: str, scene: dict, names: list) -> None:
    """COLMAP's binary model: one PINHOLE camera, the views (no
    keypoints), the SfM points (empty tracks)."""
    os.makedirs(path, exist_ok=True)
    K = scene["K"]
    with open(os.path.join(path, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", 1))
        f.write(struct.pack("<iiQQ", 1, 1, scene["width"], scene["height"]))
        f.write(struct.pack("<4d", K[0, 0], K[1, 1], K[0, 2], K[1, 2]))
    with open(os.path.join(path, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(names)))
        for i, ((R, t), name) in enumerate(zip(scene["views"], names)):
            f.write(struct.pack("<i4d3di", i + 1, *rotation_to_quat_wxyz(R),
                                *t, 1))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    rec = np.dtype([("id", "<u8"), ("xyz", "<f8", 3), ("rgb", "u1", 3),
                    ("error", "<f8"), ("track", "<u8")])
    pts = np.zeros(len(scene["points"]), rec)
    pts["id"] = np.arange(1, len(pts) + 1)
    pts["xyz"] = scene["points"]
    pts["rgb"] = scene["points_rgb"]
    with open(os.path.join(path, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        f.write(pts.tobytes())


def write(root: str, cfg: dict, seed: int, device) -> dict:
    """The scene of ``cfg`` from ``seed`` under ``root`` (``images/`` and
    ``sparse/0``); returns it with its rendered views (``targets``) and
    their file names, in order."""
    scene = make_scene(cfg, seed)
    scene["targets"] = render_views(scene, device)
    scene["names"] = [f"v{i:03d}.png" for i in range(len(scene["views"]))]
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for name, img in zip(scene["names"], scene["targets"]):
        write_png(os.path.join(root, "images", name), img)
    write_model(os.path.join(root, "sparse", "0"), scene, scene["names"])
    return scene
