"""The ring scene of the mapper's configuration and its ground truth.

A frozen copy of the arithmetic of ``bench_e2e.py::build_scene_db`` (also
``bench_e2e_torch.py::write_ring_db``), in numpy with its draws in its
order, and a COLMAP database writer in plain ``sqlite3``: the benchmark
makes its own inputs and imports nothing of the program to do so.

``make_scene`` draws the cameras, the points and each camera's noisy
keypoints; ``write_database`` writes them with the ring's matches, and
``ba_observations`` gives the bundle-adjustment problem the ring's
visibility defines (every camera's view of every point it sees).
"""

from __future__ import annotations

import sqlite3

import numpy as np

SIMPLE_RADIAL = 2
CONFIG_CALIBRATED = 2
PAIR_BASE = 2**31 - 1          # COLMAP's pair-id packing

SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model INTEGER NOT NULL, width INTEGER NOT NULL, height INTEGER NOT NULL,
    params BLOB, prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name TEXT NOT NULL UNIQUE, camera_id INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL, F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
CREATE TABLE IF NOT EXISTS pose_priors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    position BLOB, coordinate_system INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS feature_name (
    feature_name TEXT PRIMARY KEY NOT NULL);
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
"""


def look_at_origin(center):
    """World->camera rotation of a camera at ``center`` looking at the
    origin (rows x, y, z)."""
    z = -center / np.linalg.norm(center)
    x = np.cross([0, 0, 1.0], z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], 0)


def matrix_to_quat_xyzw(R):
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4], scalar
    last, by the largest of the four diagonal combinations (Shepperd)."""
    R = np.asarray(R, np.float64)
    m = R.reshape(-1, 3, 3)
    t = np.stack([1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                  1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                  1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2],
                  1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2]], 1)
    best = np.argmax(t, 1)
    q = np.empty((len(m), 4))
    for i, (mi, b) in enumerate(zip(m, best)):
        s = 2.0 * np.sqrt(t[i, b])
        if b == 3:
            q[i] = [(mi[2, 1] - mi[1, 2]) / s, (mi[0, 2] - mi[2, 0]) / s,
                    (mi[1, 0] - mi[0, 1]) / s, s / 4]
        elif b == 0:
            q[i] = [s / 4, (mi[0, 1] + mi[1, 0]) / s, (mi[0, 2] + mi[2, 0]) / s,
                    (mi[2, 1] - mi[1, 2]) / s]
        elif b == 1:
            q[i] = [(mi[0, 1] + mi[1, 0]) / s, s / 4, (mi[1, 2] + mi[2, 1]) / s,
                    (mi[0, 2] - mi[2, 0]) / s]
        else:
            q[i] = [(mi[0, 2] + mi[2, 0]) / s, (mi[1, 2] + mi[2, 1]) / s, s / 4,
                    (mi[1, 0] - mi[0, 1]) / s]
    q *= np.where(q[:, 3:] < 0, -1.0, 1.0)
    return q.reshape(R.shape[:-2] + (4,))


def project(R, t, intr, X):
    """SIMPLE_RADIAL pixels of world points ``X`` [n, 3] in cameras (R [n,
    3, 3], t [n, 3], intr [n, 4] = f, cx, cy, k), and the camera-frame
    points."""
    xyz = np.einsum("nij,nj->ni", R, X) + t
    uv = xyz[:, :2] / xyz[:, 2:3]
    d = 1.0 + intr[:, 3:4] * np.sum(uv * uv, 1, keepdims=True)
    return uv * d * intr[:, :1] + intr[:, 1:3], xyz


def make_scene(cfg: dict, seed: int) -> dict:
    """The ring of ``cfg`` drawn from ``seed``: ``num_cams`` SIMPLE_RADIAL
    cameras on a ring of radius 8 * ``scene_scale`` looking at the origin,
    ``num_pts`` points in a cube of half-side 3 * ``scene_scale``, each
    camera seeing the points within ``vis_angle`` radians of its bearing,
    in front of it and inside the image; keypoints are the projections plus
    ``match_noise`` px of gaussian noise.  Returns the ground truth (R, t,
    centers, points, intrinsics) and, per camera, the seen point ids and
    their keypoints."""
    rng = np.random.default_rng(seed)
    C, T = int(cfg["num_cams"]), int(cfg["num_pts"])
    W, H = int(cfg["width"]), int(cfg["height"])
    f_px, cx, cy, k1 = (float(v) for v in cfg["intrinsics"])
    scale = float(cfg.get("scene_scale", 1.0))
    vis = float(cfg["vis_angle"])
    angles = np.linspace(0, 2 * np.pi, C, endpoint=False)
    centers = np.stack([8.0 * scale * np.cos(angles),
                        8.0 * scale * np.sin(angles),
                        1.0 + 0.3 * rng.standard_normal(C)], -1)
    points = rng.uniform(-3.0 * scale, 3.0 * scale, (T, 3))
    pt_angle = np.arctan2(points[:, 1], points[:, 0])
    Rs = np.stack([look_at_origin(c) for c in centers])
    ts = -np.einsum("cij,cj->ci", Rs, centers)
    intr = np.array([f_px, cx, cy, k1])
    seen, kps = [], []
    for i in range(C):
        near = np.abs((pt_angle - angles[i] + np.pi) % (2 * np.pi) - np.pi)
        cand = np.nonzero(near < vis + 1e-9)[0]
        xy, xyz = project(np.broadcast_to(Rs[i], (len(cand), 3, 3)),
                          np.broadcast_to(ts[i], (len(cand), 3)),
                          np.broadcast_to(intr, (len(cand), 4)), points[cand])
        dang = np.abs(np.angle(np.exp(1j * (pt_angle[cand] - angles[i]))))
        ok = ((xyz[:, 2] > 0.5) & (dang < vis) & (xy[:, 0] > 0)
              & (xy[:, 0] < W) & (xy[:, 1] > 0) & (xy[:, 1] < H))
        seen.append(cand[ok].astype(np.int32))
        kps.append(xy[ok] + float(cfg["match_noise"])
                   * rng.standard_normal((int(ok.sum()), 2)))
    return dict(R=Rs, t=ts, centers=centers, points=points, intr=intr,
                seen=seen, kps=kps, rng=rng, width=W, height=H)


def image_name(i: int) -> str:
    return f"img{i:04d}.jpg"


def write_database(path, scene: dict, cfg: dict) -> tuple:
    """The COLMAP database of ``scene``: one shared SIMPLE_RADIAL camera
    with a prior focal length, the images, their keypoints, and each camera
    matched with the next ``window`` on the ring (pairs sharing fewer than
    30 points are skipped), at most ``max_matches_per_pair`` of a pair's
    shared points drawn when nonzero, ``outlier_frac`` of every pair's
    matches redirected to random keypoints, every pair CALIBRATED.  The
    draws continue ``make_scene``'s generator.  Returns (pairs, matches)."""
    rng = scene["rng"]
    C, T = len(scene["seen"]), len(scene["points"])
    window = int(cfg["window"])
    cap = int(cfg.get("max_matches_per_pair", 0))
    outlier = float(cfg["outlier_frac"])
    eye = np.eye(3).tobytes()
    n_pairs = n_matches = 0
    conn = sqlite3.connect(str(path))
    try:
        conn.executescript(SCHEMA)
        conn.execute("INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
                     (1, SIMPLE_RADIAL, scene["width"], scene["height"],
                      scene["intr"].astype(np.float64).tobytes(), 1))
        conn.executemany("INSERT INTO images VALUES (?, ?, ?)",
                         [(i + 1, image_name(i), 1) for i in range(C)])
        conn.executemany(
            "INSERT INTO keypoints VALUES (?, ?, ?, ?)",
            [(i + 1, len(kp), 2, np.ascontiguousarray(kp, np.float32).tobytes())
             for i, kp in enumerate(scene["kps"])])
        rows = []
        feat_of = np.full(T, -1, np.int32)     # point -> feature in image i
        for i in range(C):
            feat_of[:] = -1
            feat_of[scene["seen"][i]] = np.arange(len(scene["seen"][i]),
                                                  dtype=np.int32)
            for dj in range(1, window + 1):
                j = (i + dj) % C
                fi_of_j = feat_of[scene["seen"][j]]
                both = fi_of_j >= 0
                if int(both.sum()) < 30:
                    continue
                fi = fi_of_j[both]
                fj = np.nonzero(both)[0].astype(np.int32)
                if cap and len(fi) > cap:
                    keep = rng.choice(len(fi), cap, replace=False)
                    fi, fj = fi[keep], fj[keep]
                a, b = (j, i) if j < i else (i, j)
                m = np.stack([fj, fi] if j < i else [fi, fj], 1)
                n_out = int(outlier * len(m))
                if n_out:
                    sel = rng.choice(len(m), n_out, replace=False)
                    m[sel, 1] = rng.integers(0, len(scene["kps"][b]), n_out)
                blob = np.ascontiguousarray(m, np.uint32).tobytes()
                pair_id = (a + 1) * PAIR_BASE + (b + 1)
                rows.append((pair_id, len(m), 2, blob))
                n_pairs += 1
                n_matches += len(m)
        conn.executemany("INSERT INTO matches VALUES (?, ?, ?, ?)", rows)
        conn.executemany(
            "INSERT INTO two_view_geometries VALUES "
            "(?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
            [(p, r, c, blob, CONFIG_CALIBRATED, eye, eye, eye,
              np.array([1.0, 0, 0, 0]).tobytes(), np.zeros(3).tobytes())
             for p, r, c, blob in rows])
        conn.execute("INSERT OR REPLACE INTO feature_name VALUES (?)",
                     ("colmap",))
        conn.commit()
    finally:
        conn.close()
    return n_pairs, n_matches


def ba_observations(scene: dict, min_views: int = 2) -> dict:
    """The bundle-adjustment problem of the ring's visibility: one row per
    (camera, point it sees), the keypoint as the measurement; points seen by
    fewer than ``min_views`` cameras are left out and the rest renumbered.
    Returns cam [O], pt [O], xy [O, 2] and the kept point ids."""
    cam = np.concatenate([np.full(len(s), i, np.int64)
                          for i, s in enumerate(scene["seen"])])
    pt = np.concatenate(scene["seen"]).astype(np.int64)
    xy = np.concatenate(scene["kps"])
    counts = np.bincount(pt, minlength=len(scene["points"]))
    kept = np.nonzero(counts >= min_views)[0]
    new_id = np.full(len(scene["points"]), -1, np.int64)
    new_id[kept] = np.arange(len(kept))
    ok = new_id[pt] >= 0
    return dict(cam=cam[ok], pt=new_id[pt[ok]], xy=xy[ok], point_ids=kept)
