"""Reading a written COLMAP sparse model and scoring it against the truth.

Plain numpy and ``struct``: the binary layout is COLMAP's own
(``cameras.bin``, ``images.bin``, ``points3D.bin``, little-endian).  The
score aligns the model to the ground truth by the least-squares similarity
of the camera centres (Umeyama) and measures rotations, centres and points
after it.
"""

from __future__ import annotations

import os
import struct

import numpy as np

NUM_PARAMS = {0: 3, 1: 4, 2: 4, 3: 5, 4: 8, 5: 8, 6: 12, 7: 5, 8: 4, 9: 5,
              10: 12}


def _quat_wxyz_to_matrix(q):
    w, x, y, z = (q[:, i] for i in range(4))
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)


def read_model(path: str) -> dict:
    """The model in ``path``: cameras {id: (model, w, h, params)}, and per
    image its name, rotation R [3, 3] (world to camera), translation and
    per-keypoint 3D point ids; per point its id, xyz and track (image id,
    keypoint index) pairs."""
    with open(os.path.join(path, "cameras.bin"), "rb") as f:
        buf = f.read()
    cams, off = {}, 8
    for _ in range(struct.unpack_from("<Q", buf, 0)[0]):
        cid, model, w, h = struct.unpack_from("<iiQQ", buf, off)
        off += 24
        n = NUM_PARAMS[model]
        cams[cid] = (model, w, h, np.frombuffer(buf, "<f8", n, off).copy())
        off += 8 * n

    with open(os.path.join(path, "images.bin"), "rb") as f:
        buf = f.read()
    ids, names, qs, ts, p3d = [], [], [], [], []
    off = 8
    row = np.dtype([("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
    for _ in range(struct.unpack_from("<Q", buf, 0)[0]):
        vals = struct.unpack_from("<idddddddi", buf, off)
        off += 64
        end = buf.index(b"\x00", off)
        names.append(buf[off:end].decode("utf-8"))
        off = end + 1
        (n2,) = struct.unpack_from("<Q", buf, off)
        off += 8
        pts = np.frombuffer(buf, row, n2, off)
        off += 24 * n2
        ids.append(vals[0])
        qs.append(vals[1:5])
        ts.append(vals[5:8])
        p3d.append(pts["id"].copy())

    with open(os.path.join(path, "points3D.bin"), "rb") as f:
        buf = f.read()
    pids, xyz, tracks = [], [], []
    off = 8
    for _ in range(struct.unpack_from("<Q", buf, 0)[0]):
        pid, x, y, z = struct.unpack_from("<Qddd", buf, off)
        off += 8 + 24 + 3 + 8
        (n,) = struct.unpack_from("<Q", buf, off)
        off += 8
        tracks.append(np.frombuffer(buf, "<i4", 2 * n, off).reshape(n, 2)
                      .copy())
        off += 8 * n
        pids.append(pid)
        xyz.append((x, y, z))
    q = np.array(qs, np.float64).reshape(-1, 4)
    return dict(cameras=cams, image_ids=np.array(ids, np.int64), names=names,
                R=_quat_wxyz_to_matrix(q), t=np.array(ts).reshape(-1, 3),
                point3D_ids=p3d, point_ids=np.array(pids, np.int64),
                xyz=np.array(xyz, np.float64).reshape(-1, 3), tracks=tracks)


def umeyama(src, dst):
    """(s, R, t) minimising sum |s R src + t - dst|^2 over similarities."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    a, b = src - mu_s, dst - mu_d
    cov = b.T @ a / len(src)
    U, S, Vt = np.linalg.svd(cov)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / np.mean(np.sum(a * a, 1))
    return s, R, mu_d - s * R @ mu_s


def rotation_angles_deg(Ra, Rb):
    """Angles in degrees of Ra_i Rb_i^T."""
    tr = np.einsum("nij,nij->n", Ra, Rb)
    return np.degrees(np.arccos(np.clip((tr - 1) / 2, -1.0, 1.0)))


def score(model: dict, truth: dict, image_index: dict, seen: list) -> dict:
    """The model against the ground truth (R, centers, points of
    ``ring.make_scene``): images registered, the rotation error (degrees)
    and the centre error (share of the ground truth's extent) of every
    registered image after the similarity that best maps the model's
    centres onto the true ones, and the error of the model's points whose
    whole track sees one true point (share of the extent), their median
    and 99th percentile.  ``image_index`` maps an image name to its ring
    index and ``seen[i]`` lists the true point of each keypoint of image
    i."""
    idx = np.array([image_index[n] for n in model["names"]], np.int64)
    R = model["R"]
    centers = -np.einsum("nji,nj->ni", R, model["t"])
    c_gt = truth["centers"][idx]
    s, Ra, ta = umeyama(centers, c_gt)
    extent = float(np.linalg.norm(c_gt.max(0) - c_gt.min(0)))
    c_al = s * centers @ Ra.T + ta
    # world->camera rotation in the aligned frame: R Ra^T
    rot = rotation_angles_deg(np.einsum("nij,kj->nik", R, Ra),
                              truth["R"][idx])
    ate = np.linalg.norm(c_al - c_gt, axis=1) / extent

    # the true point of every track element: model image id -> ring index
    # -> the point its keypoint saw
    ring_of = np.full(int(model["image_ids"].max()) + 1, -1, np.int64)
    ring_of[model["image_ids"]] = idx
    offsets = np.concatenate([[0], np.cumsum([len(t) for t in
                                              model["tracks"]])]).astype(
        np.int64)
    flat = np.concatenate(model["tracks"] + [np.zeros((0, 2), np.int32)])
    feat_base = np.concatenate([[0], np.cumsum([len(s_) for s_ in seen])])
    all_seen = np.concatenate(seen)
    true_id = all_seen[feat_base[ring_of[flat[:, 0]]] + flat[:, 1]]
    nonempty = offsets[1:] > offsets[:-1]
    lo = np.minimum.reduceat(true_id, offsets[:-1][nonempty])
    hi = np.maximum.reduceat(true_id, offsets[:-1][nonempty])
    one = np.zeros(len(model["tracks"]), bool)
    one[nonempty] = lo == hi
    first = np.zeros(len(model["tracks"]), np.int64)
    first[nonempty] = lo
    aligned = s * model["xyz"][one] @ Ra.T + ta
    errs = np.linalg.norm(aligned - truth["points"][first[one]], axis=1) \
        / extent
    if not len(errs):
        errs = np.array([np.inf])
    return dict(registered=int(len(idx)), rot_err_max_deg=float(rot.max()),
                rot_err_mean_deg=float(rot.mean()),
                center_err_max=float(ate.max()),
                center_err_mean=float(ate.mean()),
                points_scored=int(len(errs)),
                point_err_median=float(np.median(errs)),
                point_err_p99=float(np.quantile(errs, 0.99)))
