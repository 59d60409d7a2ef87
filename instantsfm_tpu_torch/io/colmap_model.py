"""COLMAP sparse-model I/O (cameras/images/points3D, .bin and .txt).

Counterpart of ``instantsfm_tpu/io/colmap_model.py``: the per-record
readers and writers (everything ``read_model`` and ``write_model`` reach)
and the SoA binary writers of the mapper's export, in numpy and ``struct``;
the camera-model table is the port's ``scene/cameras.py``.

Binary layout (little-endian):
  cameras.bin : u64 count, then per camera: i32 id, i32 model, u64 w, u64 h,
                f64 params[num_params(model)]
  images.bin  : u64 count, then per image: i32 id, f64 qw qx qy qz, f64 tx ty tz,
                i32 camera_id, name bytes + NUL, u64 num_points2D,
                then per point: f64 x, f64 y, i64 point3D_id (-1 if none)
  points3D.bin: u64 count, then per point: u64 id, f64 x y z, u8 r g b,
                f64 error, u64 track_len, then per element: i32 image_id, i32 p2d_idx
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from instantsfm_tpu_torch.scene import cameras as cam_models

_MODEL_NUM_PARAMS = {mid: info["num_params"]
                     for mid, info in cam_models.CAMERA_MODEL_INFO.items()}
_MODEL_NAMES = {mid: info["name"] for mid, info in cam_models.CAMERA_MODEL_INFO.items()}
_NAME_TO_MODEL = {v: k for k, v in _MODEL_NAMES.items()}


@dataclass
class ModelCamera:
    id: int
    model_id: int
    width: int
    height: int
    params: np.ndarray


@dataclass
class ModelImage:
    id: int
    qvec_wxyz: np.ndarray   # (4,) w,x,y,z — COLMAP convention
    tvec: np.ndarray        # (3,)
    camera_id: int
    name: str
    xys: np.ndarray         # (K, 2)
    point3D_ids: np.ndarray  # (K,) int64, -1 if no 3D point


@dataclass
class ModelPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray    # (L,)
    point2D_idxs: np.ndarray  # (L,)


def _read(fid, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack("<" + fmt, fid.read(size))


def _write(fid, fmt, *vals):
    fid.write(struct.pack("<" + fmt, *vals))


# ---------------------------------------------------------------- binary read

def read_cameras_binary(path) -> Dict[int, ModelCamera]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "iiQQ")
            npar = _MODEL_NUM_PARAMS[model_id]
            params = np.array(_read(f, "d" * npar))
            out[cid] = ModelCamera(cid, model_id, w, h, params)
    return out


def read_images_binary(path) -> Dict[int, ModelImage]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            iid = _read(f, "i")[0]
            q = np.array(_read(f, "dddd"))
            t = np.array(_read(f, "ddd"))
            cam_id = _read(f, "i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "Q")
            data = np.frombuffer(f.read(24 * npts), dtype=np.dtype("<f8, <f8, <i8"))
            xys = np.stack([data["f0"], data["f1"]], -1) if npts else np.zeros((0, 2))
            p3d = data["f2"].astype(np.int64) if npts else np.zeros(0, np.int64)
            out[iid] = ModelImage(iid, q, t, cam_id, name.decode("utf-8"), xys, p3d)
    return out


def read_points3D_binary(path) -> Dict[int, ModelPoint3D]:
    out = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            pid = _read(f, "Q")[0]
            xyz = np.array(_read(f, "ddd"))
            rgb = np.array(_read(f, "BBB"), dtype=np.uint8)
            (err,) = _read(f, "d")
            (tlen,) = _read(f, "Q")
            data = np.frombuffer(f.read(8 * tlen), dtype=np.dtype("<i4, <i4"))
            out[pid] = ModelPoint3D(pid, xyz, rgb, err,
                                    data["f0"].astype(np.int64),
                                    data["f1"].astype(np.int64))
    return out


# --------------------------------------------------------------- binary write

def write_cameras_binary(cams: List[ModelCamera], path) -> None:
    with open(path, "wb") as f:
        _write(f, "Q", len(cams))
        for c in cams:
            _write(f, "iiQQ", c.id, c.model_id, c.width, c.height)
            npar = _MODEL_NUM_PARAMS[c.model_id]
            _write(f, "d" * npar, *[float(p) for p in c.params[:npar]])


def write_images_binary(imgs: List[ModelImage], path) -> None:
    with open(path, "wb") as f:
        _write(f, "Q", len(imgs))
        for im in imgs:
            _write(f, "i", im.id)
            _write(f, "dddd", *[float(v) for v in im.qvec_wxyz])
            _write(f, "ddd", *[float(v) for v in im.tvec])
            _write(f, "i", im.camera_id)
            f.write(im.name.encode("utf-8") + b"\x00")
            _write(f, "Q", len(im.xys))
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                _write(f, "ddq", float(x), float(y), int(pid))


def write_points3D_binary(pts: List[ModelPoint3D], path) -> None:
    with open(path, "wb") as f:
        _write(f, "Q", len(pts))
        for p in pts:
            _write(f, "Q", p.id)
            _write(f, "ddd", *[float(v) for v in p.xyz])
            _write(f, "BBB", *[int(v) for v in p.rgb])
            _write(f, "d", float(p.error))
            _write(f, "Q", len(p.image_ids))
            for iid, p2d in zip(p.image_ids, p.point2D_idxs):
                _write(f, "ii", int(iid), int(p2d))


# ------------------------------------------- vectorized (SoA) binary writers
#
# The per-object writers above loop per record / per track element with
# struct.pack — fine for small models, slow for large ones (the JAX
# package's notes: ~35 s for 864k points / 6.7M track elements).  These
# paths serialize straight from the
# pipeline's flat SoA arrays: fixed-size record headers as one numpy
# structured array, variable-length tails interleaved with two broadcasted
# byte scatters into a single output buffer.

_PT3D_HDR = np.dtype([("id", "<u8"), ("xyz", "<f8", (3,)),
                      ("rgb", "u1", (3,)), ("err", "<f8"), ("tlen", "<u8")])
_PT3D_ELEM = np.dtype([("iid", "<i4"), ("p2d", "<i4")])
_IMG_KP = np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<i8")])


def write_points3D_binary_soa(path, ids, xyz, rgb, errors, obs_offset,
                              image_ids, point2D_idxs) -> None:
    """points3D.bin from flat arrays: ids [T], xyz [T,3], rgb [T,3] u8,
    errors [T], obs_offset [T+1], image_ids/point2D_idxs [O]."""
    T = len(ids)
    tlen = np.diff(obs_offset).astype(np.int64)
    O = int(obs_offset[-1])
    hdr = np.empty(T, _PT3D_HDR)
    hdr["id"] = ids
    hdr["xyz"] = xyz
    hdr["rgb"] = rgb
    hdr["err"] = errors
    hdr["tlen"] = tlen

    hsz = _PT3D_HDR.itemsize                      # 51
    rec = hsz + 8 * tlen
    starts = np.empty(T, np.int64)
    if T:
        starts[0] = 8
        np.cumsum(rec[:-1], out=starts[1:]) if T > 1 else None
        if T > 1:
            starts[1:] += 8
    buf = np.empty(8 + int(rec.sum()), np.uint8)
    buf[:8] = np.frombuffer(struct.pack("<Q", T), np.uint8)
    if T:
        buf[starts[:, None] + np.arange(hsz)] = \
            hdr.view(np.uint8).reshape(T, hsz)
    if O:
        elem = np.empty(O, _PT3D_ELEM)
        elem["iid"] = image_ids
        elem["p2d"] = point2D_idxs
        estart = (np.repeat(starts + hsz, tlen)
                  + 8 * (np.arange(O) - np.repeat(obs_offset[:-1], tlen)))
        buf[estart[:, None] + np.arange(8)] = \
            elem.view(np.uint8).reshape(O, 8)
    with open(path, "wb") as f:
        buf.tofile(f)


def write_images_binary_soa(path, ids, qvec_wxyz, tvec, camera_ids, names,
                            kp_xy, kp_offset, point3D_ids) -> None:
    """images.bin from flat arrays: per-image header loop (images are few),
    per-keypoint rows serialized as one structured array per image."""
    chunks = [struct.pack("<Q", len(ids))]
    for k, iid in enumerate(ids):
        s, e = int(kp_offset[k]), int(kp_offset[k + 1])
        chunks.append(struct.pack(
            "<idddddddi", int(iid), *[float(v) for v in qvec_wxyz[k]],
            *[float(v) for v in tvec[k]], int(camera_ids[k])))
        chunks.append(names[k].encode("utf-8") + b"\x00")
        chunks.append(struct.pack("<Q", e - s))
        row = np.empty(e - s, _IMG_KP)
        row["x"] = kp_xy[s:e, 0]
        row["y"] = kp_xy[s:e, 1]
        row["pid"] = point3D_ids[s:e]
        chunks.append(row.tobytes())
    with open(path, "wb") as f:
        f.write(b"".join(chunks))


# ------------------------------------------------------------------ text I/O

def write_cameras_text(cams: List[ModelCamera], path) -> None:
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n"
                "#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n"
                f"# Number of cameras: {len(cams)}\n")
        for c in cams:
            npar = _MODEL_NUM_PARAMS[c.model_id]
            params = " ".join(str(float(p)) for p in c.params[:npar])
            f.write(f"{c.id} {_MODEL_NAMES[c.model_id]} {c.width} {c.height} {params}\n")


def write_images_text(imgs: List[ModelImage], path) -> None:
    n_obs = [int((im.point3D_ids != -1).sum()) for im in imgs]
    mean_obs = (sum(n_obs) / len(imgs)) if imgs else 0
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n"
                "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n"
                "#   POINTS2D[] as (X, Y, POINT3D_ID)\n"
                f"# Number of images: {len(imgs)}, mean observations per image: {mean_obs}\n")
        for im in imgs:
            head = [im.id, *im.qvec_wxyz.tolist(), *im.tvec.tolist(), im.camera_id, im.name]
            f.write(" ".join(map(str, head)) + "\n")
            pts = []
            for (x, y), pid in zip(im.xys, im.point3D_ids):
                pts.append(f"{x} {y} {pid}")
            f.write(" ".join(pts) + "\n")


def write_points3D_text(pts: List[ModelPoint3D], path) -> None:
    mean_track = (sum(len(p.image_ids) for p in pts) / len(pts)) if pts else 0
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n"
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
                f"# Number of points: {len(pts)}, mean track length: {mean_track}\n")
        for p in pts:
            head = [p.id, *p.xyz.tolist(), *[int(v) for v in p.rgb], p.error]
            track = " ".join(f"{int(i)} {int(j)}" for i, j in zip(p.image_ids, p.point2D_idxs))
            f.write(" ".join(map(str, head)) + " " + track + "\n")


def read_cameras_text(path) -> Dict[int, ModelCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
            params = np.array([float(v) for v in parts[4:]])
            out[cid] = ModelCamera(cid, _NAME_TO_MODEL[model], w, h, params)
    return out


def read_images_text(path) -> Dict[int, ModelImage]:
    out = {}
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip() and not l.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        q = np.array([float(v) for v in parts[1:5]])
        t = np.array([float(v) for v in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        elems = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(elems[j]), float(elems[j + 1])]
                        for j in range(0, len(elems), 3)]).reshape(-1, 2)
        p3d = np.array([int(float(elems[j + 2])) for j in range(0, len(elems), 3)],
                       dtype=np.int64)
        out[iid] = ModelImage(iid, q, t, cam_id, name, xys, p3d)
    return out


def read_points3D_text(path) -> Dict[int, ModelPoint3D]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            pid = int(parts[0])
            xyz = np.array([float(v) for v in parts[1:4]])
            rgb = np.array([int(float(v)) for v in parts[4:7]], dtype=np.uint8)
            err = float(parts[7])
            rest = parts[8:]
            image_ids = np.array([int(rest[j]) for j in range(0, len(rest), 2)], np.int64)
            p2d = np.array([int(rest[j + 1]) for j in range(0, len(rest), 2)], np.int64)
            out[pid] = ModelPoint3D(pid, xyz, rgb, err, image_ids, p2d)
    return out


def read_model(path) -> Tuple[dict, dict, dict]:
    """Auto-detect binary vs text model in ``path``."""
    if os.path.exists(os.path.join(path, "cameras.bin")):
        return (read_cameras_binary(os.path.join(path, "cameras.bin")),
                read_images_binary(os.path.join(path, "images.bin")),
                read_points3D_binary(os.path.join(path, "points3D.bin")))
    return (read_cameras_text(os.path.join(path, "cameras.txt")),
            read_images_text(os.path.join(path, "images.txt")),
            read_points3D_text(os.path.join(path, "points3D.txt")))


def write_model(cams, imgs, pts, path, binary=True) -> None:
    os.makedirs(path, exist_ok=True)
    if binary:
        write_cameras_binary(cams, os.path.join(path, "cameras.bin"))
        write_images_binary(imgs, os.path.join(path, "images.bin"))
        write_points3D_binary(pts, os.path.join(path, "points3D.bin"))
    else:
        write_cameras_text(cams, os.path.join(path, "cameras.txt"))
        write_images_text(imgs, os.path.join(path, "images.txt"))
        write_points3D_text(pts, os.path.join(path, "points3D.txt"))
