"""PNG compression of a trained splat model (reference ``PngCompression``,
``vis/gsplat_trainer.py:49,367-372,825-830`` / gsplat.compression).

Counterpart of ``instantsfm_tpu/gs/compression.py``, writing the same
files: the PNG planes go through the port's own codec (``io/image.py``),
so neither imageio nor PIL is needed, and ``meta.json`` holds the same
entries.

Each attribute is packed into a square image grid and quantized per channel:
means to 16 bit (two 8-bit PNG planes, low/high byte), everything else to
8 bit; per-channel min/max ranges live in ``meta.json``.  ``decompress``
round-trips to a splat dict.  (gsplat additionally K-means-codebooks the SH
rest coefficients; here they are quantized directly — simpler, same storage
format idea, and lossless-format PNGs throughout.)

Only ALIVE gaussians are stored (the fixed-capacity training pool is an
internal layout, not part of the exported model).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from instantsfm_tpu_torch.io.image import imread, imwrite


def _to_grid(a: np.ndarray, side: int) -> np.ndarray:
    """[N, C] -> [side, side, C] zero-padded."""
    N, C = a.shape
    out = np.zeros((side * side, C), a.dtype)
    out[:N] = a
    return out.reshape(side, side, C)


def _quantize(a: np.ndarray, bits: int):
    lo = a.min(axis=0)
    hi = a.max(axis=0)
    scale = np.where(hi > lo, hi - lo, 1.0)
    q = np.round((a - lo) / scale * (2 ** bits - 1))
    return q.astype(np.uint16 if bits == 16 else np.uint8), lo, hi


def _write_png(path: str, img: np.ndarray) -> None:
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    elif img.ndim == 3 and img.shape[-1] == 2:
        # as the JAX package writes them: 2-channel planes padded to 3
        # (read back by slicing)
        img = np.concatenate([img, np.zeros_like(img[..., :1])], axis=-1)
    imwrite(path, img)


def _read_png(path: str) -> np.ndarray:
    a = imread(path)
    if a.ndim == 2:
        a = a[..., None]
    return a


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def compress_splats(splats, out_dir: str) -> dict:
    """splats: gs.splats.Splats (tensors or arrays, with ``alive``).
    Writes PNG planes + meta.json under ``out_dir``; returns the meta
    dict."""
    os.makedirs(out_dir, exist_ok=True)
    sh0, shN = _numpy(splats.sh0), _numpy(splats.shN)
    n_all = len(sh0)
    fields = {
        "means": _numpy(splats.means),
        "scales": _numpy(splats.scales),
        "quats": _numpy(splats.quats),
        "opacities": _numpy(splats.opacities)[:, None],
        "sh0": sh0.reshape(n_all, -1),
        "shN": shN.reshape(n_all, -1),
    }
    alive = _numpy(splats.alive).astype(bool)
    N = int(alive.sum())
    side = int(np.ceil(np.sqrt(max(N, 1))))
    meta = {"n": N, "side": side, "fields": {},
            "shapes": {"sh0": list(sh0.shape[1:]),
                       "shN": list(shN.shape[1:])}}
    for name, a in fields.items():
        a = a[alive].astype(np.float64)
        bits = 16 if name == "means" else 8
        q, lo, hi = _quantize(a, bits)
        grid = _to_grid(q, side)
        if bits == 16:
            _write_png(os.path.join(out_dir, f"{name}_lo.png"),
                       (grid & 0xFF).astype(np.uint8))
            _write_png(os.path.join(out_dir, f"{name}_hi.png"),
                       (grid >> 8).astype(np.uint8))
        else:
            # PNG supports 1-4 channels; split wider attributes into planes
            C = grid.shape[-1]
            for p0 in range(0, C, 4):
                _write_png(os.path.join(out_dir, f"{name}_{p0 // 4}.png"),
                           grid[..., p0: p0 + 4])
        meta["fields"][name] = {"bits": bits, "channels": int(a.shape[1]),
                                "min": lo.tolist(), "max": hi.tolist()}
    with open(os.path.join(out_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    return meta


def decompress_splats(in_dir: str) -> dict:
    """Reads ``compress_splats`` output -> dict of float32 arrays."""
    with open(os.path.join(in_dir, "meta.json")) as f:
        meta = json.load(f)
    N = meta["n"]
    out = {}
    for name, info in meta["fields"].items():
        C = info["channels"]
        if info["bits"] == 16:
            lo8 = _read_png(os.path.join(in_dir, f"{name}_lo.png"))
            hi8 = _read_png(os.path.join(in_dir, f"{name}_hi.png"))
            q = hi8.astype(np.uint16) * 256 + lo8.astype(np.uint16)
        else:
            planes = []
            for p0 in range(0, C, 4):
                want = min(4, C - p0)     # 2-ch planes were padded to 3
                planes.append(_read_png(
                    os.path.join(in_dir, f"{name}_{p0 // 4}.png"))[..., :want])
            q = np.concatenate(planes, axis=-1)
        q = q.reshape(-1, q.shape[-1])[:N].astype(np.float64)
        lo = np.asarray(info["min"])
        hi = np.asarray(info["max"])
        scale = np.where(hi > lo, hi - lo, 1.0)
        a = q / (2 ** info["bits"] - 1) * scale + lo
        if name == "opacities":
            a = a[:, 0]
        elif name in ("sh0", "shN"):
            a = a.reshape([N] + meta["shapes"][name])
        out[name] = a.astype(np.float32)
    return out
