"""Image files: 8-bit PNG in numpy and ``zlib``, other formats through
``imageio`` where it is installed.

The JAX package reads images through ``imageio``; the port reads and writes
PNG without it (grey, grey+alpha, RGB and RGBA, 8 bits, not interlaced,
all five row filters), so a scene loads on a machine that has neither
``imageio`` nor PIL.  Any other format goes to ``imageio`` and raises,
naming the format, where that is missing.  ``resize`` shrinks an image as
PIL's bilinear resize does, in torch.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}      # PNG colour type -> channels


def _is_png(path) -> bool:
    return os.fspath(path).lower().endswith(".png")


def _imageio(path, what):
    try:
        import imageio.v3 as iio
    except ImportError as e:
        ext = os.path.splitext(os.fspath(path))[1] or "(no extension)"
        raise RuntimeError(
            f"cannot {what} {path}: the format {ext} needs imageio, which is "
            "not installed (PNG needs nothing)") from e
    return iio


def _paeth(a, b, c):
    """PNG's Paeth predictor on int16 arrays."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(ftype, row, prev, bpp):
    """Reconstruct one row (uint8 [stride]) from its filtered bytes."""
    if ftype == 0:
        return row
    if ftype == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:
        return row + prev
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} is not one of 0..4")
    # Average and Paeth depend on the reconstructed left neighbour: a
    # sequential walk over the row's bytes
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def _read_png(path) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in chunk {kind!r}")
        pos += 12 + n
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if head is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"{path}: only 8-bit, non-interlaced grey/grey+alpha/RGB/RGBA PNG "
            f"is read (bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace})")
    C = _CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:H * (stride + 1)].reshape(H, stride + 1)
    img = np.empty((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        prev = img[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, C)
    return img.reshape(H, W) if C == 1 else img.reshape(H, W, C)


def _filter(ftype, x, bpp):
    """Filter all rows (uint8 [H, stride]) with one PNG filter type."""
    xi = x.astype(np.int16)
    a = np.zeros_like(xi)
    a[:, bpp:] = xi[:, :-bpp]
    b = np.zeros_like(xi)
    b[1:] = xi[:-1]
    c = np.zeros_like(xi)
    c[1:, bpp:] = xi[:-1, :-bpp]
    pred = {0: 0, 1: a, 2: b, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[ftype]
    return ((xi - pred) & 0xFF).astype(np.uint8)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _write_png(path, img, filter_type):
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG is written from uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    ctype = {v: k for k, v in _CHANNELS.items()}.get(C)
    if ctype is None:
        raise ValueError(f"PNG needs 1..4 channels, got {C}")
    if filter_type not in range(5):
        raise ValueError(f"PNG row filter {filter_type} is not one of 0..4")
    rows = _filter(filter_type, np.ascontiguousarray(img).reshape(H, W * C), C)
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8), rows], 1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                            0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def imread(path) -> np.ndarray:
    """[H, W] (grey) or [H, W, C] uint8 for a PNG; other formats through
    imageio."""
    if _is_png(path):
        return _read_png(path)
    return np.asarray(_imageio(path, "read").imread(path))


def imwrite(path, img, filter_type: int = 1) -> None:
    """Write uint8 [H, W] or [H, W, 1..4]; PNG rows all use ``filter_type``
    (0 none, 1 sub, 2 up, 3 average, 4 Paeth).  Other formats through
    imageio."""
    if _is_png(path):
        _write_png(path, img, filter_type)
    else:
        _imageio(path, "write").imwrite(path, np.asarray(img))


def resize(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Bilinear resize of a uint8 [H, W] or [H, W, C] image with
    antialiasing (the filter widened by the scale when shrinking, as PIL's
    ``Image.resize(..., BILINEAR)``), rounded back to uint8; within one
    grey level of PIL."""
    import torch
    import torch.nn.functional as F

    t = torch.as_tensor(np.asarray(img, np.uint8))
    chw = (t[None] if t.dim() == 2 else t.permute(2, 0, 1)).to(torch.float32)
    out = F.interpolate(chw[None], size=(height, width), mode="bilinear",
                        antialias=True, align_corners=False)[0]
    out = torch.round(out).clamp(0, 255).to(torch.uint8)
    return (out[0] if t.dim() == 2 else out.permute(1, 2, 0)).numpy()
