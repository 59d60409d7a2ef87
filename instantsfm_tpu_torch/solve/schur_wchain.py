"""Observation half of the reduced-camera Schur matvec (kernel K1).

Replaces ``instantsfm_tpu/solve/pallas_schur.py::schur_wchain``.  Every PCG
iteration of BA (camera block PC=8) and GP (PC=3) applies

    y = U_d x - SUM_cam u,    u_o = W_o V_inv[pt_o] SUM_track(o) W_kᵀ x[cam_k]

and this module computes u [O', PC] (obs-major) for the bucketed track
layout (``solve/blocked.py``): the observations of one track are an aligned
group of L = 2**k rows.  The camera-side sum stays outside (``index_add_``).

``schur_wchain`` dispatches on the device of its inputs: CPU tensors go to
``schur_wchain_reference`` (plain torch), CUDA tensors to the hand-written
kernel in ``csrc/schur_wchain.cu`` (built with nvcc on first use, launched
on the current stream).  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from instantsfm_tpu_torch.solve.blocked import gather_pt, seg_by_pt
from instantsfm_tpu_torch.utils import build

BLOCK = 256       # threads per block (must match csrc/schur_wchain.cu)
MAX_BUCKETS = 32  # bucket-table capacity (must match csrc/schur_wchain.cu)
MAX_PC = 8


def schur_wchain_reference(W, V_inv, x, cam_idx, pt_idx, buckets):
    """Plain torch version: gather x[cam], t = Wᵀ x, track sums (bucketed
    reshape-sums, or a sorted segment sum without buckets), z = V_inv s,
    u = W z.

    W [O', PC, 3], V_inv [T, 3, 3], x [C, PC], cam_idx/pt_idx [O'] int.
    """
    O = W.shape[0]
    T = V_inv.shape[0]
    t = torch.sum(W * x[cam_idx][:, :, None], dim=1)              # [O, 3]
    if buckets:
        s = seg_by_pt(t, buckets, T)
    else:
        s = t.new_zeros((T, 3)).index_add_(0, pt_idx, t)
    z = torch.sum(V_inv * s[:, None, :], dim=-1)                  # [T, 3]
    zg = gather_pt(z, buckets, O) if buckets else z[pt_idx]
    return torch.sum(W * zg[:, None, :], dim=-1)                  # [O, PC]


@lru_cache(maxsize=64)
def launch_table(buckets):
    """Per-bucket launch geometry for the kernel, as int64 host arrays:
    (row_start, rows, log_l, blk_off).

    A bucket with L <= BLOCK gets one block per BLOCK rows (each block holds
    whole groups); a bucket with L > BLOCK gets one block per group.  Block
    b of the flat grid serves bucket i where blk_off[i] <= b < blk_off[i+1].
    """
    if not buckets:
        raise ValueError("schur_wchain kernel needs the bucketed track layout "
                         "(solve.blocked.bucketize_problem)")
    if len(buckets) > MAX_BUCKETS:
        raise ValueError(f"{len(buckets)} buckets > MAX_BUCKETS={MAX_BUCKETS}")
    row_start, rows, log_l, blk_off = [], [], [], [0]
    for (os_, ps, Tb, L) in buckets:
        if L < 1 or L & (L - 1):
            raise ValueError(f"bucket length {L} is not a power of two")
        span = Tb * L
        per_block = max(BLOCK, L)
        row_start.append(os_)
        rows.append(span)
        log_l.append(L.bit_length() - 1)
        blk_off.append(blk_off[-1] + -(-span // per_block))
    return tuple(np.asarray(a, np.int64)
                 for a in (row_start, rows, log_l, blk_off))


@lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use) with its C signatures."""
    lib = build.load("schur_wchain")
    p = ctypes.c_void_p
    lib.schur_wchain_launch.argtypes = [
        ctypes.c_int, ctypes.c_int,          # dtype code, PC
        p, p, p, p, p, p,                    # W, V_inv, x, cam, pt, u
        ctypes.c_int, p, p, p, p,            # nb, row_start, rows, log_l, blk_off
        p]                                   # stream
    lib.schur_wchain_launch.restype = ctypes.c_int
    lib.schur_wchain_error_string.argtypes = [ctypes.c_int]
    lib.schur_wchain_error_string.restype = ctypes.c_char_p
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _launch(W, V_inv, x, cam_idx, pt_idx, buckets):
    O, PC = W.shape[0], W.shape[1]
    if W.dtype not in _DTYPE_CODE:
        raise TypeError(f"schur_wchain kernel takes float32/float64, got {W.dtype}")
    for name, t in (("V_inv", V_inv), ("x", x)):
        if t.dtype != W.dtype:
            raise TypeError(f"{name} is {t.dtype}, W is {W.dtype}")
    for name, t in (("cam_idx", cam_idx), ("pt_idx", pt_idx)):
        if t.dtype != torch.int32 or t.shape != (O,):
            raise TypeError(f"{name} must be int32 [{O}], got {t.dtype} {tuple(t.shape)}")
    if W.shape[2] != 3 or not 1 <= PC <= MAX_PC:
        raise ValueError(f"W must be [O, PC<= {MAX_PC}, 3], got {tuple(W.shape)}")
    if V_inv.shape[1:] != (3, 3) or x.shape[1] != PC:
        raise ValueError(f"V_inv {tuple(V_inv.shape)} / x {tuple(x.shape)} "
                         f"do not match PC={PC}")
    if any(t.device != W.device for t in (V_inv, x, cam_idx, pt_idx)):
        raise ValueError("schur_wchain inputs live on different devices")
    row_start, rows, log_l, blk_off = launch_table(tuple(buckets))
    if int(rows.sum()) != O:
        raise ValueError(f"buckets cover {int(rows.sum())} rows, W has {O}")

    u = torch.empty((O, PC), dtype=W.dtype, device=W.device)
    lib = _lib()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.schur_wchain_launch(
            _DTYPE_CODE[W.dtype], PC, W.data_ptr(), V_inv.data_ptr(),
            x.data_ptr(), cam_idx.data_ptr(), pt_idx.data_ptr(), u.data_ptr(),
            len(row_start), row_start.ctypes.data, rows.ctypes.data,
            log_l.ctypes.data, blk_off.ctypes.data, stream)
    if err != 0:
        raise RuntimeError("schur_wchain kernel launch failed: "
                           + lib.schur_wchain_error_string(err).decode())
    schur_wchain.launches += 1
    return u


def schur_wchain(W, V_inv, x, cam_idx, pt_idx, buckets):
    """u [O', PC] = W_o V_inv[pt_o] SUM_track(o)(W_kᵀ x[cam_k]).

    CPU tensors: ``schur_wchain_reference``.  CUDA tensors: the CUDA kernel
    (counted in ``schur_wchain.launches``), which requires ``buckets``."""
    if W.device.type == "cpu":
        return schur_wchain_reference(W, V_inv, x, cam_idx, pt_idx, buckets)
    if W.device.type != "cuda":
        raise ValueError(f"schur_wchain: unsupported device {W.device}")
    return _launch(W.contiguous(), V_inv.contiguous(), x.contiguous(),
                   cam_idx.contiguous(), pt_idx.contiguous(), buckets)


schur_wchain.launches = 0
