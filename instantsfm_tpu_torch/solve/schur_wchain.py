"""Observation side of the reduced-camera Schur matvec (kernel K1).

Replaces ``instantsfm_tpu/solve/pallas_schur.py::schur_wchain`` together
with the camera-side sum its caller applies (``seg_cam`` at
``instantsfm_tpu/solve/block_lm.py:898-904``).  Every PCG iteration of BA
(camera block PC=8) and GP (PC=3) applies

    S x = U_d x - y,    y[c] = SUM_{o: cam_o = c} u_o,
    u_o = W_o V_inv[pt_o] SUM_track(o) W_kᵀ x[cam_k]

and this module computes y [C, PC] for the bucketed track layout
(``solve/blocked.py``): the observations of one track are an aligned group
of L = 2**k rows.

``schur_wchain`` dispatches on the device of its inputs: CPU tensors go to
``schur_wchain_reference`` (plain torch: the per-row chain
``schur_wchain_rows_reference``, then ``index_add_`` by camera), CUDA
tensors to the hand-written kernel in ``csrc/schur_wchain.cu`` (built with
nvcc on first use, launched on the current stream), which never writes u.
The kernel takes camera blocks of PC <= 8 (``MAX_PC``); wider blocks on the
card (PC 9-16: RADIAL, FOV, OPENCV, FULL_OPENCV and the fisheyes in BA) go
to the plain version, as the JAX package calls its Pallas kernel only at
PC <= 8 and its XLA chain otherwise (``instantsfm_tpu/solve/block_lm.py``
:881-890).  That is a width rule, not a fallback: a kernel that fails to
build or launch raises.
"""

from __future__ import annotations

import ctypes
from contextlib import contextmanager
from functools import lru_cache

import numpy as np
import torch

from instantsfm_tpu_torch.solve.blocked import gather_pt, seg_by_pt
from instantsfm_tpu_torch.utils import build

BLOCK = 256       # threads per block and rows per work item (csrc/schur_wchain.cu)
MAX_BUCKETS = 32  # bucket-table capacity (csrc/schur_wchain.cu)
# most shared memory the kernel's camera table may take (see shared_table)
SHARED_TABLE_BYTES = 96 * 1024
MAX_PC = 8


def schur_wchain_rows_reference(W, V_inv, x, cam_idx, pt_idx, buckets):
    """Plain torch per-row chain: gather x[cam], t = Wᵀ x, track sums
    (bucketed reshape-sums, or a segment sum without buckets), z = V_inv s,
    u = W z.  Returns u [O', PC].

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


def schur_wchain_reference(W, V_inv, x, cam_idx, pt_idx, buckets):
    """Plain torch version of the kernel: the per-row chain, then its sum by
    camera (``index_add_``).  Returns y [C, PC]."""
    u = schur_wchain_rows_reference(W, V_inv, x, cam_idx, pt_idx, buckets)
    return u.new_zeros(x.shape).index_add_(0, cam_idx, u)


def shared_table(C, PC, dtype) -> bool:
    """Whether the kernel sums cameras in a shared-memory table (else it adds
    each row's u to y with global atomics); the wrapper passes this to the
    launcher.

    The table is the accumulator, each camera's PC entries padded to 16-byte
    words, and a copy of x: at most 96 KB, which leaves room for the staging
    buffers (at most 127,040 B, float64 at PC = 8) under the card's 227 KB a
    block.  At PC = 8 that is C <= 1,536 in float32 and 768 in float64."""
    size = torch.finfo(dtype).bits // 8
    per_cam = 16 * -(-PC * size // 16) + PC * size
    return C * per_cam <= SHARED_TABLE_BYTES


@lru_cache(maxsize=64)
def launch_table(buckets):
    """Per-bucket work items of the kernel, as int64 host arrays:
    (row_start, rows, pt_start, log_l, item_off).

    A bucket with L <= BLOCK has one item per BLOCK rows (each holds whole
    groups); a bucket with L > BLOCK one item per group.  Item i of the
    flat list belongs to bucket b where item_off[b] <= i < item_off[b+1].
    """
    if not buckets:
        raise ValueError("schur_wchain kernel needs the bucketed track layout "
                         "(solve.blocked.bucketize_problem)")
    if len(buckets) > MAX_BUCKETS:
        raise ValueError(f"{len(buckets)} buckets > MAX_BUCKETS={MAX_BUCKETS}")
    row_start, rows, pt_start, log_l, item_off = [], [], [], [], [0]
    for (os_, ps, Tb, L) in buckets:
        if L < 2 or L & (L - 1):
            raise ValueError(f"bucket length {L} is not a power of two >= 2")
        span = Tb * L
        row_start.append(os_)
        rows.append(span)
        pt_start.append(ps)
        log_l.append(L.bit_length() - 1)
        item_off.append(item_off[-1] + -(-span // max(BLOCK, L)))
    return tuple(np.asarray(a, np.int64)
                 for a in (row_start, rows, pt_start, log_l, item_off))


def tiled_table(buckets, rows, slots):
    """``launch_table(buckets)``, checked to cover ``rows`` rows and to tile
    the point slots [0, ``slots``) in order, as ``blocked.seg_by_pt``'s
    concatenation does: a kernel that writes each point slot once (the BA
    build, the solve's set-up and back-substitution) needs both."""
    table = launch_table(tuple(buckets))
    if int(table[1].sum()) != rows:
        raise ValueError(f"buckets cover {int(table[1].sum())} rows, the "
                         f"inputs have {rows}")
    ends = np.cumsum([Tb for (_, _, Tb, _) in buckets])
    if list(table[2]) != [0, *ends[:-1]] or ends[-1] != slots:
        raise ValueError("the buckets' point slots do not tile the "
                         f"{slots} point slots in order")
    return table


@lru_cache(maxsize=None)
def _lib():
    """The kernel's library (built on first use) with its C signatures."""
    lib = build.load("schur_wchain")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.schur_wchain_launch.argtypes = [
        i, i, i,                  # dtype code, PC, shared table (0/1)
        p, p, p, p, p,            # W, V_inv, x, cam_idx, y
        ll, ll, i,                # rows O', point slots T, cameras C
        i, p, p, p, p, p,         # nb, row_start, rows, pt_start, log_l, item_off
        p]                        # stream
    lib.schur_wchain_launch.restype = ctypes.c_int
    lib.schur_wchain_error_string.argtypes = [ctypes.c_int]
    lib.schur_wchain_error_string.restype = ctypes.c_char_p
    return lib


_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def _launch(W, V_inv, x, cam_idx, buckets):
    O, PC = W.shape[0], W.shape[1]
    C = x.shape[0]
    if W.dtype not in _DTYPE_CODE:
        raise TypeError(f"schur_wchain kernel takes float32/float64, got {W.dtype}")
    for name, t in (("V_inv", V_inv), ("x", x)):
        if t.dtype != W.dtype:
            raise TypeError(f"{name} is {t.dtype}, W is {W.dtype}")
    if cam_idx.dtype != torch.int32 or cam_idx.shape != (O,):
        raise TypeError(f"cam_idx must be int32 [{O}], got {cam_idx.dtype} "
                        f"{tuple(cam_idx.shape)}")
    if W.dim() != 3 or W.shape[2] != 3 or not 1 <= PC <= MAX_PC:
        raise ValueError(f"W must be [O, PC<= {MAX_PC}, 3], got {tuple(W.shape)}")
    if V_inv.shape[1:] != (3, 3) or x.shape != (C, PC) or C < 1:
        raise ValueError(f"V_inv {tuple(V_inv.shape)} / x {tuple(x.shape)} "
                         f"do not match PC={PC}")
    if any(t.device != W.device for t in (V_inv, x, cam_idx)):
        raise ValueError("schur_wchain inputs live on different devices")
    for name, t in (("W", W), ("V_inv", V_inv), ("cam_idx", cam_idx)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes: the kernel "
                             "stages it with 16-byte copies")
    row_start, rows, pt_start, log_l, item_off = launch_table(tuple(buckets))
    if int(rows.sum()) != O:
        raise ValueError(f"buckets cover {int(rows.sum())} rows, W has {O}")
    slots = max(ps + Tb for (_, ps, Tb, _) in buckets)
    if slots > V_inv.shape[0]:
        raise ValueError(f"buckets reach point slot {slots}, V_inv has "
                         f"{V_inv.shape[0]}")

    y = torch.empty((C, PC), dtype=W.dtype, device=W.device)
    lib = _lib()
    with torch.cuda.device(W.device):
        stream = torch.cuda.current_stream(W.device).cuda_stream
        err = lib.schur_wchain_launch(
            _DTYPE_CODE[W.dtype], PC, int(shared_table(C, PC, W.dtype)),
            W.data_ptr(), V_inv.data_ptr(), x.data_ptr(), cam_idx.data_ptr(),
            y.data_ptr(), O, V_inv.shape[0], C, len(row_start),
            row_start.ctypes.data, rows.ctypes.data, pt_start.ctypes.data,
            log_l.ctypes.data, item_off.ctypes.data, stream)
    if err != 0:
        raise RuntimeError("schur_wchain kernel launch failed: "
                           + lib.schur_wchain_error_string(err).decode())
    _count("launches")
    return y


def schur_wchain(W, V_inv, x, cam_idx, pt_idx, buckets):
    """y [C, PC] = SUM by camera of u_o = W_o V_inv[pt_o] SUM_track(o)(W_kᵀ
    x[cam_k]).

    CPU tensors: ``schur_wchain_reference``.  CUDA tensors with PC <= 8:
    the CUDA kernel (counted in ``schur_wchain.launches``), which requires
    ``buckets`` and finds each row's point slot from them (``pt_idx`` is
    not read).  CUDA tensors with PC > 8: ``schur_wchain_reference`` on the
    card, counted in ``schur_wchain.plain_calls``.  A call that a CUDA graph
    records is counted at each replay (``recorded``)."""
    if W.device.type == "cpu":
        return schur_wchain_reference(W, V_inv, x, cam_idx, pt_idx, buckets)
    if W.device.type != "cuda":
        raise ValueError(f"schur_wchain: unsupported device {W.device}")
    if W.shape[1] > MAX_PC:
        _count("plain_calls")
        return schur_wchain_reference(W, V_inv, x, cam_idx, pt_idx, buckets)
    return _launch(W.contiguous(), V_inv.contiguous(), x.contiguous(),
                   cam_idx.contiguous(), buckets)


schur_wchain.launches = 0      # kernel launches run
schur_wchain.plain_calls = 0   # PC > 8 on the card: the plain version

# calls recorded into CUDA graphs, by counter: ``recorded`` turns them into
# runs at each replay
_captured = dict(launches=0, plain_calls=0)


def _count(name: str) -> None:
    if torch.cuda.is_current_stream_capturing():
        _captured[name] += 1
    else:
        setattr(schur_wchain, name, getattr(schur_wchain, name) + 1)


@contextmanager
def recorded():
    """Around a CUDA graph's capture: yields ``replayed()``, which adds
    the calls the capture recorded to ``schur_wchain.launches`` and
    ``plain_calls``.  The graph's owner calls it after each replay, which
    runs them again."""
    start, n = dict(_captured), {}

    def replayed():
        for name, k in n.items():
            setattr(schur_wchain, name, getattr(schur_wchain, name) + k)

    yield replayed
    n.update((name, _captured[name] - start[name]) for name in _captured)
