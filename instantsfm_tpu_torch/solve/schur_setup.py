"""The damped solve's per-row passes on the PCG path (the set-up and
back-substitution kernels).

``block_lm.solve_damped`` eliminates the points before its PCG and
recovers them after it.  For the points' 3x3 blocks V, their gradients
g_pt and the per-row camera-point blocks W [O', PC, 3]:

* set-up, before the PCG: V_inv = (V + diag(lam diag(V) + eps))^-1 (the
  closed-form adjugate, 0 where |det| < 1e-30) and the camera sums
  dc [C, PC*PC + PC] of W_o V_inv Wᵀ_o (row-major; the block-Jacobi
  preconditioner's Schur diagonal) and of W_o V_inv g_pt (the right-hand
  side's correction);
* back-substitution, after it: d_pt = V_inv (g_pt - SUM_track Wᵀ d_cam[cam]).

``setup`` and ``backsub`` dispatch on their inputs, as ``schur_wchain``
does: where ``covers`` holds (CUDA tensors of float32 or float64, the
bucketed track layout, PC <= ``schur_wchain.MAX_PC``) each is one launch
of a hand-written kernel in ``csrc/schur_setup.cu`` (built with nvcc on
first use, launched on the current stream), counted in ``LAUNCHES``;
anywhere else (the CPU, no buckets, wider camera blocks) its plain torch
version, ``setup_reference`` or ``backsub_reference``.  The kernel reads
the damping ``lam`` from device memory: the host never reads it.  A kernel
that fails to build or launch raises.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from instantsfm_tpu_torch.solve.blocked import gather_pt, seg_by_pt
from instantsfm_tpu_torch.solve.schur_wchain import (MAX_PC,
                                                     SHARED_TABLE_BYTES,
                                                     tiled_table)
from instantsfm_tpu_torch.utils import build as _build

# the kernels' launches on CUDA tensors
LAUNCHES = {"setup": 0, "backsub": 0}
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


# ------------------------------------------------------------ plain torch

def _mv(M, v):
    """Batched M @ v as mul-sum: [..., i, j], [..., j] -> [..., i]."""
    return torch.sum(M * v[..., None, :], dim=-1)


def _mtv(M, v):
    """Batched Mᵀ @ v as mul-sum: [..., i, j], [..., i] -> [..., j]."""
    return torch.sum(M * v[..., :, None], dim=-2)


def _damped(M, lam, eps):
    """JᵀJ block + lam * diag(JᵀJ) + eps * I (multiplicative LM damping)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    return M + eye * (lam * d + eps)[..., :, None]


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate / det); 0 where det ~ 0."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    Cf = d * h - e * g
    det = a * A + b * B + c * Cf
    inv_det = torch.where(torch.abs(det) < 1e-30, torch.zeros_like(det),
                          1.0 / det)
    adj = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        Cf, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(M.shape)
    return adj * inv_det[..., None, None]


def _seg_by_cam(x, cam_idx, C):
    """Camera-indexed sum [O, ...] -> [C, ...] (atomics on CUDA: the order of
    the additions changes from run to run)."""
    return x.new_zeros((C,) + tuple(x.shape[1:])).index_add_(0, cam_idx, x)


def _seg_by_pt(x, pt_idx, T, buckets):
    """Point-indexed sum: bucketed reshape-sums, or a segment sum."""
    if buckets:
        return seg_by_pt(x, buckets, T)
    return x.new_zeros((T,) + tuple(x.shape[1:])).index_add_(0, pt_idx, x)


def _gather_by_pt(arr, pt_idx, buckets, O):
    """Point-indexed gather: broadcast per bucket, or plain gather."""
    if buckets:
        return gather_pt(arr, buckets, O)
    return arr[pt_idx]


def camera_sums_reference(V_inv, g_pt, W, cam_idx, pt_idx, buckets, C):
    """dc [C, PC*PC + PC]: the camera sums of W V_inv Wᵀ row-major, then of
    W V_inv g_pt, over this process's rows."""
    PC = W.shape[1]
    O = W.shape[0]
    rhs_o = _mv(W, _gather_by_pt(_mv(V_inv, g_pt), pt_idx, buckets, O))
    Vg = _gather_by_pt(V_inv, pt_idx, buckets, O)                 # [O, 3, 3]
    WVi = torch.sum(W[:, :, :, None] * Vg[:, None, :, :], dim=2)
    D_corr = torch.sum(WVi[:, :, None, :] * W[:, None, :, :], -1)
    return _seg_by_cam(torch.cat([D_corr.reshape(O, PC * PC), rhs_o], 1),
                       cam_idx, C)


def setup_reference(V, g_pt, W, lam, eps, cam_idx, pt_idx, buckets, C):
    """Plain version of the set-up: (V_inv [T, 3, 3] of the damped V, its
    ``camera_sums_reference`` dc)."""
    V_inv = _inv3x3(_damped(V, lam, eps))
    return V_inv, camera_sums_reference(V_inv, g_pt, W, cam_idx, pt_idx,
                                        buckets, C)


def backsub_reference(W, V_inv, g_pt, d_cam, cam_idx, pt_idx, buckets):
    """Plain version of the back-substitution: d_pt [T, 3] = V_inv (g_pt -
    SUM_track Wᵀ d_cam[cam])."""
    T = V_inv.shape[0]
    wtd = _seg_by_pt(_mtv(W, d_cam[cam_idx]), pt_idx, T, buckets)
    return _mv(V_inv, g_pt - wtd)


# ------------------------------------------------------------ the kernels

def covers(W, buckets) -> bool:
    """Whether ``setup`` and ``backsub`` launch the kernels: W on a CUDA
    device in float32 or float64, the bucketed layout, PC <= MAX_PC."""
    return (W.device.type == "cuda" and bool(buckets)
            and W.shape[1] <= MAX_PC and W.dtype in _DTYPE_CODE)


def shared_table(C, PC, dtype) -> bool:
    """Whether the set-up kernel sums cameras in a shared-memory table (else
    each row adds to dc with global atomics).  The table is everything a
    set-up block keeps in shared memory: the upper triangle of W V_inv Wᵀ
    and W V_inv g_pt, PC (PC + 1) / 2 + PC entries a camera packed in
    16-byte words, within K1's 96 KB (``schur_wchain.SHARED_TABLE_BYTES``).
    At PC = 8 that is C <= 558 in float32 and 279 in float64."""
    size = torch.finfo(dtype).bits // 8
    words = -(-(PC * (PC + 1) // 2 + PC) // (16 // size))
    return C * words * 16 <= SHARED_TABLE_BYTES


def backsub_shared(C, PC, dtype) -> bool:
    """Whether the back-substitution kernel copies d_cam into shared memory
    (else it reads d_cam through L1): the copy, with the warp sums' 8 x 3
    entries beside it, within K1's 96 KB.  At PC = 8 that is C <= 3,069 in
    float32."""
    size = torch.finfo(dtype).bits // 8
    return 16 * -(-C * PC * size // 16) + 24 * size <= SHARED_TABLE_BYTES


@lru_cache(maxsize=None)
def _lib():
    """The kernels' library (built on first use) with its C signatures."""
    lib = _build.load("schur_setup")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    table = [i, p, p, p, p, p]    # nb, row_start, rows, pt_start, log_l, item_off
    lib.schur_setup_launch.argtypes = [
        i, i, i,                  # dtype code, PC, shared table (0/1)
        p, p, p, p, p, d,         # V, g_pt, W, cam_idx, lam, eps
        p, p, i,                  # V_inv, dc, cameras C
        *table, p]                # the bucket table, stream
    lib.schur_backsub_launch.argtypes = [
        i, i, i,                  # dtype code, PC, d_cam in shared memory
        p, p, p, p, p, p, i,      # W, cam_idx, V_inv, g_pt, d_cam, d_pt, C
        *table, p]                # the bucket table, stream
    lib.schur_setup_launch.restype = ctypes.c_int
    lib.schur_backsub_launch.restype = ctypes.c_int
    lib.schur_setup_error_string.argtypes = [ctypes.c_int]
    lib.schur_setup_error_string.restype = ctypes.c_char_p
    return lib


def _layout(W, cam_idx, buckets, T):
    """The launch table of ``buckets`` (``schur_wchain.tiled_table``: they
    cover W's rows and tile the T point slots), checked against W
    [O', PC, 3] and cam_idx."""
    O, PC = W.shape[0], W.shape[1]
    if W.dtype not in _DTYPE_CODE:
        raise TypeError(f"schur_setup kernels take float32/float64, got "
                        f"{W.dtype}")
    if W.dim() != 3 or W.shape[2] != 3 or not 1 <= PC <= MAX_PC:
        raise ValueError(f"W must be [O, PC<= {MAX_PC}, 3], got "
                         f"{tuple(W.shape)}")
    if cam_idx.dtype != torch.int32 or tuple(cam_idx.shape) != (O,):
        raise TypeError(f"cam_idx must be int32 [{O}], got {cam_idx.dtype} "
                        f"{tuple(cam_idx.shape)}")
    if W.data_ptr() % 16:
        raise ValueError("W must start on 16 bytes: the kernels read its rows "
                         "with 16-byte loads")
    return tiled_table(buckets, O, T)


def _check(err):
    if err != 0:
        raise RuntimeError("schur_setup kernel launch failed: "
                           + _lib().schur_setup_error_string(err).decode())


def _same_device(W, *tensors):
    if any(t.device != W.device for t in tensors):
        raise ValueError("schur_setup inputs live on different devices")


def _launch_setup(V, g_pt, W, lam, eps, cam_idx, buckets, C):
    T, PC, dt = V.shape[0], W.shape[1], W.dtype
    row_start, rows, pt_start, log_l, item_off = _layout(W, cam_idx, buckets,
                                                         T)
    lam = torch.as_tensor(lam, dtype=dt, device=W.device).reshape(())
    if tuple(V.shape) != (T, 3, 3) or tuple(g_pt.shape) != (T, 3):
        raise ValueError(f"V {tuple(V.shape)} / g_pt {tuple(g_pt.shape)} do "
                         f"not hold {T} points")
    for name, t in (("V", V), ("g_pt", g_pt)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, W is {dt}")
    _same_device(W, V, g_pt, cam_idx)
    V_inv = torch.empty((T, 3, 3), dtype=dt, device=W.device)
    dc = torch.empty((C, PC * PC + PC), dtype=dt, device=W.device)
    with torch.cuda.device(W.device):
        _check(_lib().schur_setup_launch(
            _DTYPE_CODE[dt], PC, int(shared_table(C, PC, dt)), V.data_ptr(),
            g_pt.data_ptr(), W.data_ptr(), cam_idx.data_ptr(), lam.data_ptr(),
            float(eps), V_inv.data_ptr(), dc.data_ptr(), C, len(row_start),
            row_start.ctypes.data, rows.ctypes.data, pt_start.ctypes.data,
            log_l.ctypes.data, item_off.ctypes.data,
            torch.cuda.current_stream(W.device).cuda_stream))
    LAUNCHES["setup"] += 1
    return V_inv, dc


def _launch_backsub(W, V_inv, g_pt, d_cam, cam_idx, buckets):
    T, PC, dt = V_inv.shape[0], W.shape[1], W.dtype
    C = d_cam.shape[0]
    row_start, rows, pt_start, log_l, item_off = _layout(W, cam_idx, buckets,
                                                         T)
    if tuple(V_inv.shape) != (T, 3, 3) or tuple(g_pt.shape) != (T, 3) \
            or tuple(d_cam.shape) != (C, PC) or C < 1:
        raise ValueError(f"V_inv {tuple(V_inv.shape)} / g_pt "
                         f"{tuple(g_pt.shape)} / d_cam {tuple(d_cam.shape)} "
                         f"do not match PC={PC}")
    for name, t in (("V_inv", V_inv), ("g_pt", g_pt), ("d_cam", d_cam)):
        if t.dtype != dt:
            raise TypeError(f"{name} is {t.dtype}, W is {dt}")
    _same_device(W, V_inv, g_pt, d_cam, cam_idx)
    d_pt = torch.empty((T, 3), dtype=dt, device=W.device)
    with torch.cuda.device(W.device):
        _check(_lib().schur_backsub_launch(
            _DTYPE_CODE[dt], PC, int(backsub_shared(C, PC, dt)),
            W.data_ptr(), cam_idx.data_ptr(), V_inv.data_ptr(),
            g_pt.data_ptr(), d_cam.data_ptr(), d_pt.data_ptr(), C,
            len(row_start), row_start.ctypes.data, rows.ctypes.data,
            pt_start.ctypes.data, log_l.ctypes.data, item_off.ctypes.data,
            torch.cuda.current_stream(W.device).cuda_stream))
    LAUNCHES["backsub"] += 1
    return d_pt


def setup(V, g_pt, W, lam, eps, cam_idx, pt_idx, buckets, C):
    """(V_inv, dc) of ``setup_reference``: one kernel launch (counted in
    ``LAUNCHES["setup"]``) where ``covers`` holds, which reads each row's
    point slot from ``buckets`` (``pt_idx`` is not read), else the plain
    version."""
    if not covers(W, buckets):
        return setup_reference(V, g_pt, W, lam, eps, cam_idx, pt_idx, buckets,
                               C)
    return _launch_setup(V.contiguous(), g_pt.contiguous(), W.contiguous(),
                         lam, eps, cam_idx.contiguous(), buckets, C)


def backsub(W, V_inv, g_pt, d_cam, cam_idx, pt_idx, buckets):
    """d_pt of ``backsub_reference``: one kernel launch (counted in
    ``LAUNCHES["backsub"]``) where ``covers`` holds, else the plain
    version."""
    if not covers(W, buckets):
        return backsub_reference(W, V_inv, g_pt, d_cam, cam_idx, pt_idx,
                                 buckets)
    return _launch_backsub(W.contiguous(), V_inv.contiguous(),
                           g_pt.contiguous(), d_cam.contiguous(),
                           cam_idx.contiguous(), buckets)
