"""3DGS tile compositing, forward (kernel K2) and backward (kernel K3).

Replaces ``instantsfm_tpu/gs/pallas_raster.py`` (``composite_tiles`` with
``_fwd_kernel`` and ``_bwd_kernel``).  Each 16x16 tile holds its
depth-sorted gaussians as packed 16-wide attribute rows; the forward
composites them front to back in 128-row chunks, in log-transmittance, and
stops at chunk granularity once every pixel of the tile has T < 1e-4 or the
tile's chunk count is reached.  It also returns the entry log T of every
chunk it entered (``NOT_RUN`` for the others), which the backward uses to
walk the same chunks back to front.

``composite_fwd`` and ``composite_bwd`` dispatch on the device of their
inputs: CPU tensors go to the plain torch versions
(``composite_fwd_reference``, ``composite_bwd_reference``), which compute
the same chunked function with the same early exit; CUDA tensors go to the
hand-written kernels in ``csrc/composite_tiles.cu`` (built with nvcc on
first use, launched on the current stream, counted in ``.launches``).
There is no fallback between the two.  ``composite_tiles`` binds them as a
``torch.autograd.Function``.

The kernels skip, per warp of 16x2 pixels, the rows whose alpha is zero at
every pixel of the warp, by a box test (``cull_boxes`` mirrors the record
they compute; only tests and measurements call it).  The skipped pairs have
alpha = 0, so the kernels compute the same function as the plain versions.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from instantsfm_tpu_torch.utils import build

TILE = 16
P = TILE * TILE
CHUNK = 128      # rows per chunk (must match csrc/composite_tiles.cu)
ATTR = 16        # packed attribute width (must match csrc/composite_tiles.cu)

# attribute columns: screen mean, conic (a, b, c), rgb, opacity, depth
MX, MY, CA, CB, CC, CR, CG, CB2, OP, DE = range(10)

MIN_ALPHA = 1.0 / 255.0
MAX_ALPHA = 0.999
LOG_EPS_T = float(np.log(1e-4))   # all-pixel saturation exit
NOT_RUN = -1e30                   # logt of chunks the forward never entered


def pack_attrs(means2d, conics, colors, opac, depths):
    """Per-gaussian [G,*] components -> packed [G+1, ATTR] float32 table;
    row G is the all-zero sentinel for empty tile slots (opacity 0: no
    contribution, no gradient)."""
    G = opac.shape[0]
    f32 = lambda a: a.to(torch.float32)
    table = torch.cat([
        f32(means2d), f32(conics), f32(colors), f32(opac)[:, None],
        f32(depths)[:, None],
        torch.zeros((G, ATTR - 10), dtype=torch.float32, device=opac.device)],
        dim=-1)
    return torch.cat([table, torch.zeros((1, ATTR), dtype=torch.float32,
                                         device=opac.device)], dim=0)


def pixel_coords(n_tiles, ntx, device):
    """Pixel centres [n_tiles, 1, P] (x, y) of each tile."""
    t = torch.arange(n_tiles, device=device)
    lin = torch.arange(P, device=device)
    ox = ((t % ntx) * TILE).to(torch.float32)[:, None, None]
    oy = ((t // ntx) * TILE).to(torch.float32)[:, None, None]
    px = (lin % TILE).to(torch.float32)[None, None, :] + ox + 0.5
    py = (lin // TILE).to(torch.float32)[None, None, :] + oy + 0.5
    return px, py


def alpha_terms(a, px, py):
    """a [m, C, ATTR] rows, px/py [m, 1, P] -> (alpha, grad_live, e, dx, dy),
    each [m, C, P]: alpha = min(opac e, 0.999) with e = exp(-sigma/2),
    zeroed unless sigma > 0 and alpha > 1/255; grad_live also needs
    opac e < 0.999 (the clip passes no gradient)."""
    dx = a[..., MX:MX + 1] - px
    dy = a[..., MY:MY + 1] - py
    sigma = (a[..., CA:CA + 1] * dx * dx + 2.0 * a[..., CB:CB + 1] * dx * dy
             + a[..., CC:CC + 1] * dy * dy)
    e = torch.exp(-0.5 * sigma)
    raw = a[..., OP:OP + 1] * e
    clipped = torch.clamp(raw, max=MAX_ALPHA)
    live = (sigma > 0) & (clipped > MIN_ALPHA)
    alpha = torch.where(live, clipped, torch.zeros_like(clipped))
    return alpha, live & (raw < MAX_ALPHA), e, dx, dy


# The cull's margins (csrc/composite_tiles.cu CULL_*): rows with
# det > CULL_TAU (a + c)^2 get a box, the alpha threshold's sigma is widened
# to s * CULL_S_REL + CULL_S_ABS, the half-extents to
# h * CULL_H_REL + CULL_H_ABS + CULL_M_REL |mean|.
CULL_TAU = 1e-4
CULL_S_REL, CULL_S_ABS = 1.02, 0.02
CULL_H_REL, CULL_H_ABS, CULL_M_REL = 1.001, 1e-3, 1e-6
NWARP = P // 32


def cull_boxes(a):
    """a [..., ATTR] float32 rows -> [..., 4] float32 (x lo, x hi, y lo, y hi):
    the box of pixel centres where the row's alpha can exceed 1/255, as the
    kernels compute it (``cull_box`` in csrc/composite_tiles.cu, the same
    formula, order and margins).  Nothing on the render path calls it.

    alpha > 1/255 needs opacity e > 1/255, i.e. sigma < s = 2 ln(255 op);
    the region {d : d^T C d < s} has half-extents sqrt(s c / det) in x and
    sqrt(s a / det) in y (det = ac - b^2).  Why the margins make the box
    hold every pair whose float32 ``alpha_terms`` give alpha > 0: with
    det > 1e-4 (a + c)^2 the float32 sigma is within 0.72% of the exact
    quadratic form (its rounding is below 2.4e-7 (a dx^2 + 2|b dx dy| +
    c dy^2), at most 2 (a + c)^2 / det = 2e4 times the form, and the
    rounded offsets add as much again), det itself within 0.06%, and
    exp, log and the opacity product within a few ulp: widening s by 2% +
    0.02 covers all of it.  The box's own float edges are within
    2^-24 (|mean| + h) of exact, below the 1e-3 + 1e-6 |mean| + 0.1% h added.

    Rules: a row with op <= 1/255 is never live (an empty box, +inf..-inf);
    a row whose conic is not positive definite, fails the det test, or whose
    box is not finite is always evaluated (-inf..+inf)."""
    mx, my, ca, cb, cc, op = (a[..., i] for i in (MX, MY, CA, CB, CC, OP))
    det = ca * cc - cb * cb
    tr = ca + cc
    s = 2.0 * torch.log(255.0 * op)
    sw = s * CULL_S_REL + CULL_S_ABS
    hx = (torch.sqrt(sw * cc / det) * CULL_H_REL + CULL_H_ABS
          + mx.abs() * CULL_M_REL)
    hy = (torch.sqrt(sw * ca / det) * CULL_H_REL + CULL_H_ABS
          + my.abs() * CULL_M_REL)
    box = torch.stack([mx - hx, mx + hx, my - hy, my + hy], dim=-1)
    inf = float("inf")
    bounded = ((ca > 0) & (det > CULL_TAU * (tr * tr))
               & torch.isfinite(box).all(dim=-1))
    box = torch.where(bounded[..., None], box, box.new_tensor([-inf, inf,
                                                               -inf, inf]))
    return torch.where((op <= MIN_ALPHA)[..., None],
                       box.new_tensor([inf, -inf, inf, -inf]), box)


def cull_rows(attrs, ntx: int):
    """attrs [n, K, ATTR] -> bool [n, K, NWARP]: the (row, warp) pairs the
    kernels walk, i.e. whose box meets the warp's 16x2 rectangle of pixel
    centres (warp w holds the tile's pixel rows 2w and 2w + 1)."""
    n = attrs.shape[0]
    box = cull_boxes(attrs)[:, :, None, :]                    # [n, K, 1, 4]
    t = torch.arange(n, device=attrs.device)
    w = torch.arange(NWARP, device=attrs.device)
    x0 = ((t % ntx) * TILE).to(torch.float32)[:, None, None] + 0.5
    y0 = (((t // ntx) * TILE)[:, None] + 2 * w[None, :]).to(
        torch.float32)[:, None, :] + 0.5                     # [n, 1, NWARP]
    return ~((box[..., 1] < x0) | (box[..., 0] > x0 + 15.0)
             | (box[..., 3] < y0) | (box[..., 2] > y0 + 1.0))


def entered(logt):
    """[n, K/CHUNK] bool: the chunks K2's walk entered."""
    return logt.amax(dim=2) > 0.5 * NOT_RUN


def pair_counts(attrs, logt, ntx: int, batch: int = 256):
    """What the reference compositing does on these inputs, read from the
    forward's log T: the chunks its walk entered, the (gaussian, pixel)
    pairs in them and the live pairs among those (alpha past the
    thresholds).  Only measurements call it: the benchmark's
    ``sfmbench/units/gs_steps.py``, ``chip_smoke.py`` and
    ``bench_gs_torch.py``."""
    t_idx, c_idx = entered(logt).nonzero(as_tuple=True)
    px, py = pixel_coords(attrs.shape[0], ntx, attrs.device)
    rows = torch.arange(CHUNK, device=attrs.device)
    live = 0
    for lo in range(0, len(t_idx), batch):
        t, c = t_idx[lo:lo + batch], c_idx[lo:lo + batch]
        r = c[:, None] * CHUNK + rows[None, :]
        live += int((alpha_terms(attrs[t[:, None], r], px[t], py[t])[0]
                     > 0).sum())
    return dict(chunks_entered=len(t_idx), pairs=len(t_idx) * CHUNK * P,
                live_pairs=live)


def _exclusive_cumsum(x):
    """Exclusive prefix sum along dim 1."""
    return torch.cat([torch.zeros_like(x[:, :1]),
                      torch.cumsum(x[:, :-1], dim=1)], dim=1)


def composite_fwd_reference(attrs, nchunks, ntx: int):
    """Plain torch version of K2.  attrs [n, K, ATTR] f32, nchunks [n] int
    -> (out [n, 8, P]: rgb, 1 - T, depth, three zero rows; logt
    [n, K/CHUNK, P]: entry log T per entered chunk, NOT_RUN elsewhere).
    Every chunk is evaluated for every tile and masked by the walk's state,
    so the host never waits on the device."""
    n, K, _ = attrs.shape
    maxc = K // CHUNK
    dev = attrs.device
    px, py = pixel_coords(n, ntx, dev)
    nc = nchunks.to(torch.int64)
    logT = torch.zeros((n, 1, P), dtype=torch.float32, device=dev)
    rgb = torch.zeros((n, 3, P), dtype=torch.float32, device=dev)
    dep = torch.zeros((n, 1, P), dtype=torch.float32, device=dev)
    logts = []
    for ci in range(maxc):
        run = ((ci < nc) & (logT.amax(dim=(1, 2)) > LOG_EPS_T))[:, None, None]
        a = attrs[:, ci * CHUNK:(ci + 1) * CHUNK]             # [n, C, ATTR]
        logts.append(torch.where(run[:, 0], logT[:, 0], NOT_RUN))
        alpha = alpha_terms(a, px, py)[0]
        lom = torch.log1p(-alpha)
        w = torch.exp(logT + _exclusive_cumsum(lom)) * alpha  # [n, C, P]
        rgb = torch.where(run, rgb + torch.einsum("ncp,nck->nkp", w,
                                                  a[..., CR:CR + 3]), rgb)
        dep = torch.where(run, dep + torch.sum(w * a[..., DE:DE + 1], dim=1,
                                               keepdim=True), dep)
        logT = torch.where(run, logT + torch.sum(lom, dim=1, keepdim=True),
                           logT)
    out = torch.cat([rgb, 1.0 - torch.exp(logT), dep,
                     torch.zeros((n, 3, P), dtype=torch.float32, device=dev)],
                    dim=1)
    return out, torch.stack(logts, dim=1)


def composite_bwd_reference(attrs, logt, gout, ntx: int):
    """Plain torch version of K3.  gout [n, 8, P] (rows 0..2 d rgb, 3 d
    alpha, 4 d depth) -> g_attrs [n, K, ATTR] (columns 0..9; rows of chunks
    the forward never entered are zero).  Masked like the forward."""
    n, K, _ = attrs.shape
    maxc = K // CHUNK
    dev = attrs.device
    px, py = pixel_coords(n, ntx, dev)
    g_rgb, g_alp, g_dep = gout[:, 0:3], gout[:, 3:4], gout[:, 4:5]
    entered = (logt.amax(dim=2) > 0.5 * NOT_RUN)[:, :, None, None]
    S = torch.zeros((n, 1, P), dtype=torch.float32, device=dev)
    chunks = []
    for ci in reversed(range(maxc)):
        run = entered[:, ci]
        a = attrs[:, ci * CHUNK:(ci + 1) * CHUNK]
        alpha, grad_live, e, dx, dy = alpha_terms(a, px, py)
        lom = torch.log1p(-alpha)
        T = torch.exp(torch.where(run, logt[:, ci][:, None, :], NOT_RUN)
                      + _exclusive_cumsum(lom))
        w = T * alpha
        g_w = (torch.einsum("nck,nkp->ncp", a[..., CR:CR + 3], g_rgb)
               + g_alp + a[..., DE:DE + 1] * g_dep)
        wg = w * g_w
        # suffix over later rows of the chunk, plus the later chunks' S
        suf = torch.flip(_exclusive_cumsum(torch.flip(wg, [1])), [1]) + S
        g_a = T * g_w - suf / torch.clamp(1.0 - alpha, min=1e-3)
        g_a = torch.where(grad_live, g_a, torch.zeros_like(g_a))
        g_s = g_a * (-0.5 * a[..., OP:OP + 1] * e)
        ca, cb, cc = a[..., CA:CA + 1], a[..., CB:CB + 1], a[..., CC:CC + 1]
        cols = torch.stack([
            torch.sum(2.0 * g_s * (ca * dx + cb * dy), dim=2),
            torch.sum(2.0 * g_s * (cb * dx + cc * dy), dim=2),
            torch.sum(g_s * dx * dx, dim=2),
            torch.sum(2.0 * g_s * dx * dy, dim=2),
            torch.sum(g_s * dy * dy, dim=2),
            *torch.einsum("ncp,nkp->knc", w, g_rgb).unbind(0),
            torch.sum(g_a * e, dim=2),
            torch.sum(w * g_dep, dim=2),
            *torch.zeros((ATTR - 10, n, CHUNK), dtype=torch.float32,
                         device=dev).unbind(0)], dim=-1)
        chunks.append(torch.where(run[:, :, :1], cols, torch.zeros_like(cols)))
        S = torch.where(run[:, :, :1], S + torch.sum(wg, dim=1, keepdim=True),
                        S)
    return torch.cat(chunks[::-1], dim=1)


# ------------------------------------------------------------ CUDA kernels

@lru_cache(maxsize=None)
def _lib():
    """The kernels' library (built on first use) with its C signatures."""
    lib = build.load("composite_tiles")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.composite_fwd_launch.argtypes = [p, p, i, i, i, p, p, p]
    lib.composite_fwd_launch.restype = i
    lib.composite_bwd_launch.argtypes = [p, p, p, i, i, i, p, p]
    lib.composite_bwd_launch.restype = i
    lib.composite_error_string.argtypes = [i]
    lib.composite_error_string.restype = ctypes.c_char_p
    return lib


def _check_attrs(attrs):
    if attrs.dtype != torch.float32:
        raise TypeError(f"attrs must be float32, got {attrs.dtype}")
    if attrs.dim() != 3 or attrs.shape[2] != ATTR or attrs.shape[1] % CHUNK:
        raise ValueError(f"attrs must be [n_tiles, K % {CHUNK} == 0, {ATTR}], "
                         f"got {tuple(attrs.shape)}")
    if attrs.data_ptr() % 16:
        raise ValueError("attrs must start on a 16-byte boundary (the kernels "
                         "stage it with 16-byte asynchronous copies)")


def _check_rows(name, t, n, rows, device):
    if t.dtype != torch.float32 or tuple(t.shape) != (n, rows, P):
        raise TypeError(f"{name} must be float32 [{n}, {rows}, {P}], got "
                        f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} lives on {t.device}, attrs on {device}")


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + _lib().composite_error_string(err).decode())


def _launch_fwd(attrs, nchunks, ntx):
    _check_attrs(attrs)
    n, K, _ = attrs.shape
    if nchunks.dtype != torch.int32 or tuple(nchunks.shape) != (n,):
        raise TypeError(f"nchunks must be int32 [{n}], got {nchunks.dtype} "
                        f"{tuple(nchunks.shape)}")
    if nchunks.device != attrs.device:
        raise ValueError("composite_fwd inputs live on different devices")
    out = torch.empty((n, 8, P), dtype=torch.float32, device=attrs.device)
    logt = torch.empty((n, K // CHUNK, P), dtype=torch.float32,
                       device=attrs.device)
    lib = _lib()
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream(attrs.device).cuda_stream
        err = lib.composite_fwd_launch(attrs.data_ptr(), nchunks.data_ptr(),
                                       n, K, ntx, out.data_ptr(),
                                       logt.data_ptr(), stream)
    _raise_on(err, "composite_fwd")
    composite_fwd.launches += 1
    return out, logt


def _launch_bwd(attrs, logt, gout, ntx):
    _check_attrs(attrs)
    n, K, _ = attrs.shape
    _check_rows("logt", logt, n, K // CHUNK, attrs.device)
    _check_rows("gout", gout, n, 8, attrs.device)
    g_attrs = torch.empty_like(attrs)
    lib = _lib()
    with torch.cuda.device(attrs.device):
        stream = torch.cuda.current_stream(attrs.device).cuda_stream
        err = lib.composite_bwd_launch(attrs.data_ptr(), gout.data_ptr(),
                                       logt.data_ptr(), n, K, ntx,
                                       g_attrs.data_ptr(), stream)
    _raise_on(err, "composite_bwd")
    composite_bwd.launches += 1
    return g_attrs


def composite_fwd(attrs, nchunks, ntx: int):
    """-> (out [n, 8, P], logt [n, K/CHUNK, P]).  CPU tensors:
    ``composite_fwd_reference``; CUDA tensors: kernel K2."""
    if attrs.device.type == "cpu":
        return composite_fwd_reference(attrs, nchunks, ntx)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_fwd: unsupported device {attrs.device}")
    return _launch_fwd(attrs.contiguous(), nchunks.contiguous(), ntx)


def composite_bwd(attrs, logt, gout, ntx: int):
    """-> g_attrs [n, K, ATTR].  CPU tensors: ``composite_bwd_reference``;
    CUDA tensors: kernel K3."""
    if attrs.device.type == "cpu":
        return composite_bwd_reference(attrs, logt, gout, ntx)
    if attrs.device.type != "cuda":
        raise ValueError(f"composite_bwd: unsupported device {attrs.device}")
    return _launch_bwd(attrs.contiguous(), logt.contiguous(),
                       gout.contiguous(), ntx)


composite_fwd.launches = 0
composite_bwd.launches = 0


class _CompositeTiles(torch.autograd.Function):
    @staticmethod
    def forward(ctx, attrs, nchunks, ntx):
        out, logt = composite_fwd(attrs, nchunks, ntx)
        ctx.save_for_backward(attrs, logt)
        ctx.ntx = ntx
        return out

    @staticmethod
    def backward(ctx, g_out):
        attrs, logt = ctx.saved_tensors
        return composite_bwd(attrs, logt, g_out, ctx.ntx), None, None


def composite_tiles(attrs, nchunks, ntx: int):
    """attrs [n_tiles, K, ATTR] f32 (tile-gathered, depth-sorted rows; empty
    slots all-zero, K % 128 == 0); nchunks [n_tiles] int32, the per-tile
    count of populated 128-row chunks.  Tile t covers pixels
    [(t % ntx)*16, (t // ntx)*16) + [16, 16).
    Returns (rgb [n_tiles, 3, P], alpha [n_tiles, P], depth [n_tiles, P]),
    differentiable in attrs."""
    out = _CompositeTiles.apply(attrs, nchunks, ntx)
    return out[:, 0:3, :], out[:, 3, :], out[:, 4, :]
