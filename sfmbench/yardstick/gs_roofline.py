"""Frozen count of one 3DGS training step (one view), part by part.

A copy of ``gs_step_cost`` and its work units from the program's
``utils/roofline.py``, kept here so that a change to the program cannot
move the yardstick.  Every count is of the work the reference defines: no
padding, the compositing over every pair of the chunks a tile's walk
entered.  ``bound_s`` is the least time on a card's published peaks
(``roofline.chip_spec``).
"""

from __future__ import annotations

from typing import NamedTuple

from yardstick.roofline import H100_SXM, ChipSpec

TILE = 16          # pixels a tile side
P = TILE * TILE    # pixels a tile
CHUNK = 128        # rows a compositing chunk
DE = 9             # the packed row's last used column (depth)


class WorkCost(NamedTuple):
    flops: float       # FP32 operations
    sfu: float         # special-function results
    hbm_bytes: float   # least device-memory bytes


# Work units of K2/K3 (FP32 operations, special-function results): the
# cull record of a row (det, trace, s and its margin, two half-extents with
# theirs, the box, the rules; a log, two divisions, two square roots) and
# one box test per (row, warp) (four compares, three ors), which only the
# cull-aware bound of ``chip_smoke.py`` counts; the alpha terms of a pair
# (offsets, the conic form, exp argument, opacity, clip, the two tests; an
# exp); per live pair K2's weight, colour and depth sums and prefix (a
# log1p and an exp), K3's prefix and T, 51 for the gradient terms and their
# pixel sums (a log1p, an exp and a reciprocal).
RECORD_WORK = (30, 5)
TEST_WORK = 7
ALPHA_WORK = (16, 1)
LIVE_WORK = {"K2": (12, 2), "K3": (54, 3)}
ATTR_USED = DE + 1   # packed attribute columns that hold data


def k23_bytes(kname, work, tiles, layout=None, pixels=None):
    """Least bytes of K2 (``kname`` "K2") or K3 on the chunks ``work``
    (``composite.pair_counts``) says the walk entered, over ``tiles``
    tiles.  K2 reads the entered chunks' rows and the chunk counts and
    writes its output rows and the entry log T; K3 reads the rows, the 5
    live rows of its output gradient and log T and writes the rows'
    gradients.

    ``layout`` (K, A) counts the arrays the kernels are handed, padded to
    K slots of A columns a tile: log T over every chunk slot, 8 output rows,
    the gradient of every slot.  Without it the count is the reference's,
    free of padding: ``ATTR_USED`` columns, log T and gradients of the
    entered chunks only, 5 output rows over ``pixels`` (default: the tiles'
    pixels)."""
    rows = work["chunks_entered"] * CHUNK
    pixels = tiles * P if pixels is None else pixels
    if layout is None:
        cols, out_rows = ATTR_USED, 5
        logt = 4 * work["chunks_entered"] * P
        g_rows = rows
    else:
        (K, cols), out_rows = layout, 8
        logt = 4 * tiles * (K // CHUNK) * P
        g_rows = tiles * K
    inputs = 4 * rows * cols
    if kname == "K2":
        return inputs + 4 * tiles + 4 * out_rows * pixels + logt
    return inputs + 4 * 5 * pixels + logt + 4 * g_rows * cols


def k23_all_pairs_work(kname, work):
    """(FP32 operations, special results) of K2 or K3 without a cull: the
    alpha terms of every pair of an entered chunk, and the live pairs'
    work."""
    live_ops, live_sfu = LIVE_WORK[kname]
    return (ALPHA_WORK[0] * work["pairs"] + live_ops * work["live_pairs"],
            ALPHA_WORK[1] * work["pairs"] + live_sfu * work["live_pairs"])


# Per-gaussian work of the projection (FP32 operations, special results):
# exp of 3 log-scales and the opacity's sigmoid (2; an exp, a reciprocal);
# the quaternion's normalisation (11, a rsqrt) and rotation matrix (24);
# the camera rotation times it, the squared scales and the 3x3 covariance
# (45 + 12 + 30); the camera point (18) and its pixel (6, a reciprocal);
# the clamped EWA Jacobian (16); the 2x2 covariance J cov J^T with the blur
# (30 + 17); the determinant and conic (7, a reciprocal); the 3-sigma
# radius (6, two square roots); the 10 tests of ``valid``.
PROJECT_WORK = (234, 10)
# SH colour: the unit direction (11, a rsqrt), the basis up to each degree
# (cumulative: 0, 3, 18, 45), a multiply-add per coefficient and channel,
# +0.5 and the clamp (6).
SH_DIR_WORK = (11, 1)
SH_BASIS_OPS = (0, 3, 18, 45)
# A backward recomputes its forward and spends twice the forward's FP32
# operations on the adjoint.
BWD_OPS = 3
# The tile box of a gaussian: its four edges, their tiles and clamps.
TILE_BOX_OPS = 16
# SSIM (11-tap gaussian window, 'valid' correlation): per output pixel and
# channel, the 3 means' and 3 variances' terms, numerator and denominator
# (18; a reciprocal); the combination of the 3 adjoint maps per input
# (7).  L1: a subtraction, an abs and a sum (3), its gradient (2).
SSIM_TAPS = 11
SSIM_TERMS = (18, 1)
SSIM_COMBINE_OPS = 7
L1_OPS = (3, 2)
# Adam per parameter float: both moments (7), the bias corrections (2),
# a square root, the epsilon, the quotient (a reciprocal), the learning
# rate and the update (4; 2 special); p, g, m, v read, p, m, v written.
ADAM_WORK = (13, 2)
ADAM_BYTES = 28

GS_PARTS = ("projection_fwd", "projection_bwd", "sh_fwd", "sh_bwd",
            "tile_sort", "gather", "gather_transpose", "k2", "k3",
            "loss_fwd", "loss_bwd", "adam")


class GSStepCost(NamedTuple):
    flops: float
    sfu: float
    hbm_bytes: float
    parts: dict        # GS_PARTS name -> WorkCost


def ssim_filter_flops(width: int, height: int, maps: int,
                      channels: int = 3) -> float:
    """FP32 operations of ``maps`` separable 11-tap 'valid' filters over a
    ``channels``-channel image: a multiply-add per tap, the row pass over
    H x (W - 10) outputs and the column pass over (H - 10) x (W - 10)."""
    wv, hv = width - SSIM_TAPS + 1, height - SSIM_TAPS + 1
    return 2.0 * SSIM_TAPS * maps * channels * (height * wv + hv * wv)


def gs_step_cost(G: int, sh_degree: int, width: int, height: int,
                 intersections: int, kept: int, chunks_entered: int,
                 live_pairs: int) -> GSStepCost:
    """FP32 operations, special-function results and least HBM bytes of one
    3DGS training step (one view), by part and summed.

    ``G`` gaussians at SH degree ``sh_degree`` rendered at ``width`` x
    ``height``; ``intersections`` (tile, gaussian) pairs sorted,
    ``kept`` of them in the tiles' windows (each tile's first
    ``tile_capacity``), the compositing's ``chunks_entered`` and
    ``live_pairs`` (``composite.pair_counts``).  Each part reads its inputs
    once and writes its outputs once; padding (to a tile's capacity, a
    chunk, a lane) counts for nothing.  The compositing counts every pair of
    each entered chunk (the reference's chunk-granular exit), not the pairs
    a kernel's cull keeps; SSIM counts its separable filter, not the band
    products ``gs/ssim.py`` runs."""
    K = (sh_degree + 1) ** 2
    tiles = -(-width // TILE) * -(-height // TILE)
    pix = width * height
    parts = {}

    f, s = PROJECT_WORK
    parts["projection_fwd"] = WorkCost(f * G, s * G, (44 + 1 + 32 + 1) * G)
    parts["projection_bwd"] = WorkCost(BWD_OPS * f * G, s * G,
                                       ((7 + 11 + 11) * 4 + 1) * G)

    d_f, d_s = SH_DIR_WORK if sh_degree > 0 else (0, 0)
    f = d_f + SH_BASIS_OPS[sh_degree] + 6 * K + 6
    means = 3 if sh_degree > 0 else 0
    parts["sh_fwd"] = WorkCost(f * G, d_s * G, 4 * (3 * K + means + 3) * G)
    parts["sh_bwd"] = WorkCost(BWD_OPS * f * G, d_s * G,
                               4 * (3 + 3 * K + means + 3 * K + means) * G)

    # keys (tile, depth; 8 bytes) and values (gaussian ids; 4) written from
    # the gaussians' means, radii, depths and flags, sorted (read and
    # written once), and the tiles' ranges found in the sorted tile ids
    parts["tile_sort"] = WorkCost(
        TILE_BOX_OPS * G, 0,
        17 * G + 12 * intersections + 24 * intersections
        + 4 * intersections + 4 * (tiles + 1))
    row = 4 * ATTR_USED
    parts["gather"] = WorkCost(0, 0, row * G + (4 + row) * kept)
    parts["gather_transpose"] = WorkCost(ATTR_USED * kept, 0,
                                         (row + 4) * kept + row * G)

    work = dict(chunks_entered=chunks_entered,
                pairs=chunks_entered * CHUNK * P, live_pairs=live_pairs)
    for kname in ("K2", "K3"):
        ops, sfu = k23_all_pairs_work(kname, work)
        parts[kname.lower()] = WorkCost(
            ops, sfu, k23_bytes(kname, work, tiles, pixels=pix))

    n3 = 3 * pix
    nv = 3 * (width - SSIM_TAPS + 1) * (height - SSIM_TAPS + 1)
    parts["loss_fwd"] = WorkCost(
        L1_OPS[0] * n3 + 3 * n3 + ssim_filter_flops(width, height, 5)
        + SSIM_TERMS[0] * nv, SSIM_TERMS[1] * nv, 2 * 4 * n3 + 4)
    parts["loss_bwd"] = WorkCost(
        L1_OPS[1] * n3 + SSIM_COMBINE_OPS * n3
        + ssim_filter_flops(width, height, 5 + 3)
        + BWD_OPS * SSIM_TERMS[0] * nv, SSIM_TERMS[1] * nv,
        2 * 4 * n3 + 4 * n3)

    floats = (3 + 4 + 3 + 1 + 3 * K) * G
    parts["adam"] = WorkCost(ADAM_WORK[0] * floats, ADAM_WORK[1] * floats,
                             ADAM_BYTES * floats)
    parts = {k: WorkCost(*map(float, parts[k])) for k in GS_PARTS}
    return GSStepCost(*(sum(p[i] for p in parts.values()) for i in range(3)),
                      parts=parts)


def bound_s(nbytes: float, flops: float, sfu: float,
            spec: ChipSpec = H100_SXM) -> float:
    """The least seconds for this much work on ``spec``: the largest of its
    byte, FP32 and special-function times."""
    return max(nbytes / spec.peak_bw, flops / spec.peak_flops_f32,
               sfu / spec.peak_sfu)
