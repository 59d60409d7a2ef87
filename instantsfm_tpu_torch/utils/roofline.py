"""Analytic rooflines of the LM step and of the 3DGS training step on the card.

Counterpart of the device-independent half of
``instantsfm_tpu/utils/roofline.py``: ``lm_step_cost`` counts the FLOPs and
the least device-memory bytes of one steady-state LM iteration from array
shapes and pass counts, and ``analyze_analytic`` turns them into the least
time the card could take (the larger of FLOPs over the peak rate and bytes
over the memory rate) and the share of it a measured step reaches.  The JAX
module's ``cost_of`` and ``analyze`` read XLA's compiled cost model, which
has no counterpart here.

``gs_step_cost`` counts the 3DGS training step (``bench_gs.py``'s) part by
part, as the reference algorithm defines the work, whatever implements it:
each input byte read once and each output byte written once, no padding, the
data-dependent work (tile intersections, the compositing's entered chunks
and live pairs) as the step's own tensors give it.  ``analyze_gs`` turns it
into the step's share of its bound.  The compositing kernels' terms
(``k23_bytes``, ``k23_bound_all_pairs``) are the ones ``chip_smoke.py``
holds K2 and K3 to.

The card's peaks are NVIDIA's published H100 SXM figures (dense, at the
700 W power limit): 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32, 3.35 TB/s HBM3, and 16 special-function results (exp2, lg2, rcp,
rsqrt) an SM a clock on compute capability 9.0 (CUDA C Programming Guide,
arithmetic instruction throughput), 132 SMs at the 1.98 GHz boost clock of
the 67 TFLOP/s.  The LM and 3DGS steps run their products in full float32
(``utils/device.py::full_f32``; TF32 is off), so their FLOPs are held to the
float32 rate.  A card set below 700 W (``nvidia-smi --query-gpu=power.limit``)
runs below these peaks: state its limit beside a share.
"""

from __future__ import annotations

from typing import NamedTuple

from instantsfm_tpu_torch.gs.composite import CHUNK, DE, P, TILE


class ChipSpec(NamedTuple):
    name: str
    peak_flops_f32: float   # FLOP/s, float32 outside the tensor cores
    peak_flops_tf32: float  # FLOP/s, TF32 tensor cores (dense)
    peak_bw: float          # device-memory bytes/s
    peak_sfu: float         # special-function results/s


H100_SXM = ChipSpec("h100-sxm", 67e12, 495e12, 3.35e12, 132 * 16 * 1.98e9)

_SPECS = {"h100": H100_SXM}   # torch.cuda.get_device_name substrings


def chip_spec(device_name: str = None) -> ChipSpec:
    """The published peaks of the card named ``device_name`` (default:
    ``torch.cuda.get_device_name(0)``).  Raises for a card (or a CPU) with
    no entry: no roofline is stated against a guessed peak."""
    if device_name is None:
        import torch
        device_name = torch.cuda.get_device_name(0)
    for key, spec in _SPECS.items():
        if key in device_name.lower():
            return spec
    raise ValueError(f"no published peaks for {device_name!r}")


class Roofline(NamedTuple):
    flops: float
    hbm_bytes: float
    t_light: float         # seconds: max(compute-bound, memory-bound) time
    mfu: float             # measured FLOP/s over the float32 peak
    membw_util: float      # measured bytes/s over the memory rate
    roofline_frac: float   # t_light / t_measured (1.0 == speed of light)
    bound: str             # "memory" | "compute", the binding term
    chip: str


class LMStepCost(NamedTuple):
    flops: float       # total FLOPs per steady-state LM step (1 solve try)
    hbm_bytes: float   # minimum device-memory bytes moved per step


def lm_step_cost(O: int, C: int, T: int, PC: int, res_dim: int = 2,
                 cg_iters: int = 25, dtype_bytes: int = 4,
                 has_scales: bool = False, cam_ref_floats: int = 19,
                 onehot_cam_reduce: bool = True) -> LMStepCost:
    """Analytic FLOPs / byte lower bound for ONE steady-state LM iteration on
    the PCG path (build_system + block-Jacobi preconditioner + ``cg_iters``
    Schur matvecs + back-substitution + candidate cost; accept on first
    try), the JAX package's count term for term.

    Traffic terms (floats per observation unless noted):
      build:    gathers (cam_ref 19 + pt 3 + data 2) written+read once; the
                per-obs normal-equation products U_o[PC^2] V_o[9] W[3PC]
                gc[PC] gp[3] written once and re-read once by reductions.
      precond:  Vg[9] gather, WVi[3PC] + D_corr[PC^2] written+read.
      pcg/iter: xg[PC] w+r, W read twice (3PC each), t[3] w+r, z[3] gather
                w+r, u[PC] w+r.
      cost:     gathers re-read (24) + residual fused.
    FLOPs: per-obs residual+Jacobian chains (~30 FLOPs per output scalar per
    tangent, R*(PC+4) tangents), the per-obs block products, the camera
    reductions and the W / W^T matvecs.  ``onehot_cam_reduce`` counts the
    JAX package's one-hot products (2*C FLOPs per reduced float); the port
    sums by camera with ``index_add_`` and K1's in-kernel sums (2 FLOPs per
    reduced float), so it passes False."""
    F = dtype_bytes
    gath = cam_ref_floats + 3 + 2
    prod = PC * PC + 9 + 3 * PC + PC + 3
    build = 2 * gath + 2 * prod
    precond = 9 + 2 * (3 * PC) + 2 * (PC * PC)
    per_cg = 2 * PC + 2 * (3 * PC) + 2 * 3 + 2 * 3 + 2 * PC
    cost_eval = gath + 5
    scales = (2 * (1 + PC + 3 + 1) * 3) if has_scales else 0
    floats_per_obs = build + precond + per_cg * cg_iters + cost_eval + scales
    hbm = O * floats_per_obs * F
    # small-axis arrays (read once per pass that touches them)
    hbm += (C * PC * PC * (3 + cg_iters) + T * 9 * (4 + cg_iters)) * F

    jac_chain = res_dim * (PC + 4) * 30
    products = 2 * res_dim * prod
    reduced_floats = (PC * PC + PC) + (PC * PC) + PC * cg_iters
    onehot = (2 * C * reduced_floats) if onehot_cam_reduce else \
        (2 * reduced_floats)
    matvec = cg_iters * (2 * 3 * PC * 2 + 30)        # W / W^T per-obs matvecs
    flops = O * (jac_chain + products + onehot + matvec)
    return LMStepCost(flops=float(flops), hbm_bytes=float(hbm))


def analyze_analytic(cost: LMStepCost, t_step: float,
                     spec: ChipSpec = None) -> Roofline:
    """Roofline of one step of ``cost`` measured at ``t_step`` seconds on
    ``spec`` (default: the card in use).  As in the JAX package, a share
    past 1.02 means the count over-counts and is reported as NaN, and a
    share under 0.25 is marked as a step that launches and latency bound."""
    spec = spec or chip_spec()
    t_c = cost.flops / spec.peak_flops_f32
    t_m = cost.hbm_bytes / spec.peak_bw
    t_light = max(t_c, t_m)
    frac = t_light / t_step if t_step > 0 else 0.0
    bound = "compute" if t_c >= t_m else "memory"
    if frac > 1.02:
        bound = "unreliable (analytic model over-counts)"
        frac = float("nan")
    elif frac < 0.25:
        bound += " (model lower-bound; step is launch/latency dominated)"
    return Roofline(
        flops=cost.flops, hbm_bytes=cost.hbm_bytes, t_light=t_light,
        mfu=cost.flops / t_step / spec.peak_flops_f32,
        membw_util=cost.hbm_bytes / t_step / spec.peak_bw,
        roofline_frac=min(frac, 1.0), bound=bound, chip=spec.name)


# ------------------------------------------------------------ 3DGS step

class WorkCost(NamedTuple):
    flops: float       # FP32 operations
    sfu: float         # special-function results
    hbm_bytes: float   # least device-memory bytes


def bound_ms(nbytes, flops, sfu, spec: ChipSpec = H100_SXM):
    """(bound_ms, bound_by, counts): the largest of the byte, FP32 and
    special-function times of one piece of work on ``spec``."""
    t_b = nbytes / spec.peak_bw
    t_f = flops / spec.peak_flops_f32
    t_s = sfu / spec.peak_sfu
    t = max(t_b, t_f, t_s)
    return (t * 1e3, "bytes" if t_b >= max(t_f, t_s) else "operations",
            dict(mbytes=nbytes / 1e6, gflop=flops / 1e9, gsfu=sfu / 1e9,
                 bytes_ms=t_b * 1e3, fp32_ms=t_f * 1e3, sfu_ms=t_s * 1e3))


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


def k23_bound_all_pairs(kname, work, tiles, layout=None, pixels=None,
                        spec: ChipSpec = H100_SXM):
    """``bound_ms`` of K2 or K3 over every pair of the entered chunks (the
    first port's count, and the step's compositing terms)."""
    return bound_ms(k23_bytes(kname, work, tiles, layout, pixels),
                    *k23_all_pairs_work(kname, work), spec=spec)


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


class GSRoofline(NamedTuple):
    flops: float
    sfu: float
    hbm_bytes: float
    t_light: float        # seconds: the largest of the three times
    mfu: float            # measured FLOP/s over the float32 peak
    membw_util: float     # measured bytes/s over the memory rate
    roofline_frac: float  # t_light / t_measured (1.0 == speed of light)
    bound: str            # "bytes" | "operations" | "sfu"
    chip: str
    parts_ms: dict        # part -> its own bound, ms


def part_bounds_ms(cost: GSStepCost, spec: ChipSpec = None) -> dict:
    """Each part's own bound in ms on ``spec`` (default: the card in
    use)."""
    spec = spec or chip_spec()
    return {k: bound_ms(p.hbm_bytes, p.flops, p.sfu, spec)[0]
            for k, p in cost.parts.items()}


def analyze_gs(cost: GSStepCost, t_step: float,
               spec: ChipSpec = None) -> GSRoofline:
    """Roofline of one 3DGS step of ``cost`` measured at ``t_step``
    seconds on ``spec`` (default: the card in use).  The share is not
    clamped: above 1.0 the count is wrong."""
    spec = spec or chip_spec()
    times = {"bytes": cost.hbm_bytes / spec.peak_bw,
             "operations": cost.flops / spec.peak_flops_f32,
             "sfu": cost.sfu / spec.peak_sfu}
    bound = max(times, key=times.get)
    t_light = times[bound]
    return GSRoofline(
        flops=cost.flops, sfu=cost.sfu, hbm_bytes=cost.hbm_bytes,
        t_light=t_light, mfu=cost.flops / t_step / spec.peak_flops_f32,
        membw_util=cost.hbm_bytes / t_step / spec.peak_bw,
        roofline_frac=t_light / t_step, bound=bound, chip=spec.name,
        parts_ms=part_bounds_ms(cost, spec))
