"""Analytic roofline of the LM step on the card.

Counterpart of the device-independent half of
``instantsfm_tpu/utils/roofline.py``: ``lm_step_cost`` counts the FLOPs and
the least device-memory bytes of one steady-state LM iteration from array
shapes and pass counts, and ``analyze_analytic`` turns them into the least
time the card could take (the larger of FLOPs over the peak rate and bytes
over the memory rate) and the share of it a measured step reaches.  The JAX
module's ``cost_of`` and ``analyze`` read XLA's compiled cost model, which
has no counterpart here.

The card's peaks are NVIDIA's published H100 SXM figures (dense, at the
700 W power limit): 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32, 3.35 TB/s HBM3.  The LM step runs its products in full float32
(``utils/device.py::full_f32``; TF32 is off), so its FLOPs are held to the
float32 rate.  A card set below 700 W (``nvidia-smi --query-gpu=power.limit``)
runs below these peaks: state its limit beside a share.
"""

from __future__ import annotations

from typing import NamedTuple


class ChipSpec(NamedTuple):
    name: str
    peak_flops_f32: float   # FLOP/s, float32 outside the tensor cores
    peak_flops_tf32: float  # FLOP/s, TF32 tensor cores (dense)
    peak_bw: float          # device-memory bytes/s


H100_SXM = ChipSpec("h100-sxm", 67e12, 495e12, 3.35e12)

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
