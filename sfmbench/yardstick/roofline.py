"""Frozen counts of the work, and the card's published peaks.

A copy of the analytic count ``lm_step_cost`` of the program's
``utils/roofline.py``, kept here so that a change to the program cannot
move the yardstick, and ``k1_cost``, the Schur-chain product of the bundle adjuster's conjugate
gradients counted from the problem alone.  Every count is of the work the
problem defines, never of a program's padding or layout.

The peaks are NVIDIA's published H100 SXM figures (dense, at the 700 W
power limit): 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s
TF32, 3.35 TB/s HBM3, and 16 special-function results an SM a clock on
compute capability 9.0, 132 SMs at the 1.98 GHz boost clock.
"""

from __future__ import annotations

from typing import NamedTuple

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


class WorkCost(NamedTuple):
    flops: float       # FP32 operations
    sfu: float         # special-function results
    hbm_bytes: float   # least device-memory bytes


def k1_cost(O: int, C: int, T: int, PC: int, dtype_bytes: int = 4) -> WorkCost:
    """The Schur-chain product y = W V^-1 W^T x of one conjugate-gradient
    iteration of bundle adjustment, on ``O`` observations of ``T`` points
    by ``C`` cameras with ``PC`` parameters each.  Reads each observation's
    camera-point block W_o [PC, 3] and its camera and point ids once, each
    point's V^-1 [3, 3] once and x [C, PC] once, and writes y [C, PC] once.
    Operations: t_p = SUM_o W_o^T x_c (2 * 3 * PC an observation, 3 to add
    it to its point's sum), z_p = V_p^-1 t_p (15 a point), u_o = W_o z_p
    (2 * 3 * PC an observation) and the camera sum of u (PC an
    observation)."""
    F = dtype_bytes
    nbytes = O * (3 * PC * F + 8) + T * 9 * F + 2 * C * PC * F
    flops = O * (6 * PC + 3 + 6 * PC + PC) + 15 * T
    return WorkCost(float(flops), 0.0, float(nbytes))


def bound_s(flops: float, hbm_bytes: float, sfu: float = 0.0,
            spec: ChipSpec = H100_SXM) -> float:
    """The least seconds ``spec`` needs for the work: the largest of its
    float32 operations, bytes and special-function results over the
    card's rates."""
    return max(flops / spec.peak_flops_f32, hbm_bytes / spec.peak_bw,
               sfu / spec.peak_sfu)
