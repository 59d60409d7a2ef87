"""Block-sparse Levenberg–Marquardt with Schur complement, on torch tensors.

Counterpart of ``instantsfm_tpu/solve/block_lm.py`` (its row-major path):

* Problems are two-block (per-camera blocks, per-point blocks) plus an
  optional per-observation scalar block (GP's projective scales).  Each
  residual touches one camera block, at most one point and one scalar.
* Jacobians come from ``torch.func.vmap(torch.func.jacfwd(...))`` of the
  local residual at delta = 0, so poses get 6-dof tangent Jacobians.
* Per-observation blocks reduce into block-diagonal U (cameras, with
  ``index_add_``) and V (points, bucketed reshape-sums); V is inverted in
  closed form and the reduced camera system is solved by dense Cholesky
  (small problems) or block-Jacobi PCG, whose Schur matvec runs the K1
  kernel on the card (``solve/schur_wchain.py``).
* Trust region: multiplicative damping on the JᵀJ diagonal, differential
  acceptance on per-observation loss differences, lam / radius_down on
  reject (no upper clamp, as in the reference).

Host reads (``utils/debug.read``) per LM step: the CG stop tests
(``pcg.exit``: on one CUDA device one per replay of a block of
``pcg.BLOCK`` iterations, else one per PCG iteration plus one per solve),
one per damped try (the accept test, ``lm.accept``), and one per
``optimize`` iteration (the history readback, ``lm.history``).  An LM step
is the span ``lm.step``: the system build ``lm.build``, then per try the
damped solve ``lm.solve`` (its PCG: ``pcg.graph`` with its replays
``pcg.replay``, or the iterations ``pcg.iter``) and the candidate's loss
``lm.loss``.

Across processes (``parallel/sharded.py``) each rank holds a slice of the
points with their observations (point-local) and ``group`` is the process
group, the counterpart of JAX's ``axis_name``: every reduction over
observations into camera space or into a scalar is all-reduced there
(``_ar``), so the camera system, the PCG vectors and every scalar the host
tests are the same on every rank and every rank takes the same branch; the
point-side sums stay on the rank.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.func import jacfwd, vmap

from instantsfm_tpu_torch.solve import ba_closed
from instantsfm_tpu_torch.solve import robust as robust_mod
from instantsfm_tpu_torch.solve.blocked import gather_pt, seg_by_pt
from instantsfm_tpu_torch.solve.pcg import graph_pcg, pcg
from instantsfm_tpu_torch.solve.schur_wchain import recorded, schur_wchain
from instantsfm_tpu_torch.utils import debug as _dbg
from instantsfm_tpu_torch.utils.device import check_on_device, full_f32


class BlockProblem(NamedTuple):
    """Static description of a two-block NLS problem.

    residual_fn(cam_delta[PC], cam_ref, pt_delta[3], pt_ref, scale_delta[1],
                scale_ref, obs) -> r[R], for ONE observation (the engine
    vmaps it); only evaluated and differentiated at delta = 0.
    retract_cam(cam_blocks, delta[C, PC]) -> cam_blocks (exact update).
    reproj: (camera model id, optimize_poses) where the residual is bundle
    adjustment's reprojection (``problems.make_ba_problem``), whose system
    ``solve/ba_closed.py`` builds in closed form; None for any other.
    """
    residual_fn: Callable
    retract_cam: Callable
    cam_dim: int
    res_dim: int
    has_points: bool = True
    has_scales: bool = False
    reproj: Optional[tuple] = None


class Observations(NamedTuple):
    cam_idx: torch.Tensor     # [O] int32
    pt_idx: torch.Tensor      # [O] int32
    data: Any                 # {name: [O] tensor}
    valid: torch.Tensor       # [O] bool


class Params(NamedTuple):
    cam: Any                  # {name: [C, ...] tensor}
    pts: torch.Tensor         # [T, 3]
    scales: torch.Tensor      # [O, 1]
    scales_free: torch.Tensor  # [O] bool — False freezes a scale


class NormalSystem(NamedTuple):
    """Undamped normal-equation blocks + robust-weighted residual stats."""
    U: torch.Tensor        # [C, PC, PC]
    V: torch.Tensor        # [T, 3, 3]
    W: torch.Tensor        # [O, PC, 3]
    g_cam: torch.Tensor    # [C, PC]   (-J^T r, camera part)
    g_pt: torch.Tensor     # [T, 3]
    Hss: torch.Tensor      # [O] J_s^T J_s
    Jc_s: torch.Tensor     # [O, PC]  (J_c^T J_s)
    Jp_s: torch.Tensor     # [O, 3]   (J_p^T J_s)
    g_s: torch.Tensor      # [O] -J_s^T r
    cost: torch.Tensor     # robust total cost (scalar)
    loss_vec: torch.Tensor  # [O] per-observation robust loss (valid-masked)


def _ar(x, group):
    """Sum ``x`` over the ranks of ``group`` (in place); ``x`` where
    ``group`` is None."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


def _num_cams(params: Params) -> int:
    return next(iter(params.cam.values())).shape[0]


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


def _gathered(params: Params, obs: Observations):
    cam_g = {k: v[obs.cam_idx] for k, v in params.cam.items()}
    return cam_g, params.pts[obs.pt_idx]


def _local_residual(problem: BlockProblem):
    """Per-observation residual as a function of the stacked delta
    [PC + 3 + 1] (camera, point, scale) around the current estimate."""
    PC = problem.cam_dim

    def f(d, cam_ref, pt_ref, sc_ref, data):
        return problem.residual_fn(d[:PC], cam_ref, d[PC:PC + 3], pt_ref,
                                   d[PC + 3:], sc_ref, data)
    return f


def compute_loss_vec(problem: BlockProblem, params: Params,
                     obs: Observations, kernel: robust_mod.RobustKernel,
                     buckets: tuple = ()) -> torch.Tensor:
    """Per-observation robust loss rho(||r_o||^2), zeroed on invalid rows:
    in closed form where ``ba_closed.covers`` the problem (on the card the
    build kernel's loss mode), else through ``vmap``."""
    if ba_closed.covers(problem, kernel, buckets):
        return ba_closed.loss_vec(problem, params, obs, kernel)
    zero = params.pts.new_zeros(problem.cam_dim + 4)
    f = _local_residual(problem)
    cam_g, pt_g = _gathered(params, obs)
    r = vmap(partial(f, zero))(cam_g, pt_g, params.scales, obs.data)
    s = torch.sum(r * r, dim=-1)
    return torch.where(obs.valid, kernel.loss(s), torch.zeros_like(s))


def compute_cost(problem: BlockProblem, params: Params, obs: Observations,
                 kernel: robust_mod.RobustKernel, buckets: tuple = (),
                 group=None) -> torch.Tensor:
    """Robust cost sum_o rho(||r_o||^2) over valid observations (of every
    rank of ``group``)."""
    return _ar(torch.sum(compute_loss_vec(problem, params, obs, kernel,
                                          buckets=buckets)), group)


def build_system(problem: BlockProblem, params: Params, obs: Observations,
                 kernel: robust_mod.RobustKernel, num_points: int,
                 buckets: tuple = (), group=None) -> NormalSystem:
    """Evaluate residuals + per-block Jacobians, apply robust whitening,
    form the per-observation products and reduce them into U/V/W/g.

    Where ``ba_closed.covers`` the problem (a declared reprojection
    residual of a covered camera model and robust kernel, on a bucketed
    layout) the closed form builds it (on the card one kernel launch),
    counted in the run counter ``lm_build_closed``; any other problem takes
    the ``vmap(jacfwd)`` path below, counted in ``lm_build_autodiff``."""
    PC = problem.cam_dim
    C = _num_cams(params)
    O_n = obs.valid.shape[0]
    if ba_closed.covers(problem, kernel, buckets):
        _dbg.stat_add("lm_build_closed", 1)
        Ug, V, g_pt, W, loss_vec = ba_closed.build(problem, params, obs,
                                                   kernel, num_points, buckets)
        cost = _ar(torch.sum(loss_vec), group)
        Ug = _ar(Ug, group)
        # no scale block: the solve reads none of its products
        zero = W.new_zeros(())
        return NormalSystem(U=Ug[:, :PC * PC].reshape(C, PC, PC), V=V, W=W,
                            g_cam=Ug[:, PC * PC:], g_pt=g_pt,
                            Hss=zero.expand(O_n),
                            Jc_s=zero.expand(O_n, PC),
                            Jp_s=zero.expand(O_n, 3), g_s=zero.expand(O_n),
                            cost=cost, loss_vec=loss_vec)
    _dbg.stat_add("lm_build_autodiff", 1)
    zero = params.pts.new_zeros(PC + 4)
    f = _local_residual(problem)

    def res_and_jac(cam_ref, pt_ref, sc_ref, data):
        def g(d):
            r = f(d, cam_ref, pt_ref, sc_ref, data)
            return r, r
        return jacfwd(g, has_aux=True)(zero)

    J, r = vmap(res_and_jac)(*_gathered(params, obs), params.scales, obs.data)
    Jc, Jp, Js = J[..., :PC], J[..., PC:PC + 3], J[..., PC + 3]
    # r: [O,R], Jc: [O,R,PC], Jp: [O,R,3], Js: [O,R]

    valid = obs.valid
    s = torch.sum(r * r, dim=-1)
    zs = torch.zeros_like(s)
    w = torch.where(valid, kernel.weight(s), zs)
    loss_vec = torch.where(valid, kernel.loss(s), zs)
    cost = _ar(torch.sum(loss_vec), group)
    sw = torch.sqrt(w)[:, None]

    r = r * sw
    Jc = Jc * sw[..., None]
    Jp = Jp * sw[..., None] if problem.has_points else torch.zeros_like(Jp)
    if problem.has_scales:
        Js = Js * sw * params.scales_free[:, None]
    else:
        Js = torch.zeros_like(Js)

    Hss = torch.sum(Js * Js, dim=-1)                             # [O]
    Jc_s = torch.sum(Jc * Js[:, :, None], dim=1)                 # [O, PC]
    Jp_s = torch.sum(Jp * Js[:, :, None], dim=1)                 # [O, 3]
    g_s = -torch.sum(Js * r, dim=-1)                             # [O]

    U_o = torch.sum(Jc[:, :, :, None] * Jc[:, :, None, :], 1)    # [O, PC, PC]
    V_o = torch.sum(Jp[:, :, :, None] * Jp[:, :, None, :], 1)    # [O, 3, 3]
    W = torch.sum(Jc[:, :, :, None] * Jp[:, :, None, :], 1)      # [O, PC, 3]
    gc_o = -torch.sum(Jc * r[:, :, None], dim=1)                 # [O, PC]
    gp_o = -torch.sum(Jp * r[:, :, None], dim=1)                 # [O, 3]

    Ug = _ar(_seg_by_cam(torch.cat([U_o.reshape(O_n, PC * PC), gc_o], dim=1),
                         obs.cam_idx, C), group)
    V = _seg_by_pt(V_o, obs.pt_idx, num_points, buckets)
    g_pt = _seg_by_pt(gp_o, obs.pt_idx, num_points, buckets)
    return NormalSystem(U=Ug[:, :PC * PC].reshape(C, PC, PC), V=V,
                        W=W.contiguous(), g_cam=Ug[:, PC * PC:], g_pt=g_pt,
                        Hss=Hss, Jc_s=Jc_s, Jp_s=Jp_s, g_s=g_s, cost=cost,
                        loss_vec=loss_vec)


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


def _chol3x3(M):
    """Closed-form batched Cholesky of SPD (..., 3, 3): M = L Lᵀ."""
    a = torch.sqrt(M[..., 0, 0].clamp_min(1e-30))
    b = M[..., 1, 0] / a
    c = M[..., 2, 0] / a
    d = torch.sqrt((M[..., 1, 1] - b * b).clamp_min(1e-30))
    e = (M[..., 2, 1] - c * b) / d
    f = torch.sqrt((M[..., 2, 2] - c * c - e * e).clamp_min(1e-30))
    z = torch.zeros_like(a)
    return torch.stack([a, z, z, b, d, z, c, e, f], dim=-1).reshape(M.shape)


def _tri3_solve(L, B):
    """Solve L X = B for lower-triangular (..., 3, 3) L, B (..., 3, K)."""
    x0 = B[..., 0, :] / L[..., 0, 0, None]
    x1 = (B[..., 1, :] - L[..., 1, 0, None] * x0) / L[..., 1, 1, None]
    x2 = (B[..., 2, :] - L[..., 2, 0, None] * x0
          - L[..., 2, 1, None] * x1) / L[..., 2, 2, None]
    return torch.stack([x0, x1, x2], dim=-2)


def schur_matvec(U_d, W, V_inv, cam_idx, pt_idx, buckets, x, group=None):
    """Reduced-camera Schur operator: U_d x - SUM_cam W V_inv Wᵀ x, x [C, PC].
    The observation side and its camera sum are one K1 launch on the card,
    on the rank's own (point-local) rows, then summed over ``group``."""
    return _mv(U_d, x) - _ar(schur_wchain(W, V_inv, x, cam_idx, pt_idx,
                                          buckets), group)


def pcg_on_graph(device, group=None) -> bool:
    """Whether the reduced-camera PCG runs as captured CUDA graphs
    (``pcg.graph_pcg``): on a CUDA device with no process group.  Under a
    group the matvec all-reduces, and the eager loop (``pcg.pcg``) runs."""
    return torch.device(device).type == "cuda" and group is None


def _schur_ops(buckets, U_d, W, V_inv, cam_idx, pt_idx, D_inv):
    """(matvec, precond, recorded) of the single-device reduced-camera
    system for ``pcg.graph_pcg``: the Schur operator, the block-Jacobi
    preconditioner, and K1's count of the launches a replay runs."""
    return (partial(schur_matvec, U_d, W, V_inv, cam_idx, pt_idx, buckets),
            lambda v: _mv(D_inv, v), recorded)


def solve_damped(problem: BlockProblem, sys: NormalSystem, obs: Observations,
                 lam, pcg_iters: int = 100, pcg_tol: float = 1e-5,
                 eps: float = 1e-8, dense_schur: Optional[bool] = None,
                 buckets: tuple = (), group=None):
    """Solve (H + lam diag(H)) dx = g: scalar elimination -> point (Schur)
    elimination -> reduced camera system, by dense Cholesky or by
    block-Jacobi PCG.  Returns (d_cam, d_pt, d_s, cg_iters)."""
    PC = problem.cam_dim
    C = sys.U.shape[0]
    T = sys.V.shape[0]
    if dense_schur is None:
        dense_schur = C * PC <= 2048 and T <= 8192

    U, V, W = sys.U, sys.V, sys.W
    g_cam, g_pt = sys.g_cam, sys.g_pt
    cam_idx, pt_idx = obs.cam_idx, obs.pt_idx

    if problem.has_scales:
        # eliminate the per-observation scalar: damped Hss, rank-1 downdates
        Hss_d = sys.Hss * (1.0 + lam) + eps
        inv_hss = torch.where(sys.Hss > 0, 1.0 / Hss_d,
                              torch.zeros_like(Hss_d))
        ih = inv_hss[:, None, None]
        U_corr = sys.Jc_s[:, :, None] * sys.Jc_s[:, None, :] * ih
        V_corr = sys.Jp_s[:, :, None] * sys.Jp_s[:, None, :] * ih
        W_corr = sys.Jc_s[:, :, None] * sys.Jp_s[:, None, :] * ih
        gc_corr = sys.Jc_s * (inv_hss * sys.g_s)[:, None]
        gp_corr = sys.Jp_s * (inv_hss * sys.g_s)[:, None]
        O = W.shape[0]
        cc = _ar(_seg_by_cam(torch.cat([U_corr.reshape(O, PC * PC), gc_corr],
                                       1), cam_idx, C), group)
        U = U - cc[:, :PC * PC].reshape(C, PC, PC)
        g_cam = g_cam - cc[:, PC * PC:]
        V = V - _seg_by_pt(V_corr, pt_idx, T, buckets)
        g_pt = g_pt - _seg_by_pt(gp_corr, pt_idx, T, buckets)
        W = W - W_corr

    U_d = _damped(U, lam, eps)
    if not problem.has_points:
        d_cam = _mv(torch.linalg.inv(U_d), g_cam)
        d_pt = d_cam.new_zeros((T, 3))
        d_s = _solve_scales(problem, sys, obs, d_cam, d_pt, lam, eps)
        return d_cam, d_pt, d_s, 0

    V_d = _damped(V, lam, eps)
    V_inv = _inv3x3(V_d)
    O = W.shape[0]
    rhs_o = _mv(W, _gather_by_pt(_mv(V_inv, g_pt), pt_idx, buckets, O))

    if dense_schur:
        # exact reduced solve: S = blockdiag(U_d) - Yᵀ Y with
        # Y[3p + k, c*PC + j] = (L_p^{-1} W_oᵀ)[k, j], L_p = chol(V_d)
        rhs = g_cam - _ar(_seg_by_cam(rhs_o, cam_idx, C), group)
        L = _chol3x3(V_d)
        P = _tri3_solve(_gather_by_pt(L, pt_idx, buckets, O),
                        W.transpose(-1, -2))                       # [O, 3, PC]
        n = C * PC
        dev = W.device
        rows = pt_idx.long()[:, None] * 3 + torch.arange(3, device=dev)
        cols = cam_idx.long()[:, None] * PC + torch.arange(PC, device=dev)
        Y = W.new_zeros((3 * T, n))
        Y.index_put_((rows[:, :, None].expand(O, 3, PC),
                      cols[:, None, :].expand(O, 3, PC)), P, accumulate=True)
        # full-precision float32 product on the card: TF32 would keep ~3
        # significant digits of the Schur complement
        with full_f32():
            S = -_ar(Y.T @ Y, group)
        ii = torch.arange(C, device=dev)[:, None, None] * PC
        blk_r = (ii + torch.arange(PC, device=dev)[None, :, None]).expand(C, PC, PC)
        blk_c = (ii + torch.arange(PC, device=dev)[None, None, :]).expand(C, PC, PC)
        S.index_put_((blk_r, blk_c), U_d, accumulate=True)
        S = S + eps * torch.eye(n, dtype=S.dtype, device=dev)
        # as JAX's cho_factor: where rounding leaves S short of positive
        # definite (float32) the step is NaN, which lm_step rejects and
        # damps further, in place of an exception
        chol, info = torch.linalg.cholesky_ex(S)
        d_cam = torch.cholesky_solve(rhs.reshape(n, 1), chol).reshape(C, PC)
        d_cam = torch.where(info == 0, d_cam, torch.nan)
        iters = 0
    else:
        # block-Jacobi preconditioner on the Schur diagonal; its camera
        # reduction and the rhs correction share one index_add_
        Vg = _gather_by_pt(V_inv, pt_idx, buckets, O)             # [O, 3, 3]
        WVi = torch.sum(W[:, :, :, None] * Vg[:, None, :, :], dim=2)
        D_corr = torch.sum(WVi[:, :, None, :] * W[:, None, :, :], -1)
        dc = _ar(_seg_by_cam(torch.cat([D_corr.reshape(O, PC * PC), rhs_o], 1),
                             cam_idx, C), group)
        rhs = g_cam - dc[:, PC * PC:]
        D = U_d - dc[:, :PC * PC].reshape(C, PC, PC)
        D = D + eps * torch.eye(PC, dtype=D.dtype, device=D.device)
        D_inv = torch.linalg.inv(D)

        if pcg_on_graph(W.device, group):
            d_cam, iters = graph_pcg(_schur_ops, buckets,
                                     (U_d, W, V_inv, cam_idx, pt_idx, D_inv),
                                     rhs, max_iters=pcg_iters, tol=pcg_tol)
        else:
            matvec = partial(schur_matvec, U_d, W, V_inv, cam_idx, pt_idx,
                             buckets, group=group)
            d_cam, _, iters = pcg(matvec, rhs, lambda v: _mv(D_inv, v),
                                  max_iters=pcg_iters, tol=pcg_tol)
        _dbg.stat_add("pcg_iters", iters)

    # back-substitute points: d_pt = V^-1 (g_pt - W^T d_cam)
    wtd = _seg_by_pt(_mtv(W, d_cam[cam_idx]), pt_idx, T, buckets)
    d_pt = _mv(V_inv, g_pt - wtd)
    d_s = _solve_scales(problem, sys, obs, d_cam, d_pt, lam, eps)
    return d_cam, d_pt, d_s, iters


def _solve_scales(problem, sys, obs, d_cam, d_pt, lam, eps):
    if not problem.has_scales:
        return d_cam.new_zeros((obs.valid.shape[0], 1))
    Hss_d = sys.Hss * (1.0 + lam) + eps
    inv_hss = torch.where(sys.Hss > 0, 1.0 / Hss_d, torch.zeros_like(Hss_d))
    num = sys.g_s - torch.sum(sys.Jc_s * d_cam[obs.cam_idx], -1) \
        - torch.sum(sys.Jp_s * d_pt[obs.pt_idx], -1)
    return (inv_hss * num)[:, None]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    max_iterations: int = 100
    function_tolerance: float = 5e-4
    window_size: int = 4
    radius_init: float = 1e4      # damping lam = 1 / radius
    radius_max: float = 1e10
    radius_up: float = 2.0        # multiply radius on accept
    radius_down: float = 0.5 ** 4  # multiply radius on reject
    max_rejects: int = 30
    pcg_iters: int = 100
    pcg_tol: float = 1e-5
    solver: str = "auto"          # "auto" | "dense" | "pcg"
    # when set: stop once the accepted relative parameter step stays below
    # step_tol for window_size consecutive iterations (instead of the
    # cost-window ftol test)
    step_tol: float = None


class LMState(NamedTuple):
    params: Params
    lam: torch.Tensor
    cost: torch.Tensor
    # accepted cost DECREASE of the last step (0 on reject), as a sum of
    # per-observation loss differences
    dcost: torch.Tensor
    # relative parameter step ||x_new - x_old|| / ||x_old|| of the last
    # accepted step (0 on reject)
    rstep: torch.Tensor


def _apply_step(problem, params: Params, d_cam, d_pt, d_s) -> Params:
    cam = problem.retract_cam(params.cam, d_cam)
    pts = params.pts + d_pt if problem.has_points else params.pts
    scales = params.scales + d_s * params.scales_free[:, None] \
        if problem.has_scales else params.scales
    return Params(cam, pts, scales, params.scales_free)


def _sq_sum(group, a: Params, b: Params = None):
    """Sum of squares of the float parameters of ``a`` (or of ``a - b``)
    over every rank: the cameras are the same on every rank, the points and
    the scales are the rank's own rows."""
    d = lambda x, y: x if y is None else x - y
    cam = sum(torch.sum(torch.square(d(a.cam[k], None if b is None
                                       else b.cam[k]))) for k in sorted(a.cam))
    pts = torch.sum(torch.square(d(a.pts, None if b is None else b.pts)))
    sc = torch.sum(torch.square(d(a.scales, None if b is None else b.scales)))
    if group is None:
        return cam + pts + sc
    return cam + _ar(pts + sc, group)


@_dbg.traced("lm.step")
def lm_step(problem: BlockProblem, kernel: robust_mod.RobustKernel,
            cfg: LMConfig, state: LMState, obs: Observations,
            buckets: tuple = (), device="cuda", group=None) -> LMState:
    """One LM iteration: build the system once, retry the damped solve with
    increasing damping while the cost gets materially worse (at most
    ``max_rejects`` retries).

    Under a process group (``group``) the solver must be named in ``cfg``
    (``"pcg"`` or ``"dense"``): "auto" would read the rank's own point
    count, and ranks could then choose differently."""
    check_on_device(device, state.params.pts)
    if group is not None and cfg.solver == "auto":
        raise ValueError("lm_step under a process group needs cfg.solver "
                         "'pcg' or 'dense', not 'auto'")
    params = state.params
    with _dbg.span("lm.build"):
        sys = build_system(problem, params, obs, kernel,
                           num_points=params.pts.shape[0], buckets=buckets,
                           group=group)
    dense = None if cfg.solver == "auto" else (cfg.solver == "dense")
    loss_old = sys.loss_vec
    plateau_tol = 0.1 * cfg.function_tolerance

    k = 0
    lam = state.lam
    while True:
        if k > 0:
            lam = lam / cfg.radius_down
        with _dbg.span("lm.solve"):
            d_cam, d_pt, d_s, _ = solve_damped(
                problem, sys, obs, lam, cfg.pcg_iters, cfg.pcg_tol,
                dense_schur=dense, buckets=buckets, group=group)
        with _dbg.span("lm.loss"):
            cand = _apply_step(problem, params, d_cam, d_pt, d_s)
            loss_new = compute_loss_vec(problem, cand, obs, kernel,
                                        buckets=buckets)
            dc = _ar(torch.sum(loss_new - loss_old), group)
        k += 1
        finite = torch.isfinite(dc)
        bad = ~finite | (dc > plateau_tol * sys.cost)
        accepted = finite & (dc <= 0)
        bad_h, accepted_h = _dbg.read("lm.accept",
                                      torch.stack([bad, accepted]))
        if not (bad_h and k <= cfg.max_rejects):
            break
    _dbg.stat_add("lm_tries", k)

    if accepted_h:
        lam_next = torch.clamp_min(lam / cfg.radius_up, 1.0 / cfg.radius_max)
        params_next, cost_next, dcost = cand, sys.cost + dc, dc
        sq = _sq_sum(group, cand, params)
        pq = _sq_sum(group, params)
        rstep = torch.sqrt(sq / torch.clamp_min(pq, 1e-30))
    else:
        # on reject, raise the damping for the next iteration
        lam_next = lam / cfg.radius_down
        params_next, cost_next = params, sys.cost
        dcost = rstep = torch.zeros_like(sys.cost)
    return LMState(params_next, lam_next, cost_next, dcost, rstep)


def optimize(problem: BlockProblem, kernel: robust_mod.RobustKernel,
             cfg: LMConfig, params: Params, obs: Observations,
             verbose: bool = False, buckets: tuple = (), device="cuda",
             step_fn=None):
    """Host-driven LM loop with the reference's termination tests.

    The convergence check lags one iteration behind, as in the JAX package
    (iteration k+1 runs before iteration k's cost is tested), so iteration
    counts match it.  ``step_fn(state, obs)`` replaces the single-device
    ``lm_step``: the sharded step (``parallel/sharded.py``) shares this
    loop, whose tests read only all-reduced scalars.  Returns (final
    LMState, f64 cumulative loss history).
    """
    dev = check_on_device(device, params.pts)
    step = step_fn if step_fn is not None else partial(
        lm_step, problem, kernel, cfg, buckets=buckets, device=dev)
    dtype = params.pts.dtype
    zero = torch.zeros((), dtype=dtype, device=dev)
    state = LMState(params, torch.full((), 1.0 / cfg.radius_init, dtype=dtype,
                                       device=dev),
                    torch.full((), float("inf"), dtype=dtype, device=dev),
                    zero, zero)
    history = []
    rsteps = []
    w = cfg.window_size

    def _converged():
        # equal consecutive cumulative losses: two iterations in a row with
        # exactly zero accepted improvement — terminal
        if len(history) >= 2 and history[-1] == history[-2]:
            return True
        if cfg.step_tol is not None:
            return (len(rsteps) >= w
                    and all(r < cfg.step_tol for r in rsteps[-w:]))
        if len(history) < 2 * w:
            return False
        recent = sum(history[-w:]) / w
        prev = sum(history[-2 * w:-w]) / w
        return prev > 0 and abs((prev - recent) / prev) < cfg.function_tolerance

    def _append(p):
        it, cost, lam, dcost, rstep = p
        # f64 cumulative loss: the absolute cost first, then the accepted
        # differential improvements
        if history:
            history.append(max(history[-1] + dcost, 0.0))
        else:
            history.append(cost)
        rsteps.append(rstep)
        if verbose:
            print(f"  lm iter {it:3d}  loss {history[-1]:.9e}  lam {lam:.3e}")

    pending = None
    t_step = time.perf_counter()
    for it in range(cfg.max_iterations):
        state = step(state, obs)
        # the readback waits for the step: host seconds per LM step
        current = (it, *map(float, _dbg.read("lm.history", torch.stack(
            [state.cost, state.lam, state.dcost, state.rstep]).double())))
        now = time.perf_counter()
        _dbg.stat_add("lm_step_s", now - t_step)
        t_step = now
        if pending is not None:
            _append(pending)
            if _converged():
                break
        pending = current
    if pending is not None and (not history or pending[0] > len(history) - 1):
        _append(pending)
    return state, history
