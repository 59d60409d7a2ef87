"""View-graph calibration: focal estimation from F matrices (Fetzer method).

Counterpart of ``instantsfm_tpu/pipeline/vgc.py``:
* per pair, ``ds`` coefficient vectors from the SVD of G = K1ᵀ F K0, both
  pair directions;
* the Fetzer residual per pair, Cauchy robust kernel, trust-region LM over
  one focal per camera with a dense [C, C] normal system;
* focal rejection outside [thres_lower_ratio, thres_higher_ratio] and pair
  filtering by two-view error.

The LM iterations run in blocks of ``VGC_BLOCK`` with the state frozen once
the exit test fires (``utils/loops.py``); the damping retry loop inside an
iteration reads its test before each retry, as it rarely runs.  Spans:
``vgc.prepare`` (the coefficients), ``vgc.solve`` (the LM loop; its reads
``vgc.vgc`` and ``vgc.vgc_retry``, counted in the stat ``vgc_syncs``, and
the result's ``vgc.result``) and ``vgc.filter``.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math.epipolar import svd3x3
from instantsfm_tpu_torch.parallel import multihost
from instantsfm_tpu_torch.scene.types import (CONFIG_CALIBRATED,
                                              CONFIG_UNCALIBRATED, Cameras,
                                              Images, ViewGraph)
from instantsfm_tpu_torch.solve import robust
from instantsfm_tpu_torch.utils import debug as _dbg
from instantsfm_tpu_torch.utils.device import resolve_device
from instantsfm_tpu_torch.utils.loops import SyncCounter, while_blocked

VGC_BLOCK = 8


def _fetzer_ds(G):
    """Batched coefficient precompute.  G: [..., 3, 3] -> ds [..., 3, 4]
    rows (d_01, d_02, d_12)."""
    U, s, V = svd3x3(G)
    v0, v1 = V[..., :, 0], V[..., :, 1]
    u0, u1 = U[..., :, 0], U[..., :, 1]
    s0, s1 = s[..., 0], s[..., 1]

    ai = torch.stack([s0 * s0 * (v0[..., 0] ** 2 + v0[..., 1] ** 2),
                      s0 * s1 * (v0[..., 0] * v1[..., 0] + v0[..., 1] * v1[..., 1]),
                      s1 * s1 * (v1[..., 0] ** 2 + v1[..., 1] ** 2)], dim=-1)
    aj = torch.stack([u1[..., 0] ** 2 + u1[..., 1] ** 2,
                      -(u0[..., 0] * u1[..., 0] + u0[..., 1] * u1[..., 1]),
                      u0[..., 0] ** 2 + u0[..., 1] ** 2], dim=-1)
    bi = torch.stack([s0 * s0 * v0[..., 2] ** 2,
                      s0 * s1 * v0[..., 2] * v1[..., 2],
                      s1 * s1 * v1[..., 2] ** 2], dim=-1)
    bj = torch.stack([u1[..., 2] ** 2,
                      -(u0[..., 2] * u1[..., 2]),
                      u0[..., 2] ** 2], dim=-1)

    def d(u, v):
        return torch.stack([ai[..., u] * aj[..., v] - ai[..., v] * aj[..., u],
                            ai[..., u] * bj[..., v] - ai[..., v] * bj[..., u],
                            bi[..., u] * aj[..., v] - bi[..., v] * aj[..., u],
                            bi[..., u] * bj[..., v] - bi[..., v] * bj[..., u]],
                           dim=-1)

    return torch.stack([d(1, 0), d(0, 2), d(2, 1)], dim=-2)


def _fetzer_residual(fi, fj, ds):
    """Fetzer cost per pair: fi, fj [E]; ds [E, 3, 4].  Returns [E, 2]."""
    small = torch.full_like(fi, 1e-6)
    di = fj * fj * ds[:, 0, 0] + ds[:, 0, 1]
    dj = fi * fi * ds[:, 2, 0] + ds[:, 2, 2]
    di = torch.where(di == 0, small, di)
    dj = torch.where(dj == 0, small, dj)
    K0_01 = -(fj * fj * ds[:, 0, 2] + ds[:, 0, 3]) / di
    K1_12 = -(fi * fi * ds[:, 2, 1] + ds[:, 2, 3]) / dj
    return torch.stack([(fi * fi - K0_01) / (fi * fi),
                        (fj * fj - K1_12) / (fj * fj)], dim=-1)


def _residual_and_jacobian(f, ds, ci, cj):
    """Residuals [E, 2] and their Jacobian [E, 2, 2] in (f_i, f_j) by
    forward-mode differentiation."""
    fij = torch.stack([f[ci], f[cj]], dim=-1)
    res = lambda x, d: _fetzer_residual(x[None, 0], x[None, 1], d[None])[0]
    J = torch.func.vmap(torch.func.jacfwd(res))(fij, ds)
    return _fetzer_residual(fij[:, 0], fij[:, 1], ds), J


def _vgc_solve(focals0, ds, ci, cj, num_cams: int, max_iters: int,
               cauchy_thres: float, ftol: float, syncs: SyncCounter):
    kernel = robust.cauchy(cauchy_thres)
    C = num_cams
    dt, dev = focals0.dtype, focals0.device
    eye = torch.eye(C, dtype=dt, device=dev)

    def build(f):
        r, J = _residual_and_jacobian(f, ds, ci, cj)
        s = torch.sum(r * r, dim=-1)
        w = kernel.weight(s)
        cost = torch.sum(kernel.loss(s))
        sw = torch.sqrt(w)[:, None]
        r = r * sw
        J = J * sw[..., None]
        Jii = torch.sum(J[..., 0] * J[..., 0], dim=-1)
        Jjj = torch.sum(J[..., 1] * J[..., 1], dim=-1)
        Jij = torch.sum(J[..., 0] * J[..., 1], dim=-1)
        JTJ = f.new_zeros(C * C)
        JTJ.index_add_(0, ci * C + ci, Jii).index_add_(0, cj * C + cj, Jjj)
        JTJ.index_add_(0, ci * C + cj, Jij).index_add_(0, cj * C + ci, Jij)
        g = f.new_zeros(C)
        g.index_add_(0, ci, -torch.sum(J[..., 0] * r, dim=-1))
        g.index_add_(0, cj, -torch.sum(J[..., 1] * r, dim=-1))
        return JTJ.reshape(C, C), g, cost

    def cost_only(f):
        r = _fetzer_residual(f[ci], f[cj], ds)
        return torch.sum(kernel.loss(torch.sum(r * r, dim=-1)))

    def step(state):
        f, lam, cost, k, done = state
        JTJ, g, cost0 = build(f)
        diag = torch.diagonal(JTJ)

        def try_lam(l):
            A = JTJ + torch.diag(l * diag + 1e-12)
            f_new = torch.clamp_min(f + torch.linalg.solve(A, g), 1e-3)
            return f_new, cost_only(f_new)

        # damping retries while the trial is not finite or raises the cost
        def rcond(c):
            kk, l, fc, cc = c
            return (kk < 30) & (~torch.isfinite(cc) | (cc > cost0))

        def rbody(c):
            kk, l, fc, cc = c
            l = l * 16.0
            fn, cn = try_lam(l)
            return kk + 1, l, fn, cn

        f1, c1 = try_lam(lam)
        _, lam2, f2, c2 = while_blocked(rcond, rbody, (torch.zeros_like(k), lam,
                                                       f1, c1),
                                        1, syncs, "vgc_retry", check_first=True)
        accept = torch.isfinite(c2) & (c2 <= cost0)
        f = torch.where(accept, f2, f)
        lam = torch.where(accept, torch.clamp_min(lam2 / 2.0, 1e-10), lam2)
        rel = torch.abs(cost0 - c2) / torch.clamp_min(cost0, 1e-30)
        done = accept & (rel < ftol)
        return f, lam, c2, k + 1, done

    def cond(state):
        f, lam, cost, k, done = state
        return (k < max_iters) & (~done)

    state = (focals0, torch.tensor(1e-2, dtype=dt, device=dev),
             torch.tensor(float("inf"), dtype=dt, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev))
    f = while_blocked(cond, step, state, VGC_BLOCK, syncs, "vgc")[0]
    r_final = _fetzer_residual(f[ci], f[cj], ds)
    return f, torch.sum(r_final * r_final, dim=-1)


def solve_view_graph_calibration(view_graph: ViewGraph, cameras: Cameras,
                                 images: Images, opts: dict,
                                 dtype=torch.float64, device="cuda") -> None:
    dev = resolve_device(device)
    mask = view_graph.valid & np.isin(view_graph.config,
                                      (CONFIG_CALIBRATED, CONFIG_UNCALIBRATED))
    rows = np.nonzero(mask)[0]
    if len(rows) == 0:
        return
    ds, focals0, ci, cj = _prepare(view_graph, cameras, images, rows, dtype,
                                   dev)
    syncs = SyncCounter("vgc")
    with _dbg.span("vgc.solve"):
        f, pair_err_sq = _vgc_solve(
            focals0, ds, ci, cj, num_cams=cameras.num_cameras,
            max_iters=int(opts["max_num_iterations"]),
            cauchy_thres=float(opts["thres_loss_function"]),
            ftol=float(opts["function_tolerance"]), syncs=syncs)
        _dbg.stat_add("vgc_syncs", dict(syncs.counts))
        f, pair_err_sq = _dbg.read("vgc.result", (f, pair_err_sq))
    # under a process group every rank solves; all take rank 0's result
    f, pair_err_sq = multihost.broadcast_host_arrays(
        f.astype(np.float64), pair_err_sq.astype(np.float64))
    _filter(view_graph, cameras, rows, f, pair_err_sq, opts)


@_dbg.traced("vgc.prepare")
def _prepare(view_graph, cameras, images, rows, dtype, dev):
    """The Fetzer coefficients of both directions of every pair, the start
    focals and the pairs' cameras, on the device."""
    cam_i = images.cam_idx[view_graph.pair_i[rows]]
    cam_j = images.cam_idx[view_graph.pair_j[rows]]
    pp_i = np.stack([cameras.principal_point(c) for c in cam_i])
    pp_j = np.stack([cameras.principal_point(c) for c in cam_j])
    F = view_graph.F_mat[rows]

    def K(pp):
        k = np.tile(np.eye(3), (len(pp), 1, 1))
        k[:, 0, 2] = pp[:, 0]
        k[:, 1, 2] = pp[:, 1]
        return k

    G = np.einsum("eji,ejk,ekl->eil", K(pp_j), F, K(pp_i))  # K1ᵀ F K0
    # both directions; the reverse is Gᵀ
    G_all = np.concatenate([G, np.transpose(G, (0, 2, 1))])
    ci = np.concatenate([cam_i, cam_j]).astype(np.int64)
    cj = np.concatenate([cam_j, cam_i]).astype(np.int64)

    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a),
                                            device=dev).to(dt)
    focals0 = np.array([cameras.focal(c) for c in range(cameras.num_cameras)])
    return (_fetzer_ds(t(G_all)), t(focals0), t(ci, torch.int64),
            t(cj, torch.int64))


@_dbg.traced("vgc.filter")
def _filter(view_graph, cameras, rows, f, pair_err_sq, opts):
    """Focal rejection and the pairs' two-view error filter."""
    # ---- focal rejection
    for c in range(cameras.num_cameras):
        ratio = f[c] / max(cameras.focal(c), 1e-12)
        if ratio < float(opts["thres_lower_ratio"]) \
                or ratio > float(opts["thres_higher_ratio"]):
            continue
        cameras.has_refined_focal[c] = True
        cameras.set_focal(c, f[c])

    # ---- pair filtering by two-view error (forward direction residual)
    bad = pair_err_sq[: len(rows)] > float(opts["thres_two_view_error"]) ** 2
    view_graph.valid[rows[bad]] = False
