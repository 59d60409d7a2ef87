"""Rotation averaging: MST init -> L1 (ADMM) -> IRLS, on torch tensors.

Counterpart of ``instantsfm_tpu/pipeline/rotation_averaging.py``.  The
normal matrix AᵀWA of the pairwise system is a weighted graph Laplacian ⊗ I₃
(rows are ±I₃ per pair plus one anchor row), so every inner solve is a
Jacobi-preconditioned CG with a matrix-free Laplacian operator.

Conventions:
* unknowns: tangent-space steps of world->cam rotations, 3 dof per image;
* pair residual: -Log(R_jᵀ R_ij R_i) where R_ij maps cam_i -> cam_j;
* anchor: one extra row pinning the first registered camera;
* update: R_i <- R_i · Exp(-step_i);
* IRLS weight: Geman–McClure  σ² / (s + σ²)²  on squared pair residuals.

The JAX package runs the whole schedule as nested ``lax.while_loop``s on
the device.  Here the CG iterations, by far the most numerous, run in
blocks of ``CG_BLOCK`` with the state frozen once the exit test fires
(``utils/loops.py``), one host read per block; the L1, ADMM and IRLS loops
read their exit test once an iteration.  The reads are counted (``debug``
stat ``ra_syncs``) and go through ``utils/debug.read`` at the sites
``ra.cg``, ``ra.admm``, ``ra.l1`` and ``ra.irls``, with the result's read
``ra.result``.  Spans: ``ra.mst`` (the host's spanning-tree start), each
L1 round ``ra.l1``, ADMM iteration ``ra.admm``, CG solve ``ra.cg`` and
IRLS round ``ra.irls``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from instantsfm_tpu_torch.math import lie
from instantsfm_tpu_torch.parallel import multihost
from instantsfm_tpu_torch.scene.types import Images, ViewGraph
from instantsfm_tpu_torch.utils import debug as _dbg
from instantsfm_tpu_torch.utils.device import resolve_device
from instantsfm_tpu_torch.utils.loops import SyncCounter, while_blocked

CG_BLOCK = 16


# --------------------------------------------------------------------- host

def _mst_init(view_graph: ViewGraph, images: Images) -> None:
    """Spanning-tree initialization of global rotations: maximum spanning
    tree on inlier counts, then BFS composition, batched per BFS level."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order, minimum_spanning_tree

    n = images.num_images
    mask = view_graph.valid & images.registered[view_graph.pair_i] \
        & images.registered[view_graph.pair_j]
    ei, ej = view_graph.pair_i[mask], view_graph.pair_j[mask]
    w = view_graph.num_inliers_per_pair()[mask].astype(np.float64)
    if len(ei) == 0:
        return
    # max spanning tree == min spanning tree on negated weights
    g = sp.coo_matrix((-w - 1.0, (ei, ej)), shape=(n, n)).tocsr()
    mst = minimum_spanning_tree(g)
    mst = mst + mst.T
    root = int(ei[0])
    order, pred = breadth_first_order(mst, root, directed=False,
                                      return_predecessors=True)

    # edge lookup: (min, max) -> edge row for relative quats
    key = ei.astype(np.int64) * n + ej
    edge_row = dict(zip(map(int, key), map(int, np.nonzero(mask)[0])))

    def npq_conj(q):
        return np.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)

    def npq_mul(q1, q2):
        x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
        x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
        return np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], axis=-1)

    # depth of each node (parents precede children in BFS order)
    depth = np.zeros(n, np.int64)
    items = []  # (depth, node, row, flip)
    for node in order:
        parent = pred[node]
        if parent < 0 or node == root:
            continue
        depth[node] = depth[parent] + 1
        a, b = (node, parent) if node < parent else (parent, node)
        row = edge_row.get(int(a) * n + int(b))
        if row is None:
            continue
        items.append((depth[node], node, row, view_graph.pair_i[row] == node))

    q = images.qvec.copy()
    if items:
        arr = np.array([(d, nd, r, f) for d, nd, r, f in items], np.int64)
        for d in range(1, int(arr[:, 0].max()) + 1):
            lvl = arr[arr[:, 0] == d]
            nodes_l, rows_l, flip_l = lvl[:, 1], lvl[:, 2], lvl[:, 3] == 1
            q_rel = view_graph.qvec[rows_l]
            qp = q[pred[nodes_l]]
            # flip: R_parent = R_rel R_node => R_node = R_rel^-1 R_parent
            q_rel = np.where(flip_l[:, None], npq_conj(q_rel), q_rel)
            q[nodes_l] = npq_mul(q_rel, qp)
    images.qvec = q


# ------------------------------------------------------------------- device

class _RAData(NamedTuple):
    q: torch.Tensor         # [Nr, 4] current rotations (registered subset)
    ei: torch.Tensor        # [E] edge endpoint 1 (dense subset index)
    ej: torch.Tensor        # [E]
    q_rel: torch.Tensor     # [E, 4]
    anchor: int             # dense index of the anchored image
    q_anchor: torch.Tensor  # [4]


def _fro(x):
    return torch.sqrt(torch.sum(x * x))


def _residuals(q, data: _RAData):
    """[E+1, 3]: pair residuals then anchor residual."""
    q_i = q[data.ei]
    q_j = q[data.ej]
    r_pair = -lie.so3_log(lie.quat_mul(lie.quat_conj(q_j),
                                       lie.quat_mul(data.q_rel, q_i)))
    r_anchor = lie.so3_log(lie.quat_mul(lie.quat_conj(data.q_anchor),
                                        q[data.anchor]))
    return torch.cat([r_pair, r_anchor[None]], dim=0)


def _A_mv(x, data):
    """A x: per-edge x_j - x_i, plus the anchor row."""
    rows = x[data.ej] - x[data.ei]
    return torch.cat([rows, x[data.anchor][None]], dim=0)


def _At_mv(y, data, n):
    """Aᵀ y."""
    out = y.new_zeros((n,) + y.shape[1:]).index_add_(0, data.ej, y[:-1])
    out = out - y.new_zeros((n,) + y.shape[1:]).index_add_(0, data.ei, y[:-1])
    out[data.anchor] += y[-1]
    return out


def _AtWA_mv(x, w, data, n):
    return _At_mv(w[:, None] * _A_mv(x, data), data, n)


def _jacobi_diag(w, data, n):
    """diag(AᵀWA) per node (same for all 3 coords)."""
    d = w.new_zeros(n).index_add_(0, data.ei, w[:-1])
    d = d + w.new_zeros(n).index_add_(0, data.ej, w[:-1])
    d[data.anchor] += w[-1]
    return d


@_dbg.traced("ra.cg")
def _cg(w, rhs, data, n, x0, iters, syncs, tol=1e-10):
    diag = _jacobi_diag(w, data, n)
    inv_diag = torch.where(diag > 0, 1.0 / diag, torch.zeros_like(diag))[:, None]
    mv = lambda x: _AtWA_mv(x, w, data, n)
    thr = tol * tol * torch.sum(rhs * rhs)
    zero = torch.zeros((), dtype=rhs.dtype, device=rhs.device)
    one = torch.ones((), dtype=rhs.dtype, device=rhs.device)

    def cond(s):
        x, r, z, p, gamma, k = s
        return (k < iters) & (torch.sum(r * r) > thr)

    def body(s):
        x, r, z, p, gamma, k = s
        ap = mv(p)
        denom = torch.sum(p * ap)
        alpha = torch.where(denom == 0, zero,
                            gamma / torch.where(denom == 0, one, denom))
        x = x + alpha * p
        r = r - alpha * ap
        z = r * inv_diag
        g2 = torch.sum(r * z)
        beta = torch.where(gamma == 0, zero,
                           g2 / torch.where(gamma == 0, one, gamma))
        return x, r, z, z + beta * p, g2, k + 1

    r0 = rhs - mv(x0)
    z0 = r0 * inv_diag
    k0 = torch.zeros((), dtype=torch.int32, device=rhs.device)
    x, *_ = while_blocked(cond, body, (x0, r0, z0, z0, torch.sum(r0 * z0), k0),
                          CG_BLOCK, syncs, "cg")
    return x


def _update_rotations(q, step):
    """R_i <- R_i · Exp(-step_i)."""
    return lie.quat_normalize(lie.quat_mul(q, lie.so3_exp(-step)))


def _admm_l1(w_ones, b, data, n, x0, rho, alpha, admm_iters, cg_iters,
             abs_tol, rel_tol, syncs):
    """ADMM for min ||A x - b||_1, CG in place of a cached factorization."""
    E1 = b.shape[0]
    b_norm = _fro(b)
    pri_eps0 = math.sqrt(3.0 * E1) * abs_tol
    dua_eps0 = math.sqrt(3.0 * n) * abs_tol
    x, z, u = x0, torch.zeros_like(b), torch.zeros_like(b)
    kappa = 1.0 / rho
    for _ in range(admm_iters):
        with _dbg.span("ra.admm"):
            rhs = _At_mv(b + z - u, data, n)
            x = _cg(w_ones, rhs, data, n, x, cg_iters, syncs)
            ax = _A_mv(x, data)
            ax_hat = alpha * ax + (1 - alpha) * (z + b)
            z_old = z
            v = ax_hat - b + u
            z = torch.clamp_min(v - kappa, 0.0) \
                - torch.clamp_min(-v - kappa, 0.0)
            u = u + ax_hat - z - b
            r_norm = _fro(ax - z - b)
            s_norm = _fro(rho * _At_mv(z - z_old, data, n))
            max_norm = torch.maximum(torch.maximum(_fro(ax), _fro(z)), b_norm)
            pri_eps = pri_eps0 + rel_tol * max_norm
            dua_eps = dua_eps0 + rel_tol * _fro(rho * _At_mv(u, data, n))
            done = syncs.read("admm", (r_norm < pri_eps) & (s_norm < dua_eps))
        if done:
            break
    return x


def _ra_core(data: _RAData, n: int, opts: tuple, syncs: SyncCounter):
    """Full L1 + IRLS schedule; returns refined quaternions."""
    (max_l1, l1_conv, max_irls, irls_conv, sigma_deg,
     l1_rho, l1_alpha, l1_abs, l1_rel) = opts
    E = data.ei.shape[0]
    dt, dev = data.q.dtype, data.q.device
    w_ones = torch.ones(E + 1, dtype=dt, device=dev)

    # ---------------- L1 stage ----------------------------------------------
    q = data.q
    last_norm = torch.zeros((), dtype=dt, device=dev)
    admm_iters = 10
    for _ in range(max_l1):
        with _dbg.span("ra.l1"):
            b = _residuals(q, data)
            step = _admm_l1(w_ones, b, data, n,
                            torch.zeros((n, 3), dtype=dt, device=dev),
                            l1_rho, l1_alpha, admm_iters, 100, l1_abs, l1_rel,
                            syncs)
            curr_norm = _fro(step)
            q = _update_rotations(q, step)
            avg_step = torch.mean(torch.sqrt(torch.sum(step * step, dim=-1)))
            done = (avg_step < l1_conv) \
                | (torch.abs(last_norm - curr_norm) < 1e-6)
            last_norm = curr_norm
            admm_iters = min(admm_iters * 2, 100)
            done = syncs.read("l1", done)
        if done:
            break

    # ---------------- IRLS stage --------------------------------------------
    sigma = math.radians(sigma_deg)
    for _ in range(max_irls):
        with _dbg.span("ra.irls"):
            b = _residuals(q, data)
            s_sq = torch.sum(b[:-1] ** 2, dim=-1)
            w_pair = sigma ** 2 / (s_sq + sigma ** 2) ** 2
            w = torch.cat([w_pair, torch.ones(1, dtype=dt, device=dev)])
            rhs = _At_mv(w[:, None] * b, data, n)
            step = _cg(w, rhs, data, n,
                       torch.zeros((n, 3), dtype=dt, device=dev), 200, syncs)
            q = _update_rotations(q, step)
            avg_step = torch.mean(torch.sqrt(torch.sum(step * step, dim=-1)))
            done = syncs.read("irls", avg_step < irls_conv)
        if done:
            break
    return q


# ---------------------------------------------------------------- stage API

def estimate_rotations(view_graph: ViewGraph, images: Images,
                       ra_opts: dict, l1_opts: dict, dtype=torch.float64,
                       device="cuda") -> bool:
    """Full rotation-averaging stage; updates ``images.qvec`` in place."""
    dev = resolve_device(device)
    with _dbg.span("ra.mst"):
        _mst_init(view_graph, images)

    reg = images.registered
    reg_idx = np.nonzero(reg)[0]
    if len(reg_idx) == 0:
        return False
    dense = -np.ones(images.num_images, np.int64)
    dense[reg_idx] = np.arange(len(reg_idx))

    mask = view_graph.valid & reg[view_graph.pair_i] & reg[view_graph.pair_j]
    ei = dense[view_graph.pair_i[mask]]
    ej = dense[view_graph.pair_j[mask]]
    if len(ei) == 0:
        return False
    q0 = images.qvec[reg_idx]

    t = lambda a, dt=dtype: torch.as_tensor(np.ascontiguousarray(a),
                                            device=dev).to(dt)
    data = _RAData(q=t(q0), ei=t(ei, torch.int64), ej=t(ej, torch.int64),
                   q_rel=t(view_graph.qvec[mask]), anchor=0, q_anchor=t(q0[0]))
    opts = (int(ra_opts["max_num_l1_iterations"]),
            float(ra_opts["l1_step_convergence_threshold"]),
            int(ra_opts["max_num_irls_iterations"]),
            float(ra_opts["irls_step_convergence_threshold"]),
            float(ra_opts["irls_loss_parameter_sigma"]),
            float(l1_opts["rho"]), float(l1_opts["alpha"]),
            float(l1_opts["absolute_tolerance"]),
            float(l1_opts["relative_tolerance"]))
    syncs = SyncCounter("ra")
    q = _ra_core(data, len(reg_idx), opts, syncs)
    _dbg.stat_add("ra_syncs", dict(syncs.counts))
    # under a process group every rank solves; all take rank 0's result
    q, = multihost.broadcast_host_arrays(
        _dbg.read("ra.result", q).astype(np.float64))
    if not np.all(np.isfinite(q)):
        return False
    images.qvec[reg_idx] = q
    return True
