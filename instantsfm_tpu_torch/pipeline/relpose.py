"""Relative pose estimation: batched RANSAC over (pairs x hypotheses).

Counterpart of ``instantsfm_tpu/pipeline/relpose.py``.  The pairs of a
chunk are estimated together with a fixed hypothesis budget over masked,
padded match arrays: minimal samples -> candidate models -> inlier counts
(Sampson error, or transfer error for H) -> best model -> two local
optimization rounds (8-point on the inliers) -> pose by cheirality voting.

* E is estimated for every pair on undistorted z=1 coords (threshold 1e-3),
  by the Nistér 5-point solver by default (8-point with
  ``five_point=False``);
* UNCALIBRATED pairs also estimate F on pixel coords (3 px) and use F's
  inliers; PLANAR/PANORAMIC pairs use H's inliers (3 px);
* pairs whose config is not estimable are invalidated.

Random draws.  Each RANSAC core takes its uniforms ``u [P, H, k]`` as an
argument.  Pairs are grouped by ``_bucket`` of their match count and cut
into chunks of ``chunk_pairs`` (the JAX package's schedule); chunk k draws
``u`` for E of shape [chunk_pairs, H, k] (padded pairs included), then F's
and H's for its uncalibrated and planar pairs.  By default each (chunk,
model) draws from its own CPU ``torch.Generator``, seeded from ``seed``,
the chunk and the model, and moved to the device, so that a chunk's draws
do not depend on which process computes it or on the chunks before it;
``uniforms(chunk, model, shape)`` replaces them (model "E", "F" or "H"),
e.g. with the JAX package's own draws.

Scoring keeps the JAX package's bounded memory (at most
``_SCORE_BUDGET_ELTS`` Sampson terms at once) and its preemptive pass (all
candidates on a strided 256-match subset, then the top survivors on every
match).  Ties go to the lowest candidate index, as ``jnp.argmax`` and
``lax.top_k`` give them (``torch.argmax`` and a stable descending sort).
Only the real pairs of a chunk are computed: every pair's estimate depends
on its own matches and draws alone.

In a group of several processes each process estimates the chunks it
owns (chunk k belongs to rank k mod the process count); each chunk's
owner then sends its [P, 34] float64 estimates (E, q, t, F, H) and its
[P, M/8] uint8 mask bits to every process over the host group
(``parallel.multihost``), and every process writes every chunk back.  The
JAX package exchanges E, q and t only, so there F and H stay on the
process that estimated them; here every process ends with the same view
graph.

Spans (``utils/debug``): ``relpose.undistort``; per chunk ``relpose.chunk``
with ``relpose.pack`` (the padded match arrays), ``relpose.draw`` (the
uniforms), ``relpose.fivepoint`` (samples and hypotheses; or
``relpose.eightpoint``), ``relpose.score`` (the candidates' inlier counts),
``relpose.refine`` (local optimisation and the final inliers),
``relpose.homography``, ``relpose.recover_pose``; then
``relpose.writeback``.  Host reads: ``relpose.undistort``, ``relpose.F``,
``relpose.H``, ``relpose.writeback`` and, across processes,
``relpose.exchange``.
"""

from __future__ import annotations

import numpy as np
import torch

from instantsfm_tpu_torch.math import epipolar, fivepoint, lie
from instantsfm_tpu_torch.parallel import multihost
from instantsfm_tpu_torch.scene import cameras as cam_models
from instantsfm_tpu_torch.scene.types import (CONFIG_CALIBRATED, CONFIG_PANORAMIC,
                                              CONFIG_PLANAR,
                                              CONFIG_PLANAR_OR_PANORAMIC,
                                              CONFIG_UNCALIBRATED, Cameras,
                                              Images, ViewGraph)
from instantsfm_tpu_torch.utils.debug import read, span
from instantsfm_tpu_torch.utils.device import resolve_device

_ESTIMABLE = (CONFIG_PLANAR, CONFIG_PANORAMIC, CONFIG_PLANAR_OR_PANORAMIC,
              CONFIG_UNCALIBRATED, CONFIG_CALIBRATED)

# peak elements per scoring chunk: P * candidates * M Sampson terms
_SCORE_BUDGET_ELTS = 32 * 1024 * 1024

# preemptive scoring: subset size and base survivor count of the two-stage
# path (all candidates scored on SUBSET matches, the top survivors on all)
_PRESCORE_SUBSET = 256
_PRESCORE_TOPK = 16

# max matches per pair used for model ESTIMATION (sampling, scoring, LO,
# pose voting); final inlier/cheirality masks always use every match
_ESTIMATE_CAP = 4096


def undistort_images(cameras: Cameras, images: Images, device="cuda") -> None:
    """Unit bearings for every keypoint (``images.kp_bearing``, float64),
    computed on the device in float64.  Calls with unchanged intrinsics are
    cached: the mapper undistorts again before GP although nothing after the
    first call touches the params."""
    if images.num_images == 0:
        return
    dev = resolve_device(device)
    model_id = cameras.uniform_model_id
    key = (int(model_id), len(images.kp_xy), hash(cameras.params.tobytes()))
    if getattr(images, "_undistort_key", None) == key \
            and images.kp_bearing is not None:
        return
    with span("relpose.undistort"):
        kp_img = np.repeat(np.arange(images.num_images),
                           np.diff(images.kp_offset))
        params = torch.as_tensor(cameras.params, dtype=torch.float64,
                                 device=dev)
        cam_of_kp = torch.as_tensor(images.cam_idx[kp_img].astype(np.int64),
                                    device=dev)
        xy = torch.as_tensor(images.kp_xy, dtype=torch.float64, device=dev)
        b = cam_models.bearing_from_img(model_id, params[cam_of_kp], xy)
        images.kp_bearing = read("relpose.undistort", b)
    images._undistort_key = key


# ------------------------------------------------------------ RANSAC cores

def _candidate_counts(err_fn, cand, cok, x1, x2, valid, thresh_sq):
    """Inlier count of every candidate: [P, N] int32, -1 where invalid.
    Candidates are scored in chunks of at most _SCORE_BUDGET_ELTS terms."""
    P, N = cok.shape
    M = x1.shape[1]
    step = max(1, _SCORE_BUDGET_ELTS // max(P * M, 1))
    out = []
    for lo in range(0, N, step):
        err = err_fn(cand[:, lo:lo + step], x1[:, None], x2[:, None])
        cnt = torch.sum((err < thresh_sq) & valid[:, None], dim=-1,
                        dtype=torch.int32)
        out.append(torch.where(cok[:, lo:lo + step], cnt,
                               torch.full_like(cnt, -1)))
    return torch.cat(out, dim=1)


def _score_best(err_fn, cand, cok, x1, x2, valid, thresh_sq):
    """Best candidate per pair: (model [P, 3, 3], count [P]).

    cand [P, N, 3, 3], cok [P, N].  With a long match axis and many
    candidates, all candidates are first scored on a strided match subset
    and only the top survivors on every match.  The first best wins; a pair
    with no valid candidate gets the identity and count -1."""
    P, N = cok.shape
    M = x1.shape[1]
    # survivors scale with the pool, capped at 4x the base
    topk = min(4 * _PRESCORE_TOPK, max(_PRESCORE_TOPK, N // 64))
    if M >= 2 * _PRESCORE_SUBSET and N > 4 * topk:
        sub = torch.arange(_PRESCORE_SUBSET, device=x1.device) \
            * (M // _PRESCORE_SUBSET)
        cnt_sub = _candidate_counts(err_fn, cand, cok, x1[:, sub], x2[:, sub],
                                    valid[:, sub], thresh_sq)
        top = torch.sort(cnt_sub, dim=-1, descending=True,
                         stable=True)[1][:, :topk]                 # [P, K]
        cand = torch.take_along_dim(cand, top[:, :, None, None], dim=1)
        cok = torch.take_along_dim(cok, top, dim=1)
    cnt = _candidate_counts(err_fn, cand, cok, x1, x2, valid, thresh_sq)
    best = torch.argmax(cnt, dim=-1)
    best_cnt = torch.take_along_dim(cnt, best[:, None], dim=-1)[:, 0]
    best_E = torch.take_along_dim(cand, best[:, None, None, None], dim=1)[:, 0]
    eye = torch.eye(3, dtype=cand.dtype, device=cand.device)
    return torch.where((best_cnt >= 0)[:, None, None], best_E, eye), best_cnt


def _samples(x1, x2, valid, u):
    """Minimal samples drawn by the uniforms u [P, H, k]: [P, H, k, 2] each."""
    P, M = valid.shape
    counts = torch.sum(valid, dim=-1).clamp_min(1)
    idx = torch.clamp_max((u * counts[:, None, None]).to(torch.int64), M - 1)
    rows = torch.arange(P, device=x1.device)[:, None, None]
    return x1[rows, idx], x2[rows, idx]


def _local_opt(model, inliers, x1, x2, valid, thresh_sq, essential):
    """Two LO rounds: re-estimate by 8-point from the inliers, keep the new
    model where it has more inliers."""
    for _ in range(2):
        new = epipolar.eight_point(x1, x2, inliers, essential)
        new_inl = (epipolar.sampson_error(new, x1, x2) < thresh_sq) & valid
        better = torch.sum(new_inl, -1) > torch.sum(inliers, -1)
        model = torch.where(better[:, None, None], new, model)
        inliers = torch.where(better[:, None], new_inl, inliers)
    return model, inliers


def _ransac_fundamental_like(x1, x2, valid, u, thresh_sq, essential: bool):
    """RANSAC for E (normalized coords) or F (pixels) from 8-point samples.

    x1, x2: [P, M, 2]; valid: [P, M]; u: [P, H, 8].
    Returns (F [P, 3, 3], inliers [P, M])."""
    with span("relpose.eightpoint"):
        s1, s2 = _samples(x1, x2, valid, u)
        F_h = epipolar.eight_point(
            s1, s2, torch.ones(u.shape, dtype=torch.bool, device=u.device),
            essential)
    with span("relpose.score"):
        F, _ = _score_best(epipolar.sampson_error, F_h,
                           torch.ones(u.shape[:2], dtype=torch.bool,
                                      device=u.device),
                           x1, x2, valid, thresh_sq)
    with span("relpose.refine"):
        inliers = (epipolar.sampson_error(F, x1, x2) < thresh_sq) & valid
        return _local_opt(F, inliers, x1, x2, valid, thresh_sq, essential)


def _ransac_essential_5pt(x1, x2, valid, u, thresh_sq):
    """Minimal 5-point RANSAC for E: each hypothesis yields up to
    ``fivepoint.NUM_ROOT_SLOTS`` candidates, all scored; the winner's inlier
    set seeds two LO rounds.  u: [P, H, 5]."""
    P, H = u.shape[:2]
    with span("relpose.fivepoint"):
        s1, s2 = _samples(x1, x2, valid, u)
        E_h, ok = fivepoint.five_point(s1, s2, polish=False)  # [P,H,S,3,3]
    S = fivepoint.NUM_ROOT_SLOTS
    with span("relpose.score"):
        E, _ = _score_best(epipolar.sampson_error,
                           E_h.reshape(P, H * S, 3, 3), ok.reshape(P, H * S),
                           x1, x2, valid, thresh_sq)
    with span("relpose.refine"):
        inliers = (epipolar.sampson_error(E, x1, x2) < thresh_sq) & valid
        return _local_opt(E, inliers, x1, x2, valid, thresh_sq, True)


def _ransac_homography(x1, x2, valid, u, thresh_sq):
    """RANSAC for H from 4-point samples, then one refit on the inliers.
    u: [P, H, 4]."""
    s1, s2 = _samples(x1, x2, valid, u)
    H_h = epipolar.homography_dlt(s1, s2, torch.ones(u.shape, dtype=torch.bool,
                                                     device=u.device))
    H, _ = _score_best(epipolar.homography_error, H_h,
                       torch.ones(u.shape[:2], dtype=torch.bool, device=u.device),
                       x1, x2, valid, thresh_sq)
    inliers = (epipolar.homography_error(H, x1, x2) < thresh_sq) & valid
    H2 = epipolar.homography_dlt(x1, x2, inliers)
    inl2 = (epipolar.homography_error(H2, x1, x2) < thresh_sq) & valid
    better = torch.sum(inl2, -1) > torch.sum(inliers, -1)
    return (torch.where(better[:, None, None], H2, H),
            torch.where(better[:, None], inl2, inliers))


def _model_inliers(model, x1, x2, valid, thresh_sq, kind: str = "sampson"):
    """Inlier mask of a fitted model over ALL matches (the estimation itself
    may have run on a subsample)."""
    err_fn = (epipolar.sampson_error if kind == "sampson"
              else epipolar.homography_error)
    return (err_fn(model, x1, x2) < thresh_sq) & valid


# ----------------------------------------------------------------- stage API

def _bucket(n, buckets=(256, 1024, 4096, 16384)):
    """Pad match counts to a coarse power-of-4 ladder (the JAX package's
    compile-shape ladder; it also fixes the chunk schedule)."""
    for b in buckets:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(max(n, 1))))


class _Uniforms:
    """Default RANSAC draws, float64: a CPU generator for each (chunk,
    model), seeded from (``seed``, chunk, model)."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def __call__(self, chunk: int, model: str, shape):
        state = np.random.SeedSequence(
            [self.seed, int(chunk), "EFH".index(model)]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state))
        return torch.rand(shape, generator=gen, dtype=torch.float64)


def estimate_relative_pose(view_graph: ViewGraph, cameras: Cameras,
                           images: Images, num_hyps: int = 1024,
                           seed: int = 0, dtype=torch.float64,
                           chunk_pairs: int = 256,
                           five_point: bool = True,
                           num_hyps_minimal: int = 192, device="cuda",
                           uniforms=None) -> None:
    """Estimate (R, t, inliers) for every valid pair; updates view_graph in
    place (qvec/tvec/E_mat/F_mat/H_mat/inlier_mask/valid).

    ``five_point=True`` estimates E with the minimal Nistér solver
    (``num_hyps_minimal`` hypotheses of up to 14 candidates each); otherwise
    with the 8-point projection onto the essential manifold and the full
    ``num_hyps`` budget.  ``uniforms`` (see the module docstring) replaces
    the default draws."""
    dev = resolve_device(device)
    if images.kp_bearing is None:
        undistort_images(cameras, images, device=dev)
    draw = uniforms if uniforms is not None else _Uniforms(seed)

    view_graph.valid &= np.isin(view_graph.config, _ESTIMABLE)
    mcounts = view_graph.num_matches_per_pair()
    pair_rows = np.nonzero(view_graph.valid & (mcounts >= 8))[0]
    view_graph.valid &= (mcounts >= 8)
    if len(pair_rows) == 0:
        return

    bearings = torch.as_tensor(images.kp_bearing, device=dev).to(dtype)
    uv_all = bearings[:, :2] / torch.abs(bearings[:, 2:]).clamp_min(1e-9) \
        * torch.sign(bearings[:, 2:])
    kp_xy = torch.as_tensor(images.kp_xy, device=dev).to(dtype)
    # keypoint table: xy(2) uv(2) bearing(3), shipped once
    tab = torch.cat([kp_xy, uv_all, bearings], dim=1)
    matches = torch.as_tensor(view_graph.matches.astype(np.int64), device=dev)
    match_offset = torch.as_tensor(view_graph.match_offset, device=dev)
    kp_base_i = torch.as_tensor(images.kp_offset[view_graph.pair_i], device=dev)
    kp_base_j = torch.as_tensor(images.kp_offset[view_graph.pair_j], device=dev)

    # group rows by bucketed match count, cut into chunks (the JAX schedule)
    order = np.argsort(mcounts[pair_rows], kind="stable")
    groups = {}
    for e in pair_rows[order]:
        groups.setdefault(_bucket(mcounts[e]), []).append(e)
    chunks = [(M, np.array(rows[lo:lo + chunk_pairs]))
              for M, rows in sorted(groups.items())
              for lo in range(0, len(rows), chunk_pairs)]

    n_proc, rank = multihost.process_count(), multihost.process_index()
    pending = []
    for k, (M, rows) in enumerate(chunks):
        if k % n_proc != rank:
            pending.append(None)             # another process owns it
            continue
        with span("relpose.chunk"):
            pending.append(_process_chunk(
                view_graph, rows, M, k, draw, dtype, dev, chunk_pairs,
                num_hyps, five_point, num_hyps_minimal,
                (tab, matches, match_offset, kp_base_i, kp_base_j)))
    if n_proc == 1:
        # every chunk is queued before the first readback
        with span("relpose.writeback"):
            for rows, E, q, t, mask in pending:
                _writeback_chunk(view_graph, rows,
                                 *read("relpose.writeback", (E, q, t, mask)))
        return

    # exchange: each chunk's owner sends its estimates and mask bits to
    # every process, and every process writes every chunk back
    for k, (M, rows) in enumerate(chunks):
        P = len(rows)
        flat = np.zeros((P, 34))
        bits = np.zeros((P, -(-M // 8)), np.uint8)
        if pending[k] is not None:
            _, E, q, t, mask = pending[k]
            E, q, t, mask = read("relpose.exchange",
                                 (E.double(), q.double(), t.double(), mask))
            flat = np.concatenate([
                E.reshape(P, 9), q, t,
                view_graph.F_mat[rows].reshape(P, 9),
                view_graph.H_mat[rows].reshape(P, 9)], axis=1)
            bits = np.packbits(mask, axis=1, bitorder="little")
        owner = k % n_proc
        flat = multihost.allgather_host_arrays(flat)[owner]
        bits = multihost.allgather_host_arrays(bits)[owner]
        mask = np.unpackbits(bits, axis=1, bitorder="little",
                             count=M).astype(bool)
        view_graph.F_mat[rows] = flat[:, 16:25].reshape(P, 3, 3)
        view_graph.H_mat[rows] = flat[:, 25:34].reshape(P, 3, 3)
        _writeback_chunk(view_graph, rows, flat[:, :9].reshape(P, 3, 3),
                         flat[:, 9:13], flat[:, 13:16], mask)


def _draw(draw, k, model, shape, n, dev):
    """Chunk k's uniforms for ``model`` of the given shape; the first n
    rows, as float64 on the device."""
    u = torch.as_tensor(np.asarray(draw(k, model, tuple(shape)), np.float64))
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"uniforms for chunk {k} {model}: shape "
                         f"{tuple(u.shape)}, expected {tuple(shape)}")
    return u[:n].to(dev)


def _pack_chunk(tables, rows, M: int):
    """Padded [n, M] match arrays of the chunk's pairs, gathered on the
    device: (x1_pix, x2_pix, x1_norm, x2_norm, b1, b2, valid)."""
    tab, matches, match_offset, kp_base_i, kp_base_j = tables
    offs = match_offset[rows]
    lens = match_offset[rows + 1] - offs
    col = torch.arange(M, device=rows.device)[None, :]
    valid = col < lens[:, None]
    zero = torch.zeros((), dtype=torch.int64, device=rows.device)
    m = matches[torch.where(valid, offs[:, None] + col, zero)]     # [n, M, 2]
    f1 = torch.where(valid, kp_base_i[rows][:, None] + m[..., 0], zero)
    f2 = torch.where(valid, kp_base_j[rows][:, None] + m[..., 1], zero)
    fzero = torch.zeros((), dtype=tab.dtype, device=tab.device)
    r1 = torch.where(valid[..., None], tab[f1], fzero)
    r2 = torch.where(valid[..., None], tab[f2], fzero)
    return (r1[..., 0:2], r2[..., 0:2], r1[..., 2:4], r2[..., 2:4],
            r1[..., 4:7], r2[..., 4:7], valid)


def _process_chunk(view_graph, rows, M, k, draw, dtype, dev, chunk_pairs,
                   num_hyps, five_point, num_hyps_minimal, tables):
    """One chunk's estimates, left on the device: (rows, E [n,3,3],
    q [n,4], t [n,3], final inlier mask [n, M])."""
    n = len(rows)
    with span("relpose.pack"):
        x1_pix, x2_pix, x1_norm, x2_norm, b1, b2, valid = _pack_chunk(
            tables, torch.as_tensor(rows.astype(np.int64), device=dev), M)

    # estimation cap: sampling, scoring and LO run on a strided subsample of
    # at most _ESTIMATE_CAP matches per pair; inlier and cheirality masks are
    # then recomputed over ALL matches with the winning models
    Ms = min(M, _ESTIMATE_CAP)
    sub = torch.arange(Ms, device=dev) * (M // Ms)
    ss = (lambda a: a[:, sub]) if M > Ms else (lambda a: a)

    e_thresh = torch.tensor(1e-3 ** 2, dtype=dtype, device=dev)
    if five_point:
        with span("relpose.draw"):
            u = _draw(draw, k, "E", (chunk_pairs, num_hyps_minimal, 5), n,
                      dev)
        E, _ = _ransac_essential_5pt(ss(x1_norm), ss(x2_norm), ss(valid), u,
                                     e_thresh)
    else:
        with span("relpose.draw"):
            u = _draw(draw, k, "E", (chunk_pairs, num_hyps, 8), n, dev)
        E, _ = _ransac_fundamental_like(ss(x1_norm), ss(x2_norm), ss(valid),
                                        u, e_thresh, essential=True)
    with span("relpose.refine"):
        sel_inl = _model_inliers(E, x1_norm, x2_norm, valid, e_thresh)

    cfgs = view_graph.config[rows]
    pix_thresh = torch.tensor(3.0 ** 2, dtype=dtype, device=dev)
    uncal = np.nonzero(cfgs == CONFIG_UNCALIBRATED)[0]
    planar = np.nonzero(np.isin(cfgs, (CONFIG_PLANAR, CONFIG_PANORAMIC,
                                       CONFIG_PLANAR_OR_PANORAMIC)))[0]
    if len(uncal):
        sel = torch.as_tensor(uncal, device=dev)
        u = _draw(draw, k, "F", (len(uncal), num_hyps, 8), len(uncal), dev)
        F, _ = _ransac_fundamental_like(ss(x1_pix)[sel], ss(x2_pix)[sel],
                                        ss(valid)[sel], u, pix_thresh,
                                        essential=False)
        view_graph.F_mat[rows[uncal]] = read("relpose.F", F.double())
        sel_inl[sel] = _model_inliers(F, x1_pix[sel], x2_pix[sel], valid[sel],
                                      pix_thresh)
    if len(planar):
        sel = torch.as_tensor(planar, device=dev)
        u = _draw(draw, k, "H", (len(planar), num_hyps, 4), len(planar), dev)
        with span("relpose.homography"):
            H, _ = _ransac_homography(ss(x1_pix)[sel], ss(x2_pix)[sel],
                                      ss(valid)[sel], u, pix_thresh)
        view_graph.H_mat[rows[planar]] = read("relpose.H", H.double())
        sel_inl[sel] = _model_inliers(H, x1_pix[sel], x2_pix[sel], valid[sel],
                                      pix_thresh, kind="homography")

    with span("relpose.recover_pose"):
        if M > Ms:
            # vote for (R, t) on the subsample; cheirality mask on all matches
            Rm, t, _ = epipolar.recover_pose(E, ss(b1), ss(b2), ss(sel_inl))
            pass_mask = epipolar.cheirality_mask(Rm, t, b1, b2, sel_inl)
        else:
            Rm, t, pass_mask = epipolar.recover_pose(E, b1, b2, sel_inl)
        return rows, E, lie.matrix_to_quat(Rm), t, pass_mask


def _writeback_chunk(view_graph, rows, E, q, t, pass_mask):
    """Scatter one chunk's results into the view graph."""
    view_graph.E_mat[rows] = E.astype(np.float64)
    view_graph.qvec[rows] = q.astype(np.float64)
    view_graph.tvec[rows] = t.astype(np.float64)
    # one fancy-index write for all pairs' masks (row k covers matches
    # [offset[e], offset[e]+n_e) <- pass_mask[k, :n_e])
    offs = view_graph.match_offset[rows]
    lens = view_graph.match_offset[rows + 1] - offs
    kk = np.repeat(np.arange(len(rows)), lens)
    col = np.arange(len(kk)) - np.repeat(np.cumsum(lens) - lens, lens)
    view_graph.inlier_mask[np.repeat(offs, lens) + col] = pass_mask[kk, col]
