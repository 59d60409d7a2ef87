"""The LM engine over several processes (``torch.distributed``).

Counterpart of ``instantsfm_tpu/parallel/sharded.py``.  A JAX device of the
mesh is a rank of a process group here, and each rank holds its slice of
the problem, point-local (``optimize_auto``): the points are cut into
contiguous per-rank ranges with their observations (observations are
sorted by point), so landmark elimination never leaves the rank and only
the camera system, the PCG vectors and the scalars are all-reduced
(``block_lm``'s ``group``).  The bucketed layout (``solve/blocked.py``) is
split bucket by bucket, so every rank has the same bucket structure
(``partition_bucketed``) and runs K1 on its own buckets.

The partition functions are numpy on the host and give the arrays the JAX
package gives.  ``ISFM_NO_SHARD=1`` keeps a multi-process run's solves on
one rank's device, as in JAX.  Spans (``utils/debug``): ``sharded.bucketize``
and ``sharded.lm`` (the point-local solve), ``auto.bucketize`` and
``auto.lm`` (the one-device solve); the partition functions' host reads are
``sharded.host``.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from instantsfm_tpu_torch.parallel import multihost
from instantsfm_tpu_torch.solve import robust
from instantsfm_tpu_torch.solve.block_lm import (LMConfig, Observations,
                                                 Params, lm_step, optimize)
from instantsfm_tpu_torch.solve.blocked import TRACK_PAD, bucketize_problem
from instantsfm_tpu_torch.utils.debug import read, span
from instantsfm_tpu_torch.utils.device import check_on_device


def _host(t):
    return read("sharded.host", t) if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _like(a, ref):
    """numpy ``a`` as a tensor on ``ref``'s device."""
    return torch.as_tensor(np.ascontiguousarray(a), device=ref.device)


def shard_world() -> int:
    """Ranks the LM solves are sharded over: the default group's size, or 1
    under ``ISFM_NO_SHARD`` or without a process group."""
    if os.environ.get("ISFM_NO_SHARD") or not dist.is_initialized():
        return 1
    return dist.get_world_size()


class PointPartition(NamedTuple):
    """Host metadata to map partitioned results back to global order."""
    bounds: np.ndarray        # [D+1] point-range boundaries
    obs_bounds: np.ndarray    # [D+1] observation-range boundaries
    T_pad: int                # per-rank point capacity
    O_pad: int                # per-rank observation capacity
    num_points: int
    num_obs: int


def partition_points(params: Params, obs: Observations, n_dev: int):
    """Split (params, obs) into ``n_dev`` point-contiguous shards balanced
    by observation count.

    Returns (params_part, obs_part, meta) with flat [D*T_pad, ...] /
    [D*O_pad, ...] tensors; shard d is rows [d*T_pad, (d+1)*T_pad) and
    [d*O_pad, (d+1)*O_pad).  ``obs.pt_idx`` becomes shard-local.  Requires
    observations sorted by point."""
    pt_idx = _host(obs.pt_idx)
    O = pt_idx.shape[0]
    T = params.pts.shape[0]
    counts = np.bincount(pt_idx, minlength=T)
    cum = np.cumsum(counts)

    targets = (np.arange(1, n_dev) * O) / n_dev
    pb = np.searchsorted(cum, targets).astype(np.int64) + 1
    for i in range(1, len(pb)):
        pb[i] = max(pb[i], pb[i - 1] + 1)
    pb = np.clip(pb, 1, T)
    bounds = np.concatenate([[0], pb, [T]])
    for i in range(1, len(bounds)):          # degenerate tiny scenes
        bounds[i] = max(bounds[i], bounds[i - 1])

    obs_bounds = np.concatenate([[0], cum])[bounds]
    T_pad = max(1, int(np.max(np.diff(bounds))))
    O_pad = max(1, int(np.max(np.diff(obs_bounds))))

    def pad_obs(a, fill=0):
        out = np.full((n_dev, O_pad) + a.shape[1:], fill, a.dtype)
        for d in range(n_dev):
            s, e = obs_bounds[d], obs_bounds[d + 1]
            out[d, :e - s] = a[s:e]
        return out.reshape((n_dev * O_pad,) + a.shape[1:])

    pts = _host(params.pts)
    local_pt = np.full((n_dev, O_pad), T_pad - 1, pt_idx.dtype)
    pts_part = np.zeros((n_dev, T_pad, 3), pts.dtype)
    for d in range(n_dev):
        b, e = bounds[d], bounds[d + 1]
        s, t = obs_bounds[d], obs_bounds[d + 1]
        local_pt[d, :t - s] = pt_idx[s:t] - b
        pts_part[d, :e - b] = pts[b:e]

    ref = params.pts
    obs_part = Observations(
        cam_idx=_like(pad_obs(_host(obs.cam_idx)), ref),
        pt_idx=_like(local_pt.reshape(-1), ref),
        data={k: _like(pad_obs(_host(v)), ref) for k, v in obs.data.items()},
        valid=_like(pad_obs(_host(obs.valid), fill=False), ref))
    params_part = Params(
        cam=params.cam,
        pts=_like(pts_part.reshape(n_dev * T_pad, 3), ref),
        scales=_like(pad_obs(_host(params.scales)), ref),
        scales_free=_like(pad_obs(_host(params.scales_free), fill=False), ref))
    meta = PointPartition(bounds=bounds, obs_bounds=obs_bounds, T_pad=T_pad,
                          O_pad=O_pad, num_points=T, num_obs=O)
    return params_part, obs_part, meta


def unpartition_points(pts_flat, meta: PointPartition) -> np.ndarray:
    """[D*T_pad, 3] shard layout -> [T, 3] global points."""
    D = len(meta.bounds) - 1
    a = _host(pts_flat).reshape(D, meta.T_pad, 3)
    out = np.zeros((meta.num_points, 3), a.dtype)
    for d in range(D):
        b, e = meta.bounds[d], meta.bounds[d + 1]
        out[b:e] = a[d, :e - b]
    return out


def unpartition_scales(scales_flat, meta: PointPartition) -> np.ndarray:
    """[D*O_pad, 1] shard layout -> [O, 1] global per-observation scales."""
    D = len(meta.bounds) - 1
    a = _host(scales_flat).reshape(D, meta.O_pad, -1)
    out = np.zeros((meta.num_obs, a.shape[-1]), a.dtype)
    for d in range(D):
        s, e = meta.obs_bounds[d], meta.obs_bounds[d + 1]
        out[s:e] = a[d, :e - s]
    return out


def rank_slice(params: Params, obs: Observations, rank: int, local_T: int,
               local_O: int):
    """Rank ``rank``'s shard of a partitioned problem (``partition_points``'
    T_pad/O_pad, or ``partition_bucketed``'s local_T/local_O)."""
    ps = slice(rank * local_T, (rank + 1) * local_T)
    os_ = slice(rank * local_O, (rank + 1) * local_O)
    return (Params(params.cam, params.pts[ps], params.scales[os_],
                   params.scales_free[os_]),
            Observations(obs.cam_idx[os_], obs.pt_idx[os_],
                         {k: v[os_] for k, v in obs.data.items()},
                         obs.valid[os_]))


def make_pointlocal_lm_step(problem, kernel: robust.RobustKernel,
                            cfg: LMConfig, buckets: tuple = (),
                            device="cuda"):
    """``step(state, obs)`` on this rank's point-local shard: ``lm_step``
    with the camera reductions and scalars all-reduced over the default
    group and ``buckets`` the rank's own bucket table
    (``partition_bucketed``'s ``local_buckets``, the same on every rank),
    with which K1 runs on the rank's rows.  The solver is PCG: dense Schur
    would sum a [3T, C*PC] product across ranks."""
    cfg = dataclasses.replace(cfg, solver="pcg")
    return partial(lm_step, problem, kernel, cfg, buckets=buckets,
                   device=device, group=dist.group.WORLD)


class BucketPartition(NamedTuple):
    """Maps the partitioned layout back to the global bucketed layout."""
    pt_take: np.ndarray       # [D*local_T] global bucket slot of each local pt
    obs_take: np.ndarray      # [D*local_O] global bucket row of each local obs
    local_buckets: tuple      # per-rank ((obs_start, pt_start, Tb_d, L), ...)
    local_T: int
    local_O: int


def partition_bucketed(params: Params, obs: Observations, buckets: tuple,
                       n_dev: int):
    """Split a bucketed problem (``bucketize_problem``'s output) into
    ``n_dev`` point-contiguous shards with the same bucket structure.

    Every bucket's padded track count must divide by ``n_dev``
    (``bucketize_problem`` with ``track_pad`` a multiple of it).  Within a
    bucket every row has the same padded length L, so a contiguous split
    gives every rank the same number of rows and point slots per bucket.
    Shard d is rows [d*local_O, (d+1)*local_O) and point slots
    [d*local_T, (d+1)*local_T) of the returned tensors."""
    pt_takes = [[] for _ in range(n_dev)]
    obs_takes = [[] for _ in range(n_dev)]
    local_buckets = []
    lp = lo = 0
    for (os_, ps, Tb, L) in buckets:
        if Tb % n_dev:
            raise ValueError(f"bucket of {Tb} tracks does not split over "
                             f"{n_dev} ranks")
        Td = Tb // n_dev
        for d in range(n_dev):
            pt_takes[d].append(np.arange(ps + d * Td, ps + (d + 1) * Td))
            obs_takes[d].append(np.arange(os_ + d * Td * L,
                                          os_ + (d + 1) * Td * L))
        local_buckets.append((lo, lp, Td, L))
        lp += Td
        lo += Td * L
    pt_take = np.concatenate([np.concatenate(t) for t in pt_takes])
    obs_take = np.concatenate([np.concatenate(t) for t in obs_takes])

    ref = params.pts
    take_pt = _like(pt_take, ref)
    take_obs = _like(obs_take, ref)
    params_p = Params(cam=params.cam, pts=params.pts[take_pt],
                      scales=params.scales[take_obs],
                      scales_free=params.scales_free[take_obs])
    # rank-local point indices: the same on every rank
    local_pt = np.concatenate([
        (lb[1] + np.repeat(np.arange(lb[2]), lb[3])).astype(np.int32)
        for lb in local_buckets])
    obs_p = Observations(
        cam_idx=obs.cam_idx[take_obs],
        pt_idx=_like(np.tile(local_pt, n_dev), ref),
        data={k: v[take_obs] for k, v in obs.data.items()},
        valid=obs.valid[take_obs])
    meta = BucketPartition(pt_take=pt_take, obs_take=obs_take,
                           local_buckets=tuple(local_buckets),
                           local_T=lp, local_O=lo)
    return params_p, obs_p, meta


# ------------------------------------------------- production driver


def _check_same_problem(params: Params, obs: Observations, buckets):
    """Every rank must hold the same problem, or the collectives of the
    solve would pair up wrong: compare the shapes and bucket tables over
    the host group, and raise where they differ."""
    sig = np.array([params.pts.shape[0], obs.valid.shape[0],
                    next(iter(params.cam.values())).shape[0], len(buckets),
                    hash(tuple(buckets)) & 0x7FFFFFFF], np.int64)
    allsig = multihost.allgather_host_arrays(sig)
    if not (allsig == sig).all():
        raise RuntimeError("the ranks hold different LM problems (points, "
                           f"rows, cameras, buckets): {allsig}")


def optimize_sharded(problem, kernel, cfg: LMConfig, params: Params,
                     obs: Observations, *, verbose: bool = False,
                     device="cuda"):
    """The point-local solve over the ranks of the default group, at any
    world size, one included.

    Every rank passes the whole problem.  The tracks are bucketed with
    ``TRACK_PAD`` rounded up to a multiple of the world size, split by
    ``partition_bucketed``, and each rank solves its shard; the cameras
    start from rank 0's values.  Returns ``(cam, pts, history)`` with the
    points all-gathered back into their original order on every rank."""
    dev = check_on_device(device, params.pts)
    world, rank = dist.get_world_size(), dist.get_rank()
    pad = -(-max(TRACK_PAD, world) // world) * world
    with span("sharded.bucketize"):
        params_b, obs_b, buckets, point_slots = bucketize_problem(
            params, obs, track_pad=pad)
    _check_same_problem(params_b, obs_b, buckets)
    params_p, obs_p, meta = partition_bucketed(params_b, obs_b, buckets, world)
    # the cameras are replicated state: one value on every rank
    cam = {k: v.clone() for k, v in params_p.cam.items()}
    for v in cam.values():
        dist.broadcast(v, 0)
    params_p = params_p._replace(cam=cam)
    params_l, obs_l = rank_slice(params_p, obs_p, rank, meta.local_T,
                                 meta.local_O)
    step = make_pointlocal_lm_step(problem, kernel, cfg,
                                   buckets=meta.local_buckets, device=dev)
    with span("sharded.lm"):
        state, history = optimize(problem, kernel, cfg, params_l, obs_l,
                                  verbose=verbose, device=dev, step_fn=step)
    # rank shards -> global bucket slots -> original point order
    pts_part = multihost.all_gather_rows(state.params.pts)
    pts_b = torch.zeros_like(params_b.pts)
    pts_b[_like(meta.pt_take, pts_b)] = pts_part
    return state.params.cam, pts_b[_like(point_slots, pts_b)], history


def optimize_auto(problem, kernel, cfg: LMConfig, params: Params,
                  obs: Observations, *, verbose: bool = False,
                  device="cuda"):
    """Production LM driver: the bucketed single-device solve, or the
    point-local solve over every rank of the default process group when
    there are several (``ISFM_NO_SHARD=1`` opts out).

    Returns ``(cam, pts, history)``: the camera blocks and the points
    [T, 3] in their original (pre-bucketing) order, on ``device``."""
    if shard_world() > 1:
        return optimize_sharded(problem, kernel, cfg, params, obs,
                                verbose=verbose, device=device)
    with span("auto.bucketize"):
        params_b, obs_b, buckets, point_slots = bucketize_problem(params,
                                                                  obs)
    with span("auto.lm"):
        state, history = optimize(problem, kernel, cfg, params_b, obs_b,
                                  verbose=verbose, buckets=buckets,
                                  device=device)
    pts = state.params.pts[_like(point_slots, state.params.pts)]
    return state.params.cam, pts, history
