"""Bucketed track layout for the LM engine.

Counterpart of ``instantsfm_tpu/solve/blocked.py``.  Each track's
observations are grouped into padded rows of power-of-two length L, so every
point-side reduction is a reshape-sum and every point-side gather a
broadcast, and the Schur kernel (``solve/schur_wchain.py``) finds a track's
observations as one aligned group of L rows.

``bucketize`` (host numpy) reorders points so each bucket owns a contiguous
point range and pads the observation arrays; the static ``buckets`` tuple
((obs_start, pt_start, num_tracks, L), ...) drives the per-bucket loops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from instantsfm_tpu_torch.utils.debug import span

BUCKET_SIZES = (2, 4, 8, 16, 32, 64, 128, 256, 512)


class BucketedProblem(NamedTuple):
    cam_idx: np.ndarray       # [O'] int32 (padded rows -> 0)
    pt_idx: np.ndarray        # [O'] int32 (padded rows -> their track's point)
    valid: np.ndarray         # [O'] bool
    data: dict                # {name: [O', ...]} (padded rows zero)
    scales: np.ndarray        # [O', 1]
    scales_free: np.ndarray   # [O'] bool
    buckets: Tuple            # static ((obs_start, pt_start, Tb, L), ...)
    num_slots: int = 0        # padded point-slot count (>= T)
    point_slots: np.ndarray = None  # [T] slot of each ORIGINAL point
    obs_order: np.ndarray = None    # [O] source rows in pack order
    obs_dest: np.ndarray = None     # [O] padded slot of each packed row:
    #                                 padded[obs_dest[k]] = a[obs_order[k]]


def _bucket_len(n: int) -> int:
    for b in BUCKET_SIZES:
        if n <= b:
            return b
    return int(2 ** np.ceil(np.log2(n)))


def bucketize(cam_idx, pt_idx, data, valid, scales, scales_free,
              num_points: int, track_pad: int = 256) -> BucketedProblem:
    """Inputs are the flat (sorted-by-point) observation arrays.

    ``track_pad`` rounds each bucket's track count up to a multiple (padded
    tracks are fully invalid).  Spans need no further alignment: the Schur
    kernel numbers rows from each bucket's start.
    """
    cam_idx = np.asarray(cam_idx)
    pt_idx = np.asarray(pt_idx)
    valid = np.asarray(valid)
    scales = np.asarray(scales)
    scales_free = np.asarray(scales_free)
    data = {k: np.asarray(v) for k, v in data.items()}

    # include invalid obs in the row (masked) so nothing is lost
    lengths_all = np.bincount(pt_idx, minlength=num_points).astype(np.int64)
    blen = np.array([_bucket_len(max(int(n), 1)) for n in lengths_all])

    order_pts = np.argsort(blen, kind="stable")       # points grouped by bucket
    point_unperm = np.empty(num_points, np.int64)
    point_unperm[order_pts] = np.arange(num_points)

    # flat obs sorted by (new point index, position)
    new_pt_of_obs = point_unperm[pt_idx]
    obs_order = np.argsort(new_pt_of_obs, kind="stable")

    buckets = []
    obs_cursor = 0
    out_cursor = 0
    pt_cursor = 0        # padded slot cursor
    pt_cursor_real = 0   # real (new-order) point cursor
    sorted_blen = blen[order_pts]
    slot_of_new = np.empty(num_points, np.int64)
    # one global destination index per observation, then one fancy scatter
    # per attribute
    dest = np.empty(len(obs_order), np.int64)
    for L in sorted(set(sorted_blen.tolist())):
        sel_pts = np.nonzero(sorted_blen == L)[0]
        Tb_real = len(sel_pts)
        mult = track_pad or 1
        Tb = -(-Tb_real // mult) * mult
        n_obs_b = int(lengths_all[order_pts[sel_pts]].sum())
        rows = obs_order[obs_cursor: obs_cursor + n_obs_b]
        slot_of_new[pt_cursor_real: pt_cursor_real + Tb_real] = \
            pt_cursor + np.arange(Tb_real)

        local_pt = point_unperm[pt_idx[rows]] - pt_cursor_real
        pos = np.zeros(len(rows), np.int64)
        if len(rows):
            first = np.ones(len(rows), bool)
            first[1:] = local_pt[1:] != local_pt[:-1]
            starts = np.nonzero(first)[0]
            pos = np.arange(len(rows)) - np.repeat(starts, np.diff(
                np.append(starts, len(rows))))
        dest[obs_cursor: obs_cursor + n_obs_b] = \
            out_cursor + local_pt * L + pos

        buckets.append((out_cursor, pt_cursor, Tb, int(L)))
        obs_cursor += n_obs_b
        out_cursor += Tb * L
        pt_cursor += Tb
        pt_cursor_real += Tb_real

    def padded_all(a, fill=0):
        out = np.full((out_cursor,) + a.shape[1:], fill, a.dtype)
        out[dest] = a[obs_order]
        return out

    # padded point ids per bucket (pure arithmetic, no scatter)
    out_pt = np.concatenate([
        (ps + np.repeat(np.arange(Tb), L)).astype(np.int32)
        for (os_, ps, Tb, L) in buckets]) if buckets else \
        np.zeros(0, np.int32)

    return BucketedProblem(
        cam_idx=padded_all(cam_idx).astype(np.int32),
        pt_idx=out_pt,
        valid=padded_all(valid, fill=False),
        data={k: padded_all(v) for k, v in data.items()},
        scales=padded_all(scales),
        scales_free=padded_all(scales_free, fill=False),
        buckets=tuple(buckets),
        num_slots=int(pt_cursor),
        point_slots=slot_of_new[point_unperm],
        obs_order=obs_order, obs_dest=dest)


def bucketize_problem(params, obs, track_pad: int = 256,
                      return_mapping: bool = False):
    """(Params, Observations) -> bucketed versions + metadata, on the device
    the inputs live on.

    Returns (params_b, obs_b, buckets, point_slots): points sit in padded
    slots (``pts_b[point_slots] = pts``).  With ``return_mapping`` also
    returns (obs_order, obs_dest): padded[obs_dest[k]] = original[obs_order[k]].
    """
    from instantsfm_tpu_torch.solve.block_lm import Observations

    def host(t):
        return t.detach().cpu().numpy()

    device, dtype = params.pts.device, params.pts.dtype
    with span("bucketize host"):
        bp = bucketize(host(obs.cam_idx), host(obs.pt_idx),
                       {k: host(v) for k, v in obs.data.items()},
                       host(obs.valid), host(params.scales),
                       host(params.scales_free), params.pts.shape[0],
                       track_pad=track_pad)

    def dev(a, dt=None):
        return torch.as_tensor(a, device=device, dtype=dt)

    pts_b = torch.zeros((bp.num_slots, 3), dtype=dtype, device=device)
    pts_b[dev(bp.point_slots)] = params.pts
    params_b = params._replace(pts=pts_b, scales=dev(bp.scales, dtype),
                               scales_free=dev(bp.scales_free))
    obs_b = Observations(cam_idx=dev(bp.cam_idx), pt_idx=dev(bp.pt_idx),
                         data={k: dev(v, dtype) for k, v in bp.data.items()},
                         valid=dev(bp.valid))
    if return_mapping:
        return (params_b, obs_b, bp.buckets, bp.point_slots,
                (bp.obs_order, bp.obs_dest))
    return params_b, obs_b, bp.buckets, bp.point_slots


def seg_by_pt(vals, buckets, T):
    """[O', ...] -> [T, ...] reduction via per-bucket reshape-sums."""
    outs = []
    for (os_, ps, Tb, L) in buckets:
        chunk = vals[os_: os_ + Tb * L]
        outs.append(chunk.reshape((Tb, L) + tuple(vals.shape[1:])).sum(dim=1))
    return torch.cat(outs, dim=0)


def gather_pt(arr, buckets, O):
    """[T, ...] -> [O', ...] broadcast via per-bucket repeats."""
    outs = []
    for (os_, ps, Tb, L) in buckets:
        chunk = arr[ps: ps + Tb]
        outs.append(chunk[:, None].expand((Tb, L) + tuple(arr.shape[1:]))
                    .reshape((Tb * L,) + tuple(arr.shape[1:])))
    return torch.cat(outs, dim=0)
