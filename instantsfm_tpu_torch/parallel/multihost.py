"""Multi-process scaffolding on ``torch.distributed``.

Counterpart of ``instantsfm_tpu/parallel/multihost.py``.  One process runs
per card: a JAX device becomes a rank of the default process group, and a
rank's card is ``cuda:LOCAL_RANK``.  Collectives on tensors go over the
default group (NCCL on cards, gloo on the CPU).  Host arrays (bytes, masks,
int64 indices) go over one gloo side group, byte for byte, so they never
round through the card or through float.

* ``initialize()`` brings up the process group from explicit arguments,
  then ``ISFM_COORDINATOR`` / ``ISFM_NUM_PROCESSES`` / ``ISFM_PROCESS_ID``,
  then torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), read only where set, so that a
  single-process run never blocks;
* pair fan-out: feature matching, extraction and relative pose are
  independent over images and pairs; each process takes a strided slice,
  and the fixed-shape results are all-gathered;
* replicated stages: every process runs view-graph calibration and
  rotation averaging whole and takes rank 0's result
  (``broadcast_host_arrays``), since float atomics make the cards'
  results differ in their last bits.

Launch on the CPU, one command per process:

    ISFM_COORDINATOR=localhost:29500 ISFM_NUM_PROCESSES=2 ISFM_PROCESS_ID=$R \\
        python -m instantsfm_tpu_torch.cli.sfm --data_path SCENE --device cpu

or on cards, one process per card:

    torchrun --nproc_per_node=4 -m instantsfm_tpu_torch.cli.sfm \\
        --data_path SCENE
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# every collective fails after this long instead of waiting for a lost rank
TIMEOUT_S = 600.0

# the gloo group that carries host arrays (module state, as the default
# process group it sits beside)
_HOST_GROUP = None


def _env_int(name):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def initialize(coordinator: str = None, num_processes: int = None,
               process_id: int = None, device="cuda", backend: str = None,
               timeout_s: float = TIMEOUT_S) -> bool:
    """Join the default process group where one is configured; returns True
    when this is one of several processes.

    ``backend`` defaults to NCCL for ``device="cuda"`` and gloo for the CPU.
    On a card, the rank's device is set to ``LOCAL_RANK`` (torchrun), else
    ``process_id`` modulo the visible cards.  A group that fails to form
    raises.  Calling it again in a process that already joined a group
    changes nothing."""
    global _HOST_GROUP
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = coordinator or os.environ.get("ISFM_COORDINATOR")
    num_processes = num_processes or _env_int("ISFM_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("ISFM_PROCESS_ID")
    local_rank = None
    init_method = f"tcp://{coordinator}"
    if not coordinator and os.environ.get("MASTER_ADDR") \
            and _env_int("WORLD_SIZE") is not None:
        # torchrun: its agent may already host the store, which env://
        # joins as a client
        coordinator, init_method = os.environ["MASTER_ADDR"], "env://"
        num_processes = _env_int("WORLD_SIZE")
        process_id = _env_int("RANK")
        local_rank = _env_int("LOCAL_RANK")
    if not coordinator:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"process group at {coordinator}: the number of "
                         "processes and this process's id are both needed")

    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("multihost.initialize: device='cuda' but no "
                               "CUDA device is available")
        if local_rank is None:
            local_rank = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local_rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)
    _HOST_GROUP = dist.new_group(backend="gloo", timeout=timeout)
    return num_processes > 1


def shutdown() -> None:
    """Leave the process group (and its host group), where one was
    joined."""
    global _HOST_GROUP
    if dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP = None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_group():
    """The gloo group for host arrays (made on first use where the caller
    formed the default group itself; every rank reaches it at the same
    collective)."""
    global _HOST_GROUP
    if _HOST_GROUP is None:
        _HOST_GROUP = dist.new_group(
            backend="gloo", timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return _HOST_GROUP


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, ...] on every rank of the default group -> [world * n, ...] in
    rank order (detached, on ``x``'s device)."""
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x.detach().contiguous())
    return torch.cat(out)


def barrier() -> None:
    if process_count() > 1:
        dist.barrier(group=host_group())


def local_pair_slice(num_pairs: int) -> np.ndarray:
    """Strided slice of pair indices owned by this process (strided, not
    contiguous, so sequential pair lists balance)."""
    return np.arange(process_index(), num_pairs, process_count())


def allgather_host_arrays(arr: np.ndarray) -> np.ndarray:
    """All-gather a host array of the same shape and dtype on every process;
    returns [num_processes, ...].  The bytes travel as they are."""
    arr = np.ascontiguousarray(arr)
    P = process_count()
    if P == 1:
        return arr[None]
    if arr.nbytes == 0:
        return np.zeros((P,) + arr.shape, arr.dtype)
    t = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
    out = [torch.empty_like(t) for _ in range(P)]
    dist.all_gather(out, t, group=host_group())
    return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                     for o in out])


def broadcast_host_arrays(*arrays):
    """Rank 0's ``arrays`` on every process, byte for byte (every process
    passes arrays of the same shapes and dtypes); the arrays themselves
    in a single process.

    A stage that every rank runs whole on its own card (view-graph
    calibration, rotation averaging) sums with float atomics in another
    order on each card, so its results differ in the last bits from rank
    to rank; the host decisions that follow (thresholds, filters, the
    problems the sharded solves share) must be the same on every rank, so
    every rank takes rank 0's result."""
    if process_count() == 1:
        return arrays
    out = []
    for arr in arrays:
        arr = np.ascontiguousarray(arr)
        t = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
        if t.numel():
            dist.broadcast(t, 0, group=host_group())
        out.append(t.numpy().view(arr.dtype).reshape(arr.shape))
    return tuple(out)


def gather_pair_results(local_idx: np.ndarray, local_vals: np.ndarray,
                        num_pairs: int, fill=0) -> np.ndarray:
    """Exchange per-item results computed on strided slices.

    local_idx: [p] global indices this process computed; local_vals:
    [p, ...] their results.  Every process returns the full
    [num_pairs, ...] array.  Slices are padded to the longest (they differ
    by at most one)."""
    P = process_count()
    cap = -(-num_pairs // P)
    pad = cap - len(local_idx)
    idx = np.concatenate([np.asarray(local_idx, np.int64),
                          np.full(pad, -1, np.int64)])
    vals = np.concatenate(
        [local_vals,
         np.full((pad,) + local_vals.shape[1:], fill, local_vals.dtype)])
    all_idx = allgather_host_arrays(idx).reshape(-1)
    all_vals = allgather_host_arrays(vals).reshape(
        (-1,) + local_vals.shape[1:])
    out = np.full((num_pairs,) + local_vals.shape[1:], fill,
                  local_vals.dtype)
    ok = all_idx >= 0
    out[all_idx[ok]] = all_vals[ok]
    return out


def match_pairs_distributed(descriptors, valids, pairs, ratio=0.8,
                            max_matches=2048, pair_batch=16,
                            matcher_fn=None, device="cuda"):
    """Process-sharded matching: each process matches its strided slice of
    ``pairs``, then every process receives the full {(i, j): matches}.

    ``matcher_fn(pairs_subset) -> {(i, j): matches}`` replaces the mutual
    nearest-neighbour ratio matcher (LightGlue passes one); its matches
    must number at most ``max_matches``, the exchange's capacity."""
    from instantsfm_tpu_torch.features.matching import match_all_pairs

    if matcher_fn is None:
        matcher_fn = lambda ps: match_all_pairs(
            descriptors, valids, ratio=ratio, max_matches=max_matches,
            pair_batch=pair_batch, pairs=ps, device=device)

    pairs = list(pairs)
    E = len(pairs)
    if process_count() == 1:
        return matcher_fn(pairs)

    mine = local_pair_slice(E)
    local = matcher_fn([pairs[k] for k in mine])
    vals = np.full((len(mine), max_matches, 2), -1, np.int32)
    cnts = np.zeros(len(mine), np.int32)
    for r, k in enumerate(mine):
        m = local[pairs[k]]
        if len(m) > max_matches:
            raise ValueError(f"pair {pairs[k]}: {len(m)} matches > the "
                             f"exchange's max_matches={max_matches}")
        vals[r, :len(m)] = m
        cnts[r] = len(m)
    all_vals = gather_pair_results(mine, vals, E, fill=-1)
    all_cnts = gather_pair_results(mine, cnts, E, fill=0)
    return {pairs[k]: all_vals[k, :all_cnts[k]] for k in range(E)}
