"""Probe of a machine's cards for the port's multi-process paths.

Started by torchrun, one process per card, from the repository root:

    torchrun --nproc_per_node=4 tools/probe_nccl_torch.py

Every rank joins the default NCCL group through the port's
``parallel.multihost.initialize`` (torchrun's variables, ``cuda:LOCAL_RANK``)
with ``NCCL_DEBUG=INFO`` written to ``nccl_probe/`` under
``chip_smoke.OUT_DIR`` (one file a process), then runs ``all_reduce``,
``all_gather`` and ``all_to_all_single`` on CUDA tensors and checks each
result exactly (integers held in float32), and times ``all_reduce`` of
256 MiB (CUDA events, the median of 5 after 2 warm-ups; bus bandwidth
2(n-1)/n of the algorithm's).  Rank 0 prints the name and power limit of every card
(``nvidia-smi``), ``nvidia-smi topo -m``, ``free -g``, the torch, NCCL and
CUDA versions, the transports NCCL chose (its ``via`` lines), and ONE JSON
line last.  Exits non-zero where a check fails or a rank does not end.
"""

import glob
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch
import torch.distributed as dist

from instantsfm_tpu_torch.parallel import multihost

from chip_smoke import OUT_DIR

OUT = os.path.join(OUT_DIR, "nccl_probe")
TIMED_BYTES = 256 << 20


def _run(cmd):
    r = subprocess.run(cmd, capture_output=True, text=True)
    return (r.stdout + r.stderr).strip()


def timed_all_reduce(x, reps=5):
    """Median ms of ``all_reduce(x)`` over ``reps`` runs, after 2."""
    for _ in range(2):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        dist.barrier(group=multihost.host_group())
        start.record()
        dist.all_reduce(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def collectives(rank, world, dev):
    """Each collective on CUDA tensors, checked exactly."""
    x = torch.full((1024,), float(rank + 1), device=dev)
    dist.all_reduce(x)
    reduce_ok = bool((x == world * (world + 1) / 2).all())
    parts = [torch.empty(8, device=dev) for _ in range(world)]
    dist.all_gather(parts, torch.full((8,), float(rank), device=dev))
    gather_ok = all(bool((p == r).all()) for r, p in enumerate(parts))
    # block s of rank r's send holds 100 r + s; rank r receives 100 s + r
    send = torch.cat([torch.full((4,), 100.0 * rank + s, device=dev)
                      for s in range(world)])
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    want = torch.cat([torch.full((4,), 100.0 * s + rank, device=dev)
                      for s in range(world)])
    return dict(all_reduce=reduce_ok, all_gather=gather_ok,
                all_to_all_single=bool((recv == want).all()))


def transports(paths):
    """NCCL's ``via`` lines (channel transports), without the host and
    process prefix, each once."""
    seen = []
    for p in paths:
        with open(p, errors="replace") as f:
            for line in f:
                if " via " in line:
                    s = re.sub(r"^.*?NCCL INFO ", "", line.strip())
                    if s not in seen:
                        seen.append(s)
    return seen


def main():
    if not torch.cuda.is_available():
        print("probe_nccl_torch: no CUDA device available", file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    os.environ["NCCL_DEBUG"] = "INFO"
    os.environ["NCCL_DEBUG_SUBSYS"] = "INIT,P2P,NET,GRAPH,ENV"
    os.environ["NCCL_DEBUG_FILE"] = os.path.join(OUT, "nccl.%h.%p.log")
    t0 = time.perf_counter()
    if not multihost.initialize(device="cuda"):
        print("probe_nccl_torch: start it with torchrun, two or more "
              "processes", file=sys.stderr)
        return 1
    rank, world = multihost.process_index(), multihost.process_count()
    dev = torch.device("cuda", torch.cuda.current_device())
    checks = collectives(rank, world, dev)
    first_s = time.perf_counter() - t0
    x = torch.ones(TIMED_BYTES // 4, device=dev)
    ms = timed_all_reduce(x)
    algbw = TIMED_BYTES / (ms / 1e3) / 1e9
    rec = dict(rank=rank, device=str(dev),
               name=torch.cuda.get_device_name(dev),
               first_collectives_s=first_s, checks=checks,
               all_reduce_256MiB_ms=ms, algbw_GBps=algbw,
               busbw_GBps=algbw * 2 * (world - 1) / world)
    recs = [None] * world
    dist.all_gather_object(recs, rec, group=multihost.host_group())
    ok = all(all(r["checks"].values()) for r in recs) \
        and len({r["device"] for r in recs}) == world
    if rank == 0:
        print("nvidia-smi:\n" + _run(["nvidia-smi",
                                      "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"]))
        print("nvidia-smi topo -m:\n" + _run(["nvidia-smi", "topo", "-m"]))
        print("free -g:\n" + _run(["free", "-g"]))
        nccl = ".".join(map(str, torch.cuda.nccl.version()))
        print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
              f"nccl {nccl}, python {sys.version.split()[0]}")
    multihost.shutdown()
    if rank == 0:
        via = transports(sorted(glob.glob(os.path.join(OUT, "nccl.*.log"))))
        print("NCCL transports:\n" + "\n".join(via[:24]))
        print(json.dumps(dict(ok=ok, world=world, ranks=recs,
                              transports=via[:8], nccl=nccl)), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
