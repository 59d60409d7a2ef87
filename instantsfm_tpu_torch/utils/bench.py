"""Helpers of the measuring entry points (``bench_*_torch.py`` and
``tools/*_torch.py`` at the repository root): the card's record, host
memory, and device time by kernel under ``torch.profiler``.

A measurement runs on the card or not at all: ``require_card`` raises
without one, so no CPU run prints a number under a device metric's name.
"""

from __future__ import annotations

import resource
import subprocess
import time

import torch


def require_card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs a CUDA card; none is "
                           "available")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def device_record() -> dict:
    """Name, power limit and count of the cards, for every JSON line that
    carries a time."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(), "nvidia_smi": card_line()}


def peak_host_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def device_breakdown(step, n: int, top: int = 30):
    """``step()`` run ``n`` times under ``torch.profiler``: device self-time
    by kernel name divided by ``n``, largest first (``record_function``
    scopes left out: their device rows are their kernels' spans), the
    device-busy time a step and its idle share of the wall time.  Where
    ``key_averages()`` holds no device time, the steps run again between
    CUDA events, whose totals (which include the device's idle gaps) stand
    in, and the record says so.  Returns (record, the profiler, for ``export_chrome_trace``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    # a record_function scope (the step's own, Optimizer.step#...) shows on
    # the device as the span of its kernels: not device time of its own
    scopes = {e.name for e in prof.events() if e.is_user_annotation}
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0
                   and ev.key not in scopes), reverse=True)
    if rows:
        busy_ms = sum(r[0] for r in rows) / 1e3 / n
        return dict(source="torch.profiler", steps=n, wall_ms_per_step=wall_ms,
                    device_busy_ms_per_step=busy_ms,
                    device_idle_share=1 - busy_ms / wall_ms,
                    kernels=[dict(name=name[:100], ms_per_step=us / 1e3 / n,
                                  calls_per_step=c / n,
                                  share=us / 1e3 / n / busy_ms)
                             for us, c, name in rows[:top]]), prof
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        step()
    end.record()
    torch.cuda.synchronize()
    return dict(source="cuda_events (the profiler recorded no device time; "
                       "the total includes the device's idle gaps)",
                steps=n, wall_ms_per_step=wall_ms,
                device_ms_per_step=start.elapsed_time(end) / n,
                device_busy_ms_per_step=None, device_idle_share=None,
                kernels=[]), prof


def time_by_scope(prof, n: int, scopes: dict, by_name: dict = None,
                  device: bool = True):
    """Time a step of ``n`` profiled steps, by part: ({part: ms},
    [(name, ms) of what no part took, largest first]).

    ``scopes`` maps the start of a scope's name (a ``record_function``, or
    torch's own ``Optimizer.step#``) to its (forward, backward) parts.  An
    op inside a scope goes to its forward part; an op of the backward goes
    to the backward part of the scope its forward op ran in (an autograd
    node carries its forward op's sequence number).  With ``device`` the
    device kernels are timed, each by the op that launched it, and a kernel
    whose name holds a key of ``by_name`` goes to that part whatever
    launched it; without, the ops' own host time is (the profiler of a CPU
    run)."""
    def scope(e):
        for key, parts in scopes.items():
            if e.name.startswith(key):
                return parts
        return None

    seq = {}
    for e in prof.events():
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            p = e
            while p is not None and scope(p) is None:
                p = p.cpu_parent
            if p is not None:
                seq[e.sequence_nr] = scope(p)[1]

    def part_of(e):
        while e is not None:
            if scope(e) is not None:
                return scope(e)[0]
            if (e.name.startswith("autograd::engine::evaluate_function")
                    and e.sequence_nr in seq):
                return seq[e.sequence_nr]
            e = e.cpu_parent
        return None

    parts, rest = {}, {}
    for e in prof.events():
        if device:
            items = [(k.name, k.duration) for k in e.kernels]
        else:
            items = [(e.name, e.self_cpu_time_total)]
        for name, us in items:
            part = next((v for k, v in (by_name or {}).items() if k in name),
                        None) or part_of(e)
            into, key = (parts, part) if part else (rest, name)
            into[key] = into.get(key, 0.0) + us / 1e3 / n
    return parts, sorted(rest.items(), key=lambda kv: -kv[1])


def print_breakdown(rec: dict) -> None:
    print(f"{'kernel (device self time)':<60} {'ms/step':>9} "
          f"{'calls':>7} {'share':>6}")
    for k in rec["kernels"]:
        print(f"{k['name'][:60]:<60} {k['ms_per_step']:>9.3f} "
              f"{k['calls_per_step']:>7.1f} {k['share']:>6.1%}")
    if rec["device_busy_ms_per_step"] is not None:
        print(f"device busy {rec['device_busy_ms_per_step']:.3f} ms of "
              f"{rec['wall_ms_per_step']:.3f} ms a step (idle share "
              f"{rec['device_idle_share']:.3f})")
    else:
        print(f"{rec['source']}: {rec['device_ms_per_step']:.3f} ms a step")
