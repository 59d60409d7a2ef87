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


def count_syncs(fn):
    """(result of ``fn()``, host synchronisations it made): CUDA's sync
    debug mode warns at every operation that waits for the device (a
    readback, ``.item()``, ``bool`` of a tensor), and the warnings are
    counted.  The mode costs host time, so time no run made under it."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return out, n


def device_breakdown(step, n: int, top: int = 30):
    """``step()`` run ``n`` times under ``torch.profiler``: device self-time
    by kernel name divided by ``n``, largest first, the device-busy time a
    step and its idle share of the wall time.  Where ``key_averages()``
    holds no device time, the steps run again between CUDA events, whose
    totals (which include the device's idle gaps) stand in, and the record
    says so.  Returns (record, the profiler, for ``export_chrome_trace``)."""
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
    rows = sorted(((ev.self_device_time_total, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and ev.self_device_time_total > 0), reverse=True)
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
