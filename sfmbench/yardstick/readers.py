"""What the per-layer readers share: means over the window's units and
the device's idle share.

A reader gets the run: ``units`` (the unprofiled window's records: their
``seconds``, ``work``, the program's ``spans`` and ``counters``),
``window_s``, ``trace`` (``trace.reduce_trace`` of the profiled units after
the window, with their records under ``units``), ``sizes`` (the problem's
sizes as the benchmark built it), ``config``, ``traffic`` and
``device_name``.  Rates and shares that divide by time use the unprofiled
window.
"""

from __future__ import annotations


def mean_span(run: dict, key: str):
    """Mean seconds a unit of the window spent in the program's span
    ``key``, or None where no unit has it."""
    vals = [u["spans"][key] for u in run["units"] if key in u["spans"]]
    return sum(vals) / len(vals) if vals else None


def per_unit_counter(run: dict, key: str):
    vals = [u["counters"][key] for u in run["units"] if key in u["counters"]]
    return sum(vals) / len(vals) if vals else None


def idle_share_pct(run: dict):
    """100 (1 - device-busy seconds a unit in the profiled units / wall
    seconds a unit in the unprofiled window)."""
    trace = run.get("trace")
    if not trace or not trace.get("units") or trace["busy_s"] <= 0:
        return None
    busy = trace["busy_s"] / len(trace["units"])
    wall = run["window_s"] / len(run["units"])
    return 100.0 * (1.0 - busy / wall)


def chip(run: dict):
    """The card's published peaks, or None for a device without them (a
    CPU run states no roofline share)."""
    from yardstick import roofline
    try:
        return roofline.chip_spec(run["device_name"])
    except ValueError:
        return None
