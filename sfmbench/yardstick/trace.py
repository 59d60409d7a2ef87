"""Reduction of a ``torch.profiler`` trace to device time and host scopes.

``reduce_trace`` reads the profiler's raw events: the device's operations
(kernels, copies and fills; not the device-side spans of ``record_function``
scopes) and the host's.  It returns the device-busy seconds (the union of
the operations' intervals, so overlapping streams count once), the device
time and count of each operation by name, and the device's idle gaps named
by what the host was doing when each began: the innermost
``record_function`` scope open on the main thread (the program's
``stage:<name>`` and ``gs:`` scopes) and the innermost host operation
inside it.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def _segments(intervals):
    """Elementary segments of properly nested ``(start, end, label)``
    intervals, each labelled by the innermost interval open over it
    (``None`` where none is).  Returns (boundaries [n + 1], labels [n])."""
    ivs = sorted(intervals, key=lambda v: (v[0], -v[1]))
    bounds, labels, stack = [], [], []

    def emit(t):
        if bounds and t <= bounds[-1]:
            labels[-1] = stack[-1][2] if stack else None
            return
        bounds.append(t)
        labels.append(stack[-1][2] if stack else None)

    for s, e, name in ivs:
        while stack and stack[-1][1] <= s:
            end = stack.pop()[1]
            emit(end)
        stack.append((s, e, name))
        emit(s)
    while stack:
        end = stack.pop()[1]
        emit(end)
    return np.array(bounds, np.int64), labels


def _label_at(seg, t):
    bounds, labels = seg
    if not len(bounds):
        return None
    i = int(np.searchsorted(bounds, t, side="right")) - 1
    return labels[i] if 0 <= i < len(labels) else None


def reduce_trace(prof, top: int = 10) -> dict:
    """Device busy seconds, the window's seconds (first host event to the
    last device or host event), device seconds and counts by operation
    name, and idle seconds by host scope, each list largest first."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation() and d > 0:
                dev.append((s, s + d, e.name()))
        elif e.device_type() == DeviceType.CPU and d >= 0:
            host.append((s, s + d, e.name(), e.start_thread_id(),
                         e.is_user_annotation()))
    if not dev:
        return dict(busy_s=0.0, window_s=0.0, ops=[], idle=[], launches={})

    by_name, counts = defaultdict(float), defaultdict(int)
    for s, e, name in dev:
        by_name[name] += (e - s) * 1e-9
        counts[name] += 1
    iv = np.array([(s, e) for s, e, _ in dev], np.int64)
    iv = iv[np.argsort(iv[:, 0])]
    busy, gaps = 0, []
    cur_s, cur_e = iv[0]
    for s, e in iv[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s

    # the main thread: the one that opened the most scopes
    threads = defaultdict(int)
    for h in host:
        threads[h[3]] += 1 + 1000 * h[4]
    main = max(threads, key=threads.get) if threads else None
    mine = [h for h in host if h[3] == main]
    scopes = _segments([(s, e, n) for s, e, n, _, u in mine if u])
    ops = _segments([(s, e, n) for s, e, n, _, u in mine if not u])
    idle = defaultdict(float)
    for s, e in gaps:
        label = (_label_at(scopes, s) or "(no scope)") + " > " + \
            (_label_at(ops, s) or "python")
        idle[label] += (e - s) * 1e-9
    t0 = min([h[0] for h in mine] + [int(iv[0, 0])])
    t1 = max([h[1] for h in mine] + [int(iv[:, 1].max())])
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])
    return dict(busy_s=busy * 1e-9, window_s=(t1 - t0) * 1e-9,
                ops=order(by_name)[:top], idle=order(idle)[:top],
                device_s=dict(by_name), launches=dict(counts))


def device_seconds(trace: dict, key: str) -> tuple:
    """(seconds, launches) of the device operations whose name holds
    ``key``."""
    sec = sum(v for k, v in trace.get("device_s", {}).items() if key in k)
    n = sum(v for k, v in trace.get("launches", {}).items() if key in k)
    return sec, n
