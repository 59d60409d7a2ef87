"""The port's tracing registry: named spans, host reads and run counters.

Counterpart of ``instantsfm_tpu/utils/debug.py``.

* ``span(name)`` is a context manager (``traced(name)`` the decorator that
  runs a function in it) that keeps, per name, the count, the total
  seconds and the self seconds (the total less the time its child spans
  cover), on ``time.perf_counter``.  Spans nest on the main thread's
  stack.  While a ``torch.profiler`` is active a span also opens a
  ``record_function(name)`` scope, so a trace shows it on the profiler's
  clock beside the device's operations; otherwise it costs a profiler
  check, two clock reads and a dict update.  A span never synchronises the
  device.  Names are fixed and dotted (``lm.step``, ``stage:<stage>``,
  ``read:<site>``), never formatted from data.
* ``read(site, x)`` is the one device-to-host read: ``x``'s host value,
  counted under ``site`` and timed as the span ``read:<site>``, so its wait
  is not its parent's self time and names the device's idle gap in a trace.
* A span that closes with no span open above it is a root: a record of
  numbers (its name and seconds, the count, total and self seconds of
  every span, and the count and wait of every read site, gathered while it
  was open) goes into a ring of the last ``RING_SIZE`` roots, and
  ``roots_closed`` counts every root.  Spans on other threads open their
  profiler scope and keep nothing.

``STATS`` holds run counters (LM iterations a solve, PCG iterations a
damped solve, ...), appended by the solvers and drained by the measuring
scripts and the benchmark's units; ``drain_stats`` leaves the ring alone.
"""

from __future__ import annotations

import functools
import threading
from collections import deque
from time import perf_counter

from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

RING_SIZE = 16384

STATS: dict = {}


def stat_add(name: str, value) -> None:
    STATS.setdefault(name, []).append(value)


def drain_stats() -> dict:
    out = {k: list(v) for k, v in STATS.items()}
    STATS.clear()
    return out


def _host(x):
    """A 0-dim tensor as a Python scalar, a tensor as a numpy array, a
    tuple or list of tensors as a tuple of those."""
    if isinstance(x, (tuple, list)):
        return tuple(_host(v) for v in x)
    if x.dim() == 0:
        return x.item()
    return x.detach().cpu().numpy()


class Registry:
    """Spans, host reads and root records of one process (``REGISTRY``)."""

    def __init__(self, ring_size: int = RING_SIZE):
        self.ring = deque(maxlen=ring_size)
        self.roots_closed = 0
        # name -> [count, total s, self s], over the roots closed so far
        self.totals = {}
        self._stack = []
        self._open = {}          # the open root's spans, as in ``totals``
        self._main = threading.main_thread().ident

    def span(self, name: str) -> "_Span":
        return _Span(self, name)

    def read(self, site: str, x):
        """``x``'s host value (see ``_host``), counted and timed under
        ``site``."""
        with _Span(self, "read:" + site):
            return _host(x)

    def roots(self, name: str) -> list:
        """The ring's records of the roots named ``name``, oldest first."""
        return [r for r in self.ring if r["name"] == name]

    def read_count(self) -> int:
        """Reads in the roots closed so far."""
        return sum(v[0] for k, v in self.totals.items()
                   if k.startswith("read:"))

    def _close_root(self, name: str, seconds: float) -> None:
        spans, self._open = self._open, {}
        reads = {}
        for key, (n, total, own) in spans.items():
            if key.startswith("read:"):
                reads[key[5:]] = (n, total)
            t = self.totals.get(key)
            if t is None:
                self.totals[key] = [n, total, own]
            else:
                t[0] += n
                t[1] += total
                t[2] += own
        self.ring.append(dict(name=name, seconds=seconds, spans={
            k: tuple(v) for k, v in spans.items()}, reads=reads))
        self.roots_closed += 1


class _Span:
    __slots__ = ("reg", "name", "t0", "child", "scope")

    def __init__(self, reg: Registry, name: str):
        self.reg = reg
        self.name = name

    def __enter__(self):
        self.scope = None
        if _profiler_enabled():
            self.scope = record_function(self.name)
            self.scope.__enter__()
        self.child = None
        if threading.get_ident() == self.reg._main:
            self.child = 0.0
            self.reg._stack.append(self)
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self.t0
        if self.child is not None:
            reg = self.reg
            stack = reg._stack
            stack.pop()
            acc = reg._open.get(self.name)
            if acc is None:
                reg._open[self.name] = [1, dt, dt - self.child]
            else:
                acc[0] += 1
                acc[1] += dt
                acc[2] += dt - self.child
            if stack:
                stack[-1].child += dt
            else:
                reg._close_root(self.name, dt)
        if self.scope is not None:
            self.scope.__exit__(*exc)
        return False


REGISTRY = Registry()
span = REGISTRY.span
read = REGISTRY.read


def traced(name: str):
    """Decorator: every call of the function is the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
