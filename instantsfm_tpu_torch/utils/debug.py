"""Host wall-clock spans and run counters.

Counterpart of ``instantsfm_tpu/utils/debug.py``.  Set ``ISFM_DEBUG_TIMING=1``
to print per-span seconds.  Spans time the host; a span around device work
measures device time only where the work ends in a synchronisation.
"""

from __future__ import annotations

import os
import time

ENABLED = bool(os.environ.get("ISFM_DEBUG_TIMING"))

# run counters (LM iterations per solve, PCG iterations per damped solve):
# appended by the solvers, drained by drivers such as chip_smoke.py
STATS: dict = {}


def stat_add(name: str, value) -> None:
    STATS.setdefault(name, []).append(value)


def drain_stats() -> dict:
    out = {k: list(v) for k, v in STATS.items()}
    STATS.clear()
    return out


class span:
    """``with span("name"):`` — prints elapsed seconds when enabled."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if ENABLED:
            print(f"    [t] {self.name}: {time.time() - self.t0:.2f}s",
                  flush=True)
        return False
