"""The window's root records from the program's tracing registry, for the
per-layer readers.

The program (``instantsfm_tpu_torch/utils/debug.py``) keeps a ring of root
records, one for every span that closed with no span open above it: the
name, the count and self seconds of every span, and the count and wait of
every host-read site, gathered while it was open.  In the BA cell the
roots are the ``k = steps`` ``lm.step`` calls of each unit, in the mapper
cell the one ``mapper`` span of each pass.  A run's last ``(W + P) k``
roots of that name are the window's ``W`` units and then the ``P``
profiled units; the window's are all but the last ``P k``.

This module reads the program, so it lives outside ``yardstick/``.
"""

from __future__ import annotations


def window_roots(run: dict, name: str, k: int = 1):
    """The window's root records named ``name`` (``k`` a unit), oldest
    first, or None where the program keeps no registry or its ring no
    longer holds the window's first record."""
    try:
        from instantsfm_tpu_torch.utils import debug
    except ImportError:
        return None
    registry = getattr(debug, "REGISTRY", None)
    if registry is None:
        return None
    W = len(run["units"])
    P = len((run.get("trace") or {}).get("units") or ())
    roots = registry.roots(name)
    if not W or len(roots) < (W + P) * k:
        return None
    return roots[len(roots) - (W + P) * k:][:W * k]


def reads(roots: list, prefix: str = "") -> tuple:
    """(reads, wait seconds) a root at the read sites that start with
    ``prefix``."""
    n = wait = 0
    for r in roots:
        for site, (count, seconds) in r["reads"].items():
            if site.startswith(prefix):
                n += count
                wait += seconds
    return n / len(roots), wait / len(roots)
