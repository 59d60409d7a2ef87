"""Milliseconds a unit in the DefaultStrategy's refine: the ``gs.refine``
spans' seconds in the window's ``gs.step`` roots, over the window's
units."""

from program_roots import window_roots


def read(run):
    steps = int(run["traffic"]["steps"])
    roots = window_roots(run, "gs.step", steps)
    if not roots:
        return None
    sec = sum(r["spans"]["gs.refine"][1] for r in roots
              if "gs.refine" in r["spans"])
    return 1e3 * sec / (len(roots) / steps) if sec > 0 else None
