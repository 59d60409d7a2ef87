"""PCG iterations an LM step (the program's ``pcg_iters`` counter over the
window's steps)."""


def read(run):
    steps = sum(u["work"] for u in run["units"])
    iters = sum(u["counters"].get("pcg_iters", 0) for u in run["units"])
    return iters / steps if steps and iters else None
