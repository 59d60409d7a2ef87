"""The 3DGS step's share of its roofline: the least time the card needs
for one step (the frozen ``gs_roofline.gs_step_cost`` at the window's
alive gaussians, gaussian-tile pairs, entered chunks and live pairs, as
the warm-up unit counted them) over the window's seconds a step, in
percent."""

from program_roots import window_roots
from yardstick import gs_roofline
from yardstick.readers import chip


def read(run):
    steps = int(run["traffic"]["steps"])
    work = run["sizes"].get("work")
    spec = chip(run)
    if not window_roots(run, "gs.step", steps) or not work or spec is None:
        return None
    cost = gs_roofline.gs_step_cost(**work)
    t = gs_roofline.bound_s(cost.hbm_bytes, cost.flops, cost.sfu, spec)
    n = sum(u["work"] for u in run["units"])
    return 100.0 * t / (run["window_s"] / n)
