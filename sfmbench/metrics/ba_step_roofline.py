"""The LM step's share of its roofline: the least time the card needs for
one step of the problem (``roofline.lm_step_cost`` on its observations,
cameras, points and camera parameters, at the PCG iterations the window's
steps ran, camera sums at 2 FLOPs a float) over the window's seconds a
step, in percent."""

from yardstick import roofline
from yardstick.readers import chip


def read(run):
    s = run["sizes"]
    steps = sum(u["work"] for u in run["units"])
    iters = sum(u["counters"].get("pcg_iters", 0) for u in run["units"])
    if not steps or "O" not in s:
        return None
    cost = roofline.lm_step_cost(O=s["O"], C=s["C"], T=s["T"], PC=s["PC"],
                                 res_dim=s["res_dim"], cg_iters=iters / steps,
                                 onehot_cam_reduce=False)
    spec = chip(run)
    if spec is None:
        return None
    t = roofline.bound_s(cost.flops, cost.hbm_bytes, spec=spec)
    return 100.0 * t / (run["window_s"] / steps)
