"""K1's share of its roofline: the least time the card needs for one
Schur-chain product of the problem (``roofline.k1_cost`` on its
observations, points, cameras and camera parameters) over K1's device
seconds a launch in the profiled units (kernels named
``schur_wchain_kernel``), in percent."""

from yardstick import roofline
from yardstick.readers import chip
from yardstick.trace import device_seconds


def read(run):
    s = run["sizes"]
    sec, n = device_seconds(run.get("trace") or {}, "schur_wchain_kernel")
    if not n or sec <= 0 or "O" not in s:
        return None
    cost = roofline.k1_cost(O=s["O"], C=s["C"], T=s["T"], PC=s["PC"])
    spec = chip(run)
    if spec is None:
        return None
    return 100.0 * roofline.bound_s(cost.flops, cost.hbm_bytes,
                                    spec=spec) / (sec / n)
