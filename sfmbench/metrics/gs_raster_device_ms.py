"""Device milliseconds a 3DGS step in the rasterizer's tile sort, gather
and compositing, in the profiled unit: the kernels whose names hold
``KERNELS`` (K2 and K3; the radix sort of the (tile, depth) keys; the
gathers and scatters of the expansion and of the tiles' windows and their
transposes; the scans), over the unit's steps.  No other part of a step
launches these kernels, but for the refine's few gathers once a unit."""

from program_roots import window_roots
from yardstick.trace import device_seconds

KERNELS = ("composite_fwd_kernel", "composite_bwd_kernel", "RadixSort",
           "vectorized_gather_kernel", "indexSelect", "indexFunc",
           "index_elementwise", "DeviceScan")


def read(run):
    steps = int(run["traffic"]["steps"])
    trace = run.get("trace") or {}
    n = sum(u["work"] for u in trace.get("units") or ())
    if not window_roots(run, "gs.step", steps) or not n:
        return None
    sec = sum(device_seconds(trace, k)[0] for k in KERNELS)
    return 1e3 * sec / n if sec > 0 else None
