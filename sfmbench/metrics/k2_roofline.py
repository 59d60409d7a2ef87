"""K2's share of its roofline: the least bytes of the forward compositing
over the chunks a step's tiles entered (the frozen ``gs_roofline.k23_bytes``
at the window's counts) at the card's memory rate, over
``composite_fwd_kernel``'s device seconds a launch in the profiled unit,
in percent."""

from program_roots import window_roots
from yardstick import gs_roofline
from yardstick.readers import chip
from yardstick.trace import device_seconds

KERNEL, NAME = "composite_fwd_kernel", "K2"


def share(run, kernel, name):
    steps = int(run["traffic"]["steps"])
    s = run["sizes"]
    spec = chip(run)
    sec, n = device_seconds(run.get("trace") or {}, kernel)
    if not window_roots(run, "gs.step", steps) or "work" not in s \
            or spec is None or not n or sec <= 0:
        return None
    work = dict(s["work"], pairs=s["work"]["chunks_entered"]
                * gs_roofline.CHUNK * gs_roofline.P)
    nbytes = gs_roofline.k23_bytes(name, work, s["tiles"],
                                   pixels=s["width"] * s["height"])
    return 100.0 * nbytes / spec.peak_bw / (sec / n)


def read(run):
    return share(run, KERNEL, NAME)
