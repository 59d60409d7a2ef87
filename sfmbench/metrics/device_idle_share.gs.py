"""Share of a 3DGS unit's wall time in which the device runs nothing: the
device-busy seconds a unit in the profiled unit after the window, over
the wall seconds a unit of the unprofiled window."""

from program_roots import window_roots
from yardstick.readers import idle_share_pct


def read(run):
    if not window_roots(run, "gs.step", int(run["traffic"]["steps"])):
        return None
    return idle_share_pct(run)
