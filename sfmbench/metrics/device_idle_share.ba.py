"""Share of a unit's wall time in which the device runs nothing: the
device-busy seconds a unit from the profiled units after the window, over
the wall seconds a unit of the unprofiled window."""

from yardstick.readers import idle_share_pct


def read(run):
    return idle_share_pct(run)
