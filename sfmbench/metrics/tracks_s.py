"""Seconds a mapper pass spends in the program's ``track_establishment`` stage (its
``timings``, after a device sync), mean over the window's passes."""

from yardstick.readers import mean_span


def read(run):
    return mean_span(run, "track_establishment")
