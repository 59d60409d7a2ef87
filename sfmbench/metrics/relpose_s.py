"""Seconds a mapper pass spends in the program's ``relative_pose_estimation`` stage (its
``timings``, after a device sync), mean over the window's passes."""

from yardstick.readers import mean_span


def read(run):
    return mean_span(run, "relative_pose_estimation")
