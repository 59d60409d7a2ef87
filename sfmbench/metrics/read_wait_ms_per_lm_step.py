"""Milliseconds an LM step the host stands blocked on the device: the
wait of every ``debug.read`` in the window's ``lm.step`` roots of the
program's registry, over the roots."""

from program_roots import reads, window_roots


def read(run):
    roots = window_roots(run, "lm.step", int(run["traffic"]["steps"]))
    return 1e3 * reads(roots)[1] if roots else None
