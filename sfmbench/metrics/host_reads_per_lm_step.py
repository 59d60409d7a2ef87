"""Host reads an LM step: every ``debug.read`` (PCG's exit tests, the
accept test) in the window's ``lm.step`` roots of the program's registry,
over the roots."""

from program_roots import reads, window_roots


def read(run):
    roots = window_roots(run, "lm.step", int(run["traffic"]["steps"]))
    return reads(roots)[0] if roots else None
