"""Host reads a mapper pass: every ``debug.read`` of every stage in the
window's ``mapper`` roots of the program's registry, over the roots."""

from program_roots import reads, window_roots


def read(run):
    roots = window_roots(run, "mapper")
    return reads(roots)[0] if roots else None
