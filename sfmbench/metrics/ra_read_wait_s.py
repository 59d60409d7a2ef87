"""Seconds a mapper pass waits on rotation averaging's host reads: the
wait of the ``ra.*`` read sites (CG blocks, ADMM iterations, L1 and IRLS
rounds, the result) in the window's ``mapper`` roots of the program's
registry, over the roots."""

from program_roots import reads, window_roots


def read(run):
    roots = window_roots(run, "mapper")
    return reads(roots, "ra.")[1] if roots else None
