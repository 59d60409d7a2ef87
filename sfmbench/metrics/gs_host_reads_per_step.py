"""Host reads a 3DGS training step: every ``debug.read`` (the tile sizes,
the loss, the refine's counts, the scalar log's) in the window's
``gs.step`` roots of the program's registry, over the roots."""

from program_roots import reads, window_roots


def read(run):
    roots = window_roots(run, "gs.step", int(run["traffic"]["steps"]))
    return reads(roots)[0] if roots else None
