"""Share of the damped solves whose PCG ran as captured CUDA graphs: the
program's ``pcg.graph`` spans over its ``lm.solve`` spans in the window's
``lm.step`` roots, in percent.  None where no ``pcg.graph`` span was
closed, as in a program without the graph path."""

from program_roots import window_roots


def read(run):
    roots = window_roots(run, "lm.step", int(run["traffic"]["steps"]))
    if not roots:
        return None
    count = lambda name: sum(r["spans"].get(name, (0,))[0] for r in roots)
    graphs, solves = count("pcg.graph"), count("lm.solve")
    return 100.0 * graphs / solves if graphs and solves else None
