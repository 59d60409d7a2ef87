"""Host microseconds a PCG iteration: the self seconds of the program's
``pcg.iter`` spans (the iteration's launches; its exit test's read is a
span of its own) in the window's ``lm.step`` roots, over their count.
The dispatch a CUDA graph or a fused iteration would cut."""

from program_roots import window_roots


def read(run):
    roots = window_roots(run, "lm.step", int(run["traffic"]["steps"]))
    if not roots:
        return None
    spans = [r["spans"]["pcg.iter"] for r in roots if "pcg.iter" in r["spans"]]
    n = sum(s[0] for s in spans)
    return 1e6 * sum(s[2] for s in spans) / n if n else None
