"""Share of the LM steps' damped solves on the PCG path that took the
solve kernels: the program's run counter ``lm_solve_kernel`` over
``lm_solve_kernel`` and ``lm_solve_torch`` in the window's ``lm.step``
roots, in percent.  None where the roots carry neither counter, as in a
program without the solve kernels."""

from program_roots import window_roots


def read(run):
    roots = window_roots(run, "lm.step", int(run["traffic"]["steps"]))
    if not roots:
        return None
    count = lambda name: sum(r.get("counters", {}).get(name, 0)
                             for r in roots)
    kernel, torch_ = count("lm_solve_kernel"), count("lm_solve_torch")
    return 100.0 * kernel / (kernel + torch_) if kernel + torch_ else None
