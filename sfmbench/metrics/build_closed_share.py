"""Share of the LM steps' system builds that took the closed form: the
program's run counter ``lm_build_closed`` over ``lm_build_closed`` and
``lm_build_autodiff`` in the window's ``lm.step`` roots, in percent.  None
where the roots carry neither counter, as in a program without the
closed-form build."""

from program_roots import window_roots


def read(run):
    roots = window_roots(run, "lm.step", int(run["traffic"]["steps"]))
    if not roots:
        return None
    count = lambda name: sum(r.get("counters", {}).get(name, 0)
                             for r in roots)
    closed, autodiff = count("lm_build_closed"), count("lm_build_autodiff")
    return 100.0 * closed / (closed + autodiff) if closed + autodiff else None
