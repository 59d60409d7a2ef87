"""Host reads of rotation averaging's blocked loops a mapper pass (the
program's ``ra_syncs`` counter: CG blocks, ADMM iterations, L1 and IRLS
rounds), mean over the window's passes."""

from yardstick.readers import per_unit_counter


def read(run):
    return per_unit_counter(run, "ra_host_reads")
