"""MW iterations a probe ran, summed over its matrices (the solves' own counts)."""

from portbench import readers


def read(run):
    return readers.per_unit(run, "mw_iters")
