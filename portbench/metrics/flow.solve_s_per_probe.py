"""Seconds a probe spent in the batched MW solve (benchmark span)."""

from portbench import readers


def read(run):
    return readers.per_unit(run, "flow.solve", span=True)
