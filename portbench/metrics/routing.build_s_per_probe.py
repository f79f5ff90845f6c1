"""Seconds a probe spent in the batched path-system build (benchmark span)."""

from portbench import readers


def read(run):
    return readers.per_unit(run, "routing.build", span=True)
