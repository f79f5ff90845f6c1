"""Seconds an expansion step spent in its warm MW solve (benchmark span)."""

from portbench import readers


def read(run):
    return readers.per_unit(run, "flow.warm_solve", span=True, per="steps")
