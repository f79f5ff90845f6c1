"""Seconds an expansion step spent in update_path_system (benchmark span)."""

from portbench import readers


def read(run):
    return readers.per_unit(run, "routing.delta", span=True, per="steps")
