"""Batched congestion launches a simulated step (kernels.launch_counts)."""

from portbench import readers


def read(run):
    return readers.per_unit(run, "loads_launches", per="steps")
