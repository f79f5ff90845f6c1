"""Blocking device-to-host reads a simulated step: the program's counters
``sim/host_syncs`` / ``sim/steps``."""

from portbench import progtrace


def read(run):
    return progtrace.counter_ratio("sim/host_syncs", "sim/steps")
