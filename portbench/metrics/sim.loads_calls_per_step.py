"""Calls of the loads product a simulated step, whatever the congestion
backend: the program's counters ``sim/loads_calls`` / ``sim/steps``."""

from portbench import progtrace


def read(run):
    return progtrace.counter_ratio("sim/loads_calls", "sim/steps")
