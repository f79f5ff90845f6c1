"""Seconds an expansion step spent growing the topology: the program's
span ``expansion/expand_to``, host seconds in the traced window."""

from portbench import progtrace


def read(run):
    return progtrace.per_unit(run, "expansion/expand_to", "host_s",
                              per="steps")
