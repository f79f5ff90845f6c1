"""Seconds an expansion step spent re-enumerating paths in its delta
routing: the program's span ``build/enum_delta``, host seconds in the
traced window."""

from portbench import progtrace


def read(run):
    return progtrace.per_unit(run, "build/enum_delta", "host_s", per="steps")
