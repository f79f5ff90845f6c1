"""Seconds a probe spent enumerating paths in its batched build: the
program's span ``build/enumerate``, host seconds in the traced window."""

from portbench import progtrace


def read(run):
    return progtrace.per_unit(run, "build/enumerate", "host_s", per="probes")
