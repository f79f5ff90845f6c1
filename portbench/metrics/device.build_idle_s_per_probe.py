"""Seconds a probe left the device idle while its batched build ran: the
window's idle time inside the program's span ``build/batch``."""

from portbench import progtrace


def read(run):
    return progtrace.per_unit(run, "build/batch", "idle_s", per="probes")
