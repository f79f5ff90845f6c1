"""Host seconds an event boundary took to reroute: the program's span
``sim/reroute`` (events applied to the batch, delta routing, the carry's
migration) over the window's event boundaries."""

from portbench import progtrace


def read(run):
    return progtrace.per_unit(run, "sim/reroute", "host_s", per="boundaries")
