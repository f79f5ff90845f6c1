"""Host seconds an event boundary spent migrating the live flow table: the
program's span ``sim/migrate`` over the window's event boundaries."""

from portbench import progtrace


def read(run):
    return progtrace.per_unit(run, "sim/migrate", "host_s", per="boundaries")
