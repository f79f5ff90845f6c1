"""Host seconds an event boundary spent in delta routing: the program's
span ``route/update``, every call of which in the event cell's window runs
inside ``sim/apply_event``, over the window's event boundaries (nothing
where the program has no ``sim/apply_event``)."""

from portbench import progtrace


def read(run):
    if progtrace.per_unit(run, "sim/apply_event", "host_s",
                          per="boundaries") is None:
        return None
    return progtrace.per_unit(run, "route/update", "host_s", per="boundaries")
