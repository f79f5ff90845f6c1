"""Share of the flows live at an event boundary that re-selected a path,
in percent: the program's counters ``sim/migrate/reselected`` over
``survived + reselected + killed``, summed over the window's boundaries."""


def read(run):
    got = [run.layer.get(k) for k in ("survived", "reselected", "killed")]
    if any(v is None for v in got) or not sum(got):
        return None
    return 100.0 * got[1] / sum(got)
