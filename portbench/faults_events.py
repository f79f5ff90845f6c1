"""Faults planted in the event path's migration and step loop, by name.

Each is a hook for ``harness.execute(..., hook=)`` on a ``sim_events``
cell: it puts a changed migration or step loop in the program's place for
that run's driver (``kinds/sim_events.py``), and nothing outside it.  The
CPU tests plant them at tiny size; ``readings_events.py`` at the cell's
own size.

* ``events.age_reset``: every flow that survives a boundary has its age
  set to zero (its completion time then counts from the event).
* ``events.kill_unaccounted``: the remainders of killed flows are dropped
  from the blackholed total.
* ``events.lag_ignored``: a flow whose path died resumes at once, with no
  steps of blackholing.
* ``events.hold_unheeded``: the migration stores ``hold`` as it should,
  but the step loop lets a held flow flow.
"""

from __future__ import annotations

__all__ = ["FAULTS"]


def _age_reset(driver) -> None:
    import numpy as np
    import torch

    plain = driver.migrate

    def migrate(carry, *a, **kw):
        arg = driver.migrate_args(carry, *a, **kw).arguments
        new, rec = plain(carry, *a, **kw)
        row = carry["row"].cpu().numpy()
        age = new["age"].clone()
        for i, (ps, rm) in enumerate(zip(arg["old_systems"],
                                         arg["rm_tot"])):
            rm = np.asarray(rm)
            fwd = np.full(ps.n_paths, -1, np.int64)
            fwd[rm[rm >= 0]] = np.flatnonzero(rm >= 0)
            live = np.flatnonzero(row[i] < ps.n_paths)
            surv = live[fwd[row[i, live]] >= 0]
            age[i, torch.as_tensor(surv, device=age.device)] = 0.0
        return dict(new, age=age), rec

    driver.migrate = migrate


def _kill_unaccounted(driver) -> None:
    plain = driver.migrate

    def migrate(carry, *a, **kw):
        new, rec = plain(carry, *a, **kw)
        return dict(new, bh_sum=carry["bh_sum"].clone()), rec

    driver.migrate = migrate


def _lag_ignored(driver) -> None:
    plain = driver.migrate

    def migrate(carry, *a, **kw):
        arg = driver.migrate_args(carry, *a, **kw).arguments
        arg["lag"] = 0
        return plain(**arg)

    driver.migrate = migrate


def _hold_unheeded(driver) -> None:
    import torch

    plain = driver.run_steps

    def run_steps(c, *a):
        c["hold"] = torch.zeros_like(c["hold"])
        return plain(c, *a)

    driver.run_steps = run_steps


FAULTS = {
    "events.age_reset": _age_reset,
    "events.kill_unaccounted": _kill_unaccounted,
    "events.lag_ignored": _lag_ignored,
    "events.hold_unheeded": _hold_unheeded,
}
