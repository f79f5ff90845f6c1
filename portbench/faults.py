"""Faults planted in the program's place, by name.

Each is a hook for ``harness.execute(..., hook=)``: it changes what one
run's driver calls, and nothing outside that driver.  The CPU tests plant
them at tiny size; ``readings.py`` plants them at a cell's own size on the
card, which is where the limits' upper readings come from.

* ``probe.half_iters``: every probe's MW solve gets half its iteration
  budget (a cut a later change could make for speed).
* ``expand.half_iters``: every warm solve gets half its iterations.
* ``expand.cold_start``: every warm solve starts cold (the warm start
  dropped).
* ``sim.tf32``: not a fault but the precision step below float32: the
  reference in the program's place in float32 with TF32 products, read to
  show that no number of the sim cell separates it (the cell's control is
  ``kinds/sim.py``'s broken guarantee).
"""

from __future__ import annotations

import types

__all__ = ["FAULTS", "install"]


def _probe_half_iters(driver) -> None:
    cap = driver.capacity
    proxy = types.SimpleNamespace(
        jellyfish_same_equipment=cap.jellyfish_same_equipment,
        build_path_system_batch=cap.build_path_system_batch,
        mw_concurrent_flow_batch=cap.mw_concurrent_flow_batch)
    plain = cap.probe_full_capacity

    def probe(*a, iters, **kw):
        return plain(*a, iters=iters // 2, **kw)

    proxy.probe_full_capacity = probe
    driver.capacity = proxy


def _warm_solve(change):
    def install(driver) -> None:
        plain = driver.p["mw"]

        def solve(ps, iters, warm=None, **kw):
            if warm is None:  # the base's cold solve stays as it is
                return plain(ps, iters=iters, **kw)
            return plain(ps, **change(iters, warm), **kw)

        driver.p["mw"] = solve
    return install


def _sim_tf32(driver) -> None:
    from portbench.kinds import sim

    sim.reference_in_place(driver, control=True)


FAULTS = {
    "probe.half_iters": _probe_half_iters,
    "expand.half_iters": _warm_solve(lambda it, w: {"iters": it // 2, "warm": w}),
    "expand.cold_start": _warm_solve(lambda it, w: {"iters": it}),
    "sim.tf32": _sim_tf32,
}


def install(name: str):
    """The hook that plants fault ``name``."""
    return FAULTS[name]
