"""Elastic scaling: mesh re-planning when the device pool grows or shrinks.

The port's copy of ``repro/runtime/elastic.py`` (numpy only), unchanged.
Jellyfish's incremental expansion is the *fabric* half of elasticity; this
module is the *mesh* half: given a new device count, pick a
(pod, data, model) factorization that preserves the model-parallel degree
(TP size is dictated by the architecture, not the pool), rebalance the data
axis, and emit a reshard plan executed via checkpoint save/restore with the
new shardings (see ``checkpoint.manager.load_pytree``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["MeshPlan", "plan_mesh", "replan"]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    def describe(self) -> str:
        return "x".join(
            f"{n}={s}" for n, s in zip(self.axis_names, self.shape)
        )


def plan_mesh(
    n_devices: int,
    model_parallel: int = 16,
    devices_per_pod: int = 256,
) -> MeshPlan:
    """Factor the pool into (pod, data, model); drops stragglers that do not
    fill a data-parallel row (standard practice: round down, keep spares hot).
    """
    if n_devices < model_parallel:
        # degenerate small pools: shrink TP to the largest power of two <= n
        mp = 1 << (n_devices.bit_length() - 1)
        return MeshPlan((max(n_devices // mp, 1), mp), ("data", "model"))
    pods = max(n_devices // devices_per_pod, 1)
    per_pod = n_devices // pods
    data = per_pod // model_parallel
    if pods > 1:
        return MeshPlan((pods, data, model_parallel), ("pod", "data", "model"))
    return MeshPlan((data, model_parallel), ("data", "model"))


def replan(old: MeshPlan, new_n_devices: int) -> tuple[MeshPlan, dict]:
    """New plan + a reshard summary (which axes changed, batch rebalance)."""
    model = old.shape[old.axis_names.index("model")] if "model" in old.axis_names else 1
    per_pod = 256
    if "pod" in old.axis_names and "data" in old.axis_names:
        per_pod = (
            old.shape[old.axis_names.index("data")] * model
        )
    new = plan_mesh(new_n_devices, model, per_pod)
    report = {
        "old": old.describe(),
        "new": new.describe(),
        "model_parallel_preserved": ("model" not in new.axis_names)
        or new.shape[new.axis_names.index("model")] == model,
        "dropped_devices": new_n_devices - new.n_devices,
    }
    return new, report
