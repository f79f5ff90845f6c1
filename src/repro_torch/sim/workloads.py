"""Scenario generators for the flow-level simulator (paper §4 + beyond).

The port of ``repro/sim/workloads.py`` (numpy, the same RNG call order).
A ``Workload`` is the time-domain half of a sim run: the per-step Poisson
arrival rate, the flow-size mixture, and (optionally) a sequence of demand
*epochs* the commodity sampler walks through.  Generators:

* ``steady_poisson``     — constant open-loop load, the Fig-9 workhorse;
* ``diurnal_wave``       — sinusoidal day/night load modulation;
* ``elephant_mice``      — heavy-tailed two-point size mixture;
* ``permutation_churn``  — the paper's random-permutation traffic re-drawn
  every epoch: each topology routes the UNION of its epochs' commodity
  sets once, and the epochs re-weight demands over that union (so the run
  never re-routes mid-flight).

The tenant-churn and failure-schedule generators wait for the live-event
module (``sim/events.py``) they feed.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.flow import PathSystemBatch
from ..core.routing import build_path_system
from ..core.topology import Topology
from ..core.traffic import random_server_permutation, union_commodities

__all__ = [
    "Workload",
    "steady_poisson",
    "diurnal_wave",
    "elephant_mice",
    "permutation_churn",
]


@dataclasses.dataclass
class Workload:
    """Time-domain inputs of one sim run.

    ``rate[t]`` is the Poisson mean of new flows per instance at step t;
    sizes draw from the two-point elephant/mice mixture (``p_elephant = 0``
    degenerates to fixed ``size_mice``).  ``demand_epochs`` (E, B, K) or
    (E, K), with ``epoch_of_step`` (T,), re-weights the commodity sampler
    over time; ``None`` samples from the path systems' own demands.
    """

    rate: np.ndarray  # (T,) f32
    p_elephant: float = 0.0
    size_mice: float = 24.0
    size_elephant: float = 480.0
    demand_epochs: np.ndarray | None = None
    epoch_of_step: np.ndarray | None = None

    @property
    def n_steps(self) -> int:
        return len(self.rate)


def steady_poisson(n_steps: int, rate: float, size: float = 24.0) -> Workload:
    """Constant open-loop Poisson arrivals of fixed-size flows."""
    return Workload(
        rate=np.full(n_steps, rate, np.float32),
        size_mice=size,
        size_elephant=size,
    )


def diurnal_wave(
    n_steps: int,
    base_rate: float,
    amplitude: float = 0.6,
    period: int | None = None,
    size: float = 24.0,
) -> Workload:
    """Sinusoidal load: ``rate_t = base * (1 + amplitude * sin(2 pi t / T))``."""
    if not 0.0 <= amplitude <= 1.0:
        raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
    period = period or n_steps
    t = np.arange(n_steps)
    rate = base_rate * (1.0 + amplitude * np.sin(2.0 * np.pi * t / period))
    return Workload(
        rate=rate.astype(np.float32), size_mice=size, size_elephant=size
    )


def elephant_mice(
    n_steps: int,
    rate: float,
    p_elephant: float = 0.04,
    size_mice: float = 12.0,
    size_elephant: float = 1200.0,
) -> Workload:
    """Two-point heavy-tail mix: rare elephants carry most of the bytes."""
    if not 0.0 <= p_elephant <= 1.0:
        raise ValueError(f"p_elephant must be in [0, 1], got {p_elephant}")
    return Workload(
        rate=np.full(n_steps, rate, np.float32),
        p_elephant=p_elephant,
        size_mice=size_mice,
        size_elephant=size_elephant,
    )


def permutation_churn(
    tops: Sequence[Topology],
    n_epochs: int,
    steps_per_epoch: int,
    rate: float,
    seed: int = 0,
    k: int = 8,
    max_slack: int = 3,
    size: float = 24.0,
    device: "str | torch.device" = "cuda",
) -> tuple[PathSystemBatch, Workload]:
    """Permutation traffic re-drawn every ``steps_per_epoch`` steps.

    Each topology (one batch instance per entry of ``tops``) draws
    ``n_epochs`` independent server permutations; the path system routes
    the union of their switch-pair commodities ONCE, and the workload's
    demand epochs move the sampler weight between the per-epoch subsets —
    commodity churn without mid-run re-routing.  ``device`` runs the
    builds' APSP and admission prune.
    """
    rng = np.random.default_rng(seed)
    systems, epochs_per_top = [], []
    for top in tops:
        n_srv = top.n_servers
        perms = [random_server_permutation(n_srv, rng) for _ in range(n_epochs)]
        union, per_epoch = union_commodities(top, perms)
        ps = build_path_system(top, union, k=k, max_slack=max_slack,
                               device=device)
        kept = ~np.asarray(ps.unrouted)
        epochs_per_top.append([e[kept] for e in per_epoch])
        systems.append(ps)
    batch = PathSystemBatch.from_systems(systems)
    K = batch.demands.shape[1] - 1
    de = np.zeros((n_epochs, batch.n_batch, K), np.float32)
    for i, eps in enumerate(epochs_per_top):
        for e, dem in enumerate(eps):
            de[e, i, : len(dem)] = dem
    wl = Workload(
        rate=np.full(n_epochs * steps_per_epoch, rate, np.float32),
        size_mice=size,
        size_elephant=size,
        demand_epochs=de,
        epoch_of_step=np.repeat(np.arange(n_epochs, dtype=np.int32),
                                steps_per_epoch),
    )
    return batch, wl
