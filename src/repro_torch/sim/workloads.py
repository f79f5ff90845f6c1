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
  never re-routes mid-flight);
* ``tenant_churn_segments`` / ``run_tenant_churn`` — tenant arrivals grow
  the fabric through ``core.expansion`` with path systems delta-routed by
  ``routing.update_path_system`` (the §4.2 machinery), tenant departures
  zero a random slice of demand; each event is one sim segment batched
  across topology seeds.
* ``poisson_failure_schedule`` — an MTBF-driven failure (and optional
  MTTR-driven repair) event schedule for ``sim.events.simulate_events``:
  link failures arrive as a Poisson process, each optionally healed an
  exponential repair time later.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.expansion import expand_to
from ..core.flow import PathSystemBatch
from ..core.routing import build_path_system, update_path_system
from ..core.topology import Topology
from ..core.traffic import (
    extend_server_permutation,
    permutation_commodities,
    random_server_permutation,
    union_commodities,
)
from .engine import SimConfig, SimResult, simulate
from .events import Event

__all__ = [
    "Workload",
    "steady_poisson",
    "diurnal_wave",
    "elephant_mice",
    "permutation_churn",
    "poisson_failure_schedule",
    "tenant_churn_segments",
    "run_tenant_churn",
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


def tenant_churn_segments(
    base_tops: Sequence[Topology],
    n_events: int,
    grow: int = 1,
    depart_frac: float = 0.25,
    k: int = 8,
    max_slack: int = 3,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
):
    """Tenant arrival/departure event chain riding the §4.2 delta machinery.

    Even events are tenant ARRIVALS: every instance grows by ``grow``
    switches (``core.expansion.expand_to``), its server permutation extends
    incrementally, and its path system is DELTA-routed with
    ``routing.update_path_system`` on ``device`` (exact parity with a
    rebuild).  Odd events are tenant DEPARTURES: a random ``depart_frac``
    of commodities' demand drops to zero — routing untouched, only the
    sampler weights move.

    Returns a list of segments ``{"systems": [ps per instance],
    "demands": (B, K_i) weights}`` consumed by ``run_tenant_churn``.
    Flows do not persist across segments (tenant events are rare next to
    flow lifetimes; each segment reaches its own steady state).
    """
    rng = np.random.default_rng(seed)
    tops = [t.copy() for t in base_tops]
    perms = [random_server_permutation(t.n_servers, rng) for t in tops]
    comms = [permutation_commodities(t, p) for t, p in zip(tops, perms)]
    systems = [
        build_path_system(t, c, k=k, max_slack=max_slack, device=device)
        for t, c in zip(tops, comms)
    ]
    scale = [np.ones(ps.n_commodities) for ps in systems]
    segments = [{"systems": list(systems), "demands": list(scale)}]
    for ev in range(n_events):
        if ev % 2 == 0:  # tenant arrival: expansion + delta routing
            for i, top in enumerate(tops):
                tn = expand_to(top, top.n_switches + grow, seed=rng)
                perms[i] = extend_server_permutation(
                    perms[i], tn.n_servers, seed=rng
                )
                comms[i] = permutation_commodities(tn, perms[i])
                systems[i] = update_path_system(
                    systems[i], top, tn, comms[i], device=device
                )
                tops[i] = tn
                scale[i] = np.ones(systems[i].n_commodities)
        else:  # tenant departure: a slice of demand goes away
            for i, ps in enumerate(systems):
                mask = rng.random(ps.n_commodities) >= depart_frac
                scale[i] = scale[i] * mask
        segments.append(
            {"systems": list(systems), "demands": [s.copy() for s in scale]}
        )
    return segments


def poisson_failure_schedule(
    n_steps: int,
    mtbf_steps: float,
    mttr_steps: float | None = None,
    n_links: int = 1,
    start_step: int = 1,
    seed: int = 0,
) -> list[Event]:
    """MTBF-driven random failure process for ``simulate_events``.

    Link-failure events arrive as a Poisson process: the first failure
    lands at ``start_step`` and subsequent inter-arrival gaps are
    ``Exp(mtbf_steps)``, rounded up to whole steps.  Each failure removes
    ``n_links`` uniform-random links (a fresh producer seed per event,
    drawn from ``seed``).  When ``mttr_steps`` is set, each failure is
    paired with a ``heal_links`` event an ``Exp(mttr_steps)`` repair time
    later (dropped when the repair falls past the horizon), so the schedule
    models the paper's §4.3 fail/repair churn.  Deterministic for a fixed
    ``seed``; the returned list is stably sorted by step.
    """
    if mtbf_steps <= 0:
        raise ValueError(f"mtbf_steps must be > 0, got {mtbf_steps}")
    if mttr_steps is not None and mttr_steps <= 0:
        raise ValueError(f"mttr_steps must be > 0, got {mttr_steps}")
    rng = np.random.default_rng(seed)
    events: list[Event] = []
    t = float(start_step)
    i = 0
    while True:
        t += float(rng.exponential(mtbf_steps)) if i else 0.0
        step = int(np.ceil(t))
        if step >= n_steps:
            break
        tag = f"f{i}"
        events.append(
            Event(
                step=step,
                kind="fail_links",
                n_links=n_links,
                seed=int(rng.integers(2**31 - 1)),
                tag=tag,
            )
        )
        if mttr_steps is not None:
            heal = int(np.ceil(t + float(rng.exponential(mttr_steps))))
            heal = max(heal, step + 1)
            if heal < n_steps:
                events.append(
                    Event(step=heal, kind="heal_links", heal_of=tag)
                )
        i += 1
    order = np.argsort([e.step for e in events], kind="stable")
    return [events[j] for j in order]


def run_tenant_churn(
    segments,
    steps_per_segment: int,
    rate: float,
    policy: str = "ksp_lc",
    config: SimConfig | None = None,
    size: float = 24.0,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
    arrivals: Sequence | None = None,
) -> list[SimResult]:
    """Simulate each tenant-churn segment (instances batched per segment)
    on ``device``.  ``arrivals`` optionally holds one pre-drawn stream per
    segment (``simulate``'s ``arrivals``); without it segment ``si`` draws
    from ``seed + si``."""
    if arrivals is not None and len(arrivals) != len(segments):
        raise ValueError(
            f"{len(segments)} segments but {len(arrivals)} arrival streams"
        )
    out = []
    for si, seg in enumerate(segments):
        batch = PathSystemBatch.from_systems(seg["systems"])
        K = batch.demands.shape[1] - 1
        de = np.zeros((1, batch.n_batch, K), np.float32)
        for i, (ps, w) in enumerate(zip(seg["systems"], seg["demands"])):
            dem = np.asarray(ps.demands) * np.asarray(w)
            de[0, i, : len(dem)] = dem
        wl = Workload(
            rate=np.full(steps_per_segment, rate, np.float32),
            size_mice=size,
            size_elephant=size,
            demand_epochs=de,
            epoch_of_step=np.zeros(steps_per_segment, np.int32),
        )
        out.append(
            simulate(batch, wl, policy=policy, config=config, seed=seed + si,
                     device=device,
                     arrivals=None if arrivals is None else arrivals[si])
        )
    return out
