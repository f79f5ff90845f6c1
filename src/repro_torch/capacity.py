"""Servers at full capacity (paper §4, Fig 1c) on the port.

Port-side copies of ``benchmarks/common.py``'s capacity helpers:
``spread_servers``, ``jellyfish_same_equipment``, ``alpha_of``,
``batch_alphas``, ``supports_full_capacity`` and
``max_servers_at_full_capacity``.  The question: how many servers does a
Jellyfish built from given switching equipment carry while every random
permutation of server traffic still routes at full rate (alpha >= 1)?

With the build pipeline on (``REPRO_BUILD_PIPELINE``, the default, as in
the reference) each probe builds its traffic matrices as ONE
``build_path_system_batch`` on ``device``; off, it builds them one after
another, lazily, so an LP rejection stops the builds.  Both give the same
path systems byte for byte (CT-build).  The probe verdicts LP-sized
matrices with the exact LP and solves the MW-sized ones in one
``mw_concurrent_flow_batch`` call on ``device``.  ``wave_levels > 1``
probes speculatively as in the reference: every candidate the next
``wave_levels`` bisection steps could ask about goes into one batched
solve, its build units streamed through ``core.buildpipe.stream_builds``
(the next unit builds on a worker thread, on a CUDA stream of its own,
while the consumer verdicts this one), and the server count equals the
sequential search's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import env, obs
from .core import (
    build_path_system,
    build_path_system_batch,
    jellyfish_heterogeneous,
    lp_concurrent_flow,
    max_feasible,
    mw_concurrent_flow,
    mw_concurrent_flow_batch,
    random_permutation_traffic,
    speculative_max_feasible,
)
from .core.buildpipe import pipeline_enabled, stream_builds
from .core.flow import LP_PATH_LIMIT

__all__ = [
    "MW_MIN_PATHS",
    "Probe",
    "alpha_of",
    "batch_alphas",
    "jellyfish_same_equipment",
    "max_servers_at_full_capacity",
    "probe_full_capacity",
    "spread_servers",
    "supports_full_capacity",
]

#: Exact LP at or below this many path variables, the MW solver beyond
#: (the reference's sweep cutoff; ``REPRO_LP_PATH_LIMIT`` steers it too).
MW_MIN_PATHS = (
    LP_PATH_LIMIT if env.is_set("REPRO_LP_PATH_LIMIT") else 30000
)


def _wants_mw(ps, method: str) -> bool:
    """The single LP-vs-MW dispatch predicate every driver shares."""
    return method == "mw" or (method == "auto" and ps.n_paths > MW_MIN_PATHS)


def alpha_of(top, seed=0, k=8, slack=3, method="auto", iters=500,
             mw_backend="auto", early_stop=False, target_alpha=None,
             device: "str | torch.device" = "cuda") -> float:
    """Max concurrent flow alpha for one random permutation matrix."""
    comm = random_permutation_traffic(top, seed=seed)
    ps = build_path_system(top, comm, k=k, max_slack=slack, device=device)
    if _wants_mw(ps, method):
        return mw_concurrent_flow(
            ps, iters=iters, backend=mw_backend, early_stop=early_stop,
            target_alpha=target_alpha, device=device,
        ).alpha
    return lp_concurrent_flow(ps).alpha


def batch_alphas(ps_list, method="auto", iters=500, mw_backend="auto",
                 early_stop=False, target_alpha=None,
                 device: "str | torch.device" = "cuda") -> list[float]:
    """Per-instance alpha for many path systems: the LP-vs-MW choice is per
    instance (as ``alpha_of``), and the MW instances share one batched
    solve."""
    out = [0.0] * len(ps_list)
    mw_ids = [i for i, ps in enumerate(ps_list) if _wants_mw(ps, method)]
    if mw_ids:
        res = mw_concurrent_flow_batch(
            [ps_list[i] for i in mw_ids], iters=iters, backend=mw_backend,
            early_stop=early_stop, target_alpha=target_alpha, device=device,
        )
        for i, r in zip(mw_ids, res):
            out[i] = r.alpha
    for i in range(len(ps_list)):
        if i not in mw_ids:
            out[i] = lp_concurrent_flow(ps_list[i]).alpha
    return out


def spread_servers(total: int, n_switches: int) -> np.ndarray:
    per = total // n_switches
    extra = total - per * n_switches
    servers = np.full(n_switches, per, dtype=np.int64)
    servers[:extra] += 1
    return servers


def jellyfish_same_equipment(n_switches: int, ports: int, n_servers: int, seed=0):
    """Jellyfish on identical switching equipment hosting n_servers."""
    return jellyfish_heterogeneous(
        np.full(n_switches, ports), spread_servers(n_servers, n_switches), seed=seed
    )


def _probe_systems(top, n_matrices, k, device):
    """One probe's path systems, traffic seeds 0..n_matrices-1, slack=3.

    With the build pipeline on, all of them build as ONE
    ``build_path_system_batch`` (one combined frontier pass instead of
    ``n_matrices``); off, they build lazily one after another, so an LP
    rejection stops the builds.  The systems are byte-identical either way
    (CT-build), so every verdict is too.
    """
    if pipeline_enabled():
        comms = [random_permutation_traffic(top, seed=s)
                 for s in range(n_matrices)]
        batch = build_path_system_batch([top] * n_matrices, comms, k=k,
                                        max_slack=3, device=device)
        return list(batch.systems)
    return (
        build_path_system(
            top, random_permutation_traffic(top, seed=s), k=k, max_slack=3,
            device=device,
        )
        for s in range(n_matrices)
    )


def _probe_verdict(systems, tol, method):
    """LP short-circuit + MW deferral over a probe's systems; returns
    ``(lp_ok, mw_systems)``."""
    mw_systems = []
    for ps in systems:
        if _wants_mw(ps, method):
            mw_systems.append(ps)
        elif lp_concurrent_flow(ps).alpha < 1.0 - tol:
            return False, mw_systems
    return True, mw_systems


class Probe(NamedTuple):
    """One probe's outcome: the verdict, the MW-sized path systems and
    their batched solve's results (empty when the LP rejected first)."""

    verdict: bool
    mw_systems: list
    mw_results: list


@obs.spanned("capacity/probe")
def probe_full_capacity(top, n_matrices=3, k=8, tol=1e-6, method="auto",
                        iters=500, mw_backend="auto",
                        device: "str | torch.device" = "cuda") -> Probe:
    """``supports_full_capacity`` with the solves it ran."""
    obs.annotate(servers=top.n_servers, matrices=n_matrices)
    lp_ok, mw_systems = _probe_verdict(
        _probe_systems(top, n_matrices, k, device), tol, method
    )
    if not lp_ok or not mw_systems:
        return Probe(lp_ok, mw_systems, [])
    res = mw_concurrent_flow_batch(mw_systems, iters=iters, target_alpha=1.0,
                                   backend=mw_backend, device=device)
    return Probe(all(r.alpha >= 1.0 - tol for r in res), mw_systems, res)


def supports_full_capacity(top, n_matrices=3, k=8, tol=1e-6,
                           method="auto", iters=500, mw_backend="auto",
                           device: "str | torch.device" = "cuda") -> bool:
    """Whether ``top`` routes ``n_matrices`` random permutations at
    alpha >= 1 - tol.  The MW solves stop as soon as they exhibit a
    feasible alpha-1 flow (``target_alpha=1.0``), and otherwise burn the
    full budget."""
    return probe_full_capacity(top, n_matrices, k, tol, method, iters,
                               mw_backend, device).verdict


def max_servers_at_full_capacity(
    n_switches: int, ports: int, lo: int, hi: int, seeds=(0,), k=8,
    wave_levels: int = 1, method: str = "auto", n_matrices: int = 3,
    tol: float = 1e-6, iters: int = 500, mw_backend: str = "auto",
    device: "str | torch.device" = "cuda",
) -> int:
    """Binary search (paper §4) for the largest server count the equipment
    supports at full capacity, validated across topology seeds.

    ``wave_levels > 1`` evaluates every candidate the next ``wave_levels``
    bisection steps could ask about in one wave, batching all of the wave's
    MW-sized (candidate x seed x matrix) solves into one
    ``mw_concurrent_flow_batch`` call; the per-candidate verdict is the same
    conjunction, so the server count equals the sequential search's.  As in
    the reference, that identity is exact when every solve takes the same
    backend; under ``auto`` a wave's larger stack can outgrow the dense
    budget and resolve ``gather`` where the sequential probes ran ``dense``
    (~1e-4 apart in alpha), so pass an explicit ``mw_backend`` where strict
    identity matters.
    """

    def ok(m: int) -> bool:
        for seed in seeds:
            top = jellyfish_same_equipment(n_switches, ports, m, seed=seed)
            if not supports_full_capacity(top, n_matrices=n_matrices, k=k,
                                          tol=tol, method=method, iters=iters,
                                          mw_backend=mw_backend,
                                          device=device):
                return False
        return True

    if wave_levels <= 1:
        return max_feasible(lo, hi, ok)

    def ok_batch(candidates):
        verdicts = [True] * len(candidates)
        mw_systems, owner = [], []
        # one build unit per (candidate, seed); with the pipeline on,
        # stream_builds builds unit i+1 on its worker while this thread
        # verdicts unit i.  Results arrive in submission order, so the
        # verdict fold below is the sequential loop.
        tasks = [(ci, m, seed) for ci, m in enumerate(candidates)
                 for seed in seeds]

        def build_thunk(m, seed):
            def thunk():
                top = jellyfish_same_equipment(n_switches, ports, m,
                                               seed=seed)
                return _probe_systems(top, n_matrices, k, device)
            return thunk

        stream = stream_builds(
            (build_thunk(m, seed) for _, m, seed in tasks), device=device)
        for (ci, m, seed), systems in zip(tasks, stream):
            if not verdicts[ci]:
                continue  # an earlier LP matrix rejected this candidate
            lp_ok, mws = _probe_verdict(systems, tol, method)
            mw_systems.extend(mws)
            owner.extend([ci] * len(mws))
            if not lp_ok:
                verdicts[ci] = False
        # LP-rejected candidates' MW systems are dead weight in the batch
        keep = [i for i, ci in enumerate(owner) if verdicts[ci]]
        mw_systems = [mw_systems[i] for i in keep]
        owner = [owner[i] for i in keep]
        if mw_systems:
            res = mw_concurrent_flow_batch(
                mw_systems, iters=iters, target_alpha=1.0,
                backend=mw_backend, device=device,
            )
            for ci, r in zip(owner, res):
                if r.alpha < 1.0 - tol:
                    verdicts[ci] = False
        return verdicts

    return speculative_max_feasible(lo, hi, ok_batch, levels=wave_levels)
