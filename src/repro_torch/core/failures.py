"""Failure and repair models (paper §4.3, Fig 7).

Uniform-random link failures, switch failures, and the inverse repair
producer ``heal_links``.  A failed Jellyfish is "just another random graph":
the degraded Topology is a first-class Topology and every metric/solver runs
on it unchanged.  ``repro.runtime.elastic`` uses the same machinery to
re-plan a training mesh after node loss.

Delta contract
--------------
Every producer stamps the edge-level delta on the result's ``meta`` (same
contract as ``core.expansion``): ``meta["edges_added"]`` /
``meta["edges_removed"]`` list the changed links (removals in the parent's
switch-id space), ``meta["node_remap"]`` is ``None`` (failures never
renumber — ``fail_switches`` keeps dead switches as isolated ids), and
``meta["delta_parent"]`` fingerprints the parent so consumers like
``core.routing.update_path_system`` can trust the recorded delta and repair
cached APSP/path state instead of rebuilding it.  ``meta["delta_kind"]``
names the producer (``"fail_links"`` / ``"fail_switches"`` /
``"heal_links"``) so event logs (``repro.sim.events``) can attribute deltas
without parsing topology names.

``heal_links`` is the exact inverse of ``fail_links``: feeding a fail
event's ``meta["edges_removed"]`` back through it restores the original
edge set, and the stamped delta (pure additions) certifies through
``update_path_system`` like any expansion delta.

Port copy of ``repro/core/failures.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.
"""

from __future__ import annotations

import numpy as np

from .topology import Topology, edge_fingerprint

__all__ = ["fail_links", "fail_switches", "heal_links"]


def _record_delta(
    parent: Topology,
    child: Topology,
    removed: np.ndarray,
    added: np.ndarray | None = None,
    kind: str = "fail_links",
) -> Topology:
    child.meta["edges_added"] = (
        [] if added is None else [tuple(map(int, e)) for e in added]
    )
    child.meta["edges_removed"] = [tuple(map(int, e)) for e in removed]
    child.meta["node_remap"] = None
    child.meta["delta_parent"] = edge_fingerprint(parent)
    child.meta["delta_kind"] = kind
    return child


def fail_links(
    top: Topology,
    fraction: float = 0.0,
    seed: int | np.random.Generator = 0,
    n_links: int | None = None,
) -> Topology:
    """Remove ``fraction`` of switch-switch links uniformly at random.

    ``n_links`` overrides the fraction with an exact count — the knob
    cumulative failure sweeps (fig7) use to hit exact global failure levels
    while feeding each increment through the delta-routing path.  Both forms
    are validated against the edges actually remaining: an oversized request
    is a ``ValueError`` naming the topology, never an opaque ``rng.choice``
    crash.
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    e = top.n_edges
    if n_links is None:
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(
                f"fail_links({top.name!r}): fraction must be in [0, 1]; "
                f"got {fraction}"
            )
        n_fail = int(round(fraction * e))
    else:
        n_fail = int(n_links)
    if not 0 <= n_fail <= e:
        raise ValueError(
            f"fail_links({top.name!r}): cannot fail {n_fail} links; "
            f"topology has {e} remaining"
        )
    if n_fail == 0:
        out = top.copy()
        return _record_delta(top, out, np.zeros((0, 2), dtype=np.int64))
    keep = np.ones(e, dtype=bool)
    keep[rng.choice(e, size=n_fail, replace=False)] = False
    out = top.copy()
    out.edges = top.edges[keep]
    out.name = f"{top.name}+fail{fraction:.0%}" if n_links is None else (
        f"{top.name}+fail{n_fail}"
    )
    return _record_delta(top, out, top.edges[~keep])


def fail_switches(
    top: Topology, fraction: float, seed: int | np.random.Generator = 0
) -> Topology:
    """Mark switches failed: drop all their links (servers on them go dark)."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    if not 0.0 <= fraction <= 1.0:
        raise ValueError(
            f"fail_switches({top.name!r}): fraction must be in [0, 1]; "
            f"got {fraction}"
        )
    n_fail = int(round(fraction * top.n_switches))
    if n_fail == 0:
        out = top.copy()
        return _record_delta(
            top, out, np.zeros((0, 2), dtype=np.int64), kind="fail_switches"
        )
    dead = set(rng.choice(top.n_switches, size=n_fail, replace=False).tolist())
    keep = np.array([(u not in dead and v not in dead) for u, v in top.edges], dtype=bool)
    out = top.copy()
    out.edges = top.edges[keep]
    # dead switches host no usable servers
    dead_arr = np.array(sorted(dead), dtype=np.int64)
    out.net_degree = out.net_degree.copy()
    out.ports = out.ports.copy()
    out.ports[dead_arr] = 0
    out.net_degree[dead_arr] = 0
    out.name = f"{top.name}+swfail{fraction:.0%}"
    out.meta = {**top.meta, "dead_switches": sorted(int(d) for d in dead)}
    return _record_delta(top, out, top.edges[~keep], kind="fail_switches")


def heal_links(top: Topology, edges) -> Topology:
    """Restore previously failed links (the repair half of fail/heal chains).

    ``edges`` is a sequence of (u, v) switch pairs in ``top``'s id space —
    typically a fail event's ``meta["edges_removed"]``.  Each pair must be
    in range, loop-free, absent from the current edge set, unique, and must
    fit both endpoints' ``net_degree`` budget; violations raise
    ``ValueError`` naming the offending pair.  The result carries a pure
    ``edges_added`` delta, so a fail -> heal chain certifies through
    ``update_path_system`` and lands back on the original edge set.
    """
    healed = np.asarray(
        [tuple(sorted((int(u), int(v)))) for u, v in edges], dtype=np.int64
    ).reshape(-1, 2)
    if len(healed):
        if healed.min() < 0 or healed.max() >= top.n_switches:
            raise ValueError(
                f"heal_links({top.name!r}): edge endpoints must be in "
                f"[0, {top.n_switches}); got {healed.min()}..{healed.max()}"
            )
        if np.any(healed[:, 0] == healed[:, 1]):
            bad = healed[healed[:, 0] == healed[:, 1]][0]
            raise ValueError(
                f"heal_links({top.name!r}): self-loop {tuple(bad)} not allowed"
            )
        uniq = np.unique(healed, axis=0)
        if len(uniq) != len(healed):
            raise ValueError(
                f"heal_links({top.name!r}): duplicate edges in the heal set"
            )
        have = {tuple(e) for e in top.edges.tolist()}
        for u, v in healed.tolist():
            if (u, v) in have:
                raise ValueError(
                    f"heal_links({top.name!r}): edge ({u}, {v}) already "
                    "present (no multi-edges)"
                )
        deg = top.degrees() + np.bincount(
            healed.reshape(-1), minlength=top.n_switches
        )
        over = np.flatnonzero(deg > top.net_degree)
        if len(over):
            w = int(over[0])
            raise ValueError(
                f"heal_links({top.name!r}): switch {w} would exceed its "
                f"net_degree budget ({deg[w]} > {top.net_degree[w]})"
            )
    out = top.with_edges(
        np.concatenate([top.edges, healed], axis=0),
        name=f"{top.name}+heal{len(healed)}",
    )
    out.validate()
    return _record_delta(
        top, out, np.zeros((0, 2), dtype=np.int64), added=healed,
        kind="heal_links",
    )
