"""Incremental expansion of Jellyfish topologies (paper §4.2).

To add a new switch ``u`` with ``r_u`` network ports: repeat ``r_u // 2``
times — pick a random existing link (v, w) such that u is adjacent to neither
endpoint, remove it, and add (u, v) and (u, w).  This consumes two of ``u``'s
ports per swap and leaves the rest of the graph a (slightly smaller) random
graph.  Heterogeneous port counts come for free.  Leftover free ports are
re-matched by ``rewire_free_ports``: candidate pairs are exhausted
deterministically, and a switch stuck with >= 2 free ports whose candidates
are all adjacent is incorporated by an edge-swap splice (remove a random
existing link, connect both of its ends to the stuck switch) — the paper's
full §4.2 rule.

The same procedure also implements *elastic shrink* (node removal): removing a
random switch from an RRG leaves a random graph with a few free ports, which
``rewire_free_ports`` re-matches (paper §4.3: "a random graph topology with a
few failures is just another random graph topology of slightly smaller size").

Delta contract
--------------
Every mutation producer in this module (and in ``core.failures``) stamps an
edge-level delta on the result's ``meta`` so consumers — most importantly
``core.routing.update_path_system`` — can repair cached routing state instead
of rebuilding it:

* ``meta["edges_added"]``   — list of (u, v) edges present in the result but
  not in the parent, in the *result's* switch-id space;
* ``meta["edges_removed"]`` — list of (u, v) parent edges that did not
  survive, in the *parent's* switch-id space;
* ``meta["node_remap"]``    — old-id -> new-id list (-1 = dropped), present
  only when the mutation renumbered switches (``remove_switch``); ``None``
  otherwise.  Remaps are always monotone on surviving ids;
* ``meta["delta_parent"]``  — ``topology.edge_fingerprint`` of the parent,
  letting consumers verify the delta relates exactly the two topologies at
  hand (meta dicts are copied across mutations, so unverified delta keys must
  be treated as stale).

Deltas always describe one producer call relative to its immediate input;
chain mutations step-by-step if intermediate deltas matter.

Frozen copy of the seeded construction code (numpy only), kept by the
benchmark as its yardstick: a program whose seeded builds drift from this
copy fails the benchmark's exact comparison.
"""

from __future__ import annotations

import numpy as np

from .topology import Topology, edge_delta, edge_fingerprint

__all__ = ["add_switch", "remove_switch", "rewire_free_ports", "expand_to"]


class _Mut:
    """Mutable adjacency view over a Topology for edge-swap sequences."""

    def __init__(self, top: Topology):
        self.top = top
        self.nbrs = top.adjacency_sets()
        self.edges = {tuple(e) for e in top.edges.tolist()}
        self.free = top.free_ports().astype(np.int64)

    def add(self, u: int, v: int) -> None:
        a, b = (u, v) if u < v else (v, u)
        # ValueError, not assert: the no-multi-edge/no-self-loop invariant
        # must survive ``python -O``
        if a == b:
            raise ValueError(f"self-loop ({u}, {v}) not allowed")
        if (a, b) in self.edges:
            raise ValueError(f"edge ({a}, {b}) already exists (no multi-edges)")
        self.edges.add((a, b))
        self.nbrs[u].add(v)
        self.nbrs[v].add(u)
        self.free[u] -= 1
        self.free[v] -= 1

    def remove(self, u: int, v: int) -> None:
        a, b = (u, v) if u < v else (v, u)
        if (a, b) not in self.edges:
            raise ValueError(f"cannot remove non-existent edge ({a}, {b})")
        self.edges.discard((a, b))
        self.nbrs[u].discard(v)
        self.nbrs[v].discard(u)
        self.free[u] += 1
        self.free[v] += 1

    def finish(self, name: str | None = None) -> Topology:
        t = self.top.with_edges(self.edges, name=name)
        t.validate()
        return t


def _record_delta(
    parent: Topology,
    child: Topology,
    node_remap: np.ndarray | None = None,
    kind: str = "expand",
) -> Topology:
    """Stamp the module's delta contract on ``child.meta`` (see docstring).

    Always overwrites all the delta keys — meta dicts propagate through
    ``Topology.copy``, so stale delta keys from an earlier mutation must
    never survive a new one.  ``kind`` names the producer
    (``meta["delta_kind"]``) for event-log attribution, mirroring
    ``core.failures``.
    """
    added, removed_mask, _ = edge_delta(parent, child, node_remap)
    child.meta["edges_added"] = [tuple(map(int, e)) for e in added]
    child.meta["edges_removed"] = [
        tuple(map(int, e)) for e in parent.edges[removed_mask]
    ]
    child.meta["node_remap"] = (
        [int(x) for x in node_remap] if node_remap is not None else None
    )
    child.meta["delta_parent"] = edge_fingerprint(parent)
    child.meta["delta_kind"] = kind
    return child


def _splice(mut: _Mut, u: int, rng: np.random.Generator) -> bool:
    """One edge swap: remove random (v, w) not touching u, add (u,v),(u,w)."""
    edge_arr = list(mut.edges)
    for j in rng.permutation(len(edge_arr)):
        v, w = edge_arr[j]
        if v == u or w == u or v in mut.nbrs[u] or w in mut.nbrs[u]:
            continue
        mut.remove(v, w)
        mut.add(u, v)
        mut.add(u, w)
        return True
    return False


def _rewire(mut: _Mut, rng: np.random.Generator) -> None:
    """Exhaustively re-match free ports on ``mut`` in place (paper §4.2).

    Each round either matches one non-adjacent free-port pair (candidate
    pairs are scanned exhaustively in a seeded random order — no stall
    counter, so the result is deterministic for a fixed seed) or, when every
    candidate pair is adjacent, splices a switch that retains >= 2 free ports
    into a random existing link.  Terminates when neither move exists; on any
    connected topology where a legal matching/splice sequence exists this
    leaves at most one free port globally.
    """
    while True:
        cand = np.flatnonzero(mut.free > 0)
        if int(mut.free[cand].sum()) <= 1:
            break
        moved = False
        if len(cand) >= 2:
            order = cand[rng.permutation(len(cand))]
            for ii in range(len(order)):
                u = int(order[ii])
                for jj in range(ii + 1, len(order)):
                    v = int(order[jj])
                    if v not in mut.nbrs[u]:
                        mut.add(u, v)
                        moved = True
                        break
                if moved:
                    break
        if not moved:
            # every free-port pair is adjacent (or only one switch has free
            # ports): fall back to the paper's edge-swap splice for switches
            # holding >= 2 free ports
            for u in cand[rng.permutation(len(cand))]:
                if mut.free[u] >= 2 and _splice(mut, int(u), rng):
                    moved = True
                    break
        if not moved:
            break  # no legal matching or splice exists


def rewire_free_ports(top: Topology, seed: int | np.random.Generator = 0) -> Topology:
    """Re-match free ports: exhaustive pairing plus edge-swap splice fallback.

    Implements the paper's §4.2 rule completely: free-port pairs on
    non-adjacent switches are matched until none remain (candidate pairs are
    exhausted deterministically — no random stall cutoff), and a switch left
    with >= 2 free ports that is adjacent to every other candidate is
    incorporated by removing a random existing link and connecting both of
    its ends.  For a fixed seed the result is deterministic, and at most one
    free port remains whenever a legal matching/splice sequence exists.
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    mut = _Mut(top)
    _rewire(mut, rng)
    return _record_delta(top, mut.finish(name=top.name), kind="rewire")


def add_switch(
    top: Topology,
    k_ports: int,
    r_net: int,
    seed: int | np.random.Generator = 0,
    name: str | None = None,
) -> Topology:
    """Add one switch (rack) with ``k_ports`` ports, ``r_net`` to the network."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    n = top.n_switches
    grown = Topology(
        n_switches=n + 1,
        edges=top.edges.copy(),
        ports=np.concatenate([top.ports, [k_ports]]),
        net_degree=np.concatenate([top.net_degree, [r_net]]),
        name=name or top.name,
        meta=dict(top.meta),
    )
    mut = _Mut(grown)
    u = n
    for _ in range(r_net // 2):
        if not _splice(mut, u, rng):
            break
    # Odd/unsatisfied leftover ports: re-match against any other free port.
    if mut.free[u] > 0:
        _rewire(mut, rng)
    out = mut.finish(name=name or top.name)
    return _record_delta(top, out, kind="add_switch")


def remove_switch(
    top: Topology, victim: int, seed: int | np.random.Generator = 0
) -> Topology:
    """Remove a switch entirely (failure / decommission) and re-match ports."""
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    keep = np.array([i for i in range(top.n_switches) if i != victim])
    remap = -np.ones(top.n_switches, dtype=np.int64)
    remap[keep] = np.arange(len(keep))
    edges = [
        (remap[u], remap[v])
        for u, v in top.edges
        if u != victim and v != victim
    ]
    shrunk = Topology(
        n_switches=top.n_switches - 1,
        edges=np.asarray(sorted(tuple(sorted(e)) for e in edges), dtype=np.int64)
        if edges
        else np.zeros((0, 2), dtype=np.int64),
        ports=top.ports[keep],
        net_degree=top.net_degree[keep],
        name=top.name,
        meta=dict(top.meta),
    )
    mut = _Mut(shrunk)
    _rewire(mut, rng)
    return _record_delta(
        top, mut.finish(name=top.name), node_remap=remap, kind="remove_switch"
    )


def _modal_spec(top: Topology) -> tuple[int, int]:
    """Most common (ports, net_degree) pair across switches (ties: smallest)."""
    spec = np.stack([top.ports, top.net_degree], axis=1)
    uniq, counts = np.unique(spec, axis=0, return_counts=True)
    k, r = uniq[np.argmax(counts)]
    return int(k), int(r)


def expand_to(
    top: Topology,
    n_switches: int,
    k_ports: int | None = None,
    r_net: int | None = None,
    seed: int | np.random.Generator = 0,
) -> Topology:
    """Grow ``top`` to ``n_switches`` by repeated single-switch additions.

    ``k_ports`` / ``r_net`` default to the topology's *modal* switch spec
    (the most common (ports, net_degree) pair) — on heterogeneous bases
    (e.g. LEGUP staged expansions) cloning the typical switch, not whatever
    switch happens to be stored last.  The final topology's delta meta is
    relative to the input ``top`` (ids are append-stable across the chain).
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    if k_ports is None or r_net is None:
        mk, mr = _modal_spec(top)
        k_ports = mk if k_ports is None else k_ports
        r_net = mr if r_net is None else r_net
    base = top
    while top.n_switches < n_switches:
        top = add_switch(top, k_ports, r_net, rng)
    if top is not base:
        _record_delta(base, top)
    return top
