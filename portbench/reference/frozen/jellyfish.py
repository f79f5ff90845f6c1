"""Jellyfish random-regular-graph construction (paper §3).

The paper's "sufficiently uniform" procedure: repeatedly pick a random pair of
switches with free ports (preferring pairs that are not already neighbors),
join them, and repeat until no further edge can be added.  If a switch is left
with >= 2 free ports, incorporate it by breaking a random existing link and
splicing the switch in.  At most one unmatched port may remain network-wide.

Frozen copy of the seeded construction code (numpy only), kept by the
benchmark as its yardstick: a program whose seeded builds drift from this
copy fails the benchmark's exact comparison.

Heterogeneous port counts are supported directly: the procedure only looks at
free ports, never at a global (k, r).
"""

from __future__ import annotations

import numpy as np

from .topology import Topology

__all__ = ["jellyfish", "rrg", "random_regular_edges"]


def random_regular_edges(
    n: int, degree: np.ndarray | int, rng: np.random.Generator
) -> list[tuple[int, int]]:
    """Build a (near-)regular random simple graph via the paper's procedure.

    ``degree`` may be a scalar (regular) or per-node array (heterogeneous).
    Returns an edge list; at most one port network-wide may remain unmatched
    (or more if the degree sequence is infeasible, e.g. d >= n).
    """
    deg = np.full(n, degree, dtype=np.int64) if np.isscalar(degree) else np.asarray(degree)
    free = deg.copy()
    nbrs: list[set[int]] = [set() for _ in range(n)]
    edges: set[tuple[int, int]] = set()

    def add_edge(u: int, v: int) -> None:
        a, b = (u, v) if u < v else (v, u)
        edges.add((a, b))
        nbrs[u].add(v)
        nbrs[v].add(u)
        free[u] -= 1
        free[v] -= 1

    def remove_edge(u: int, v: int) -> None:
        a, b = (u, v) if u < v else (v, u)
        edges.discard((a, b))
        nbrs[u].discard(v)
        nbrs[v].discard(u)
        free[u] += 1
        free[v] += 1

    # Phase 1: random greedy matching of free ports, avoiding parallel edges.
    # Rejection sampling over the candidate set, refreshed as ports fill up.
    stall = 0
    while True:
        cand = np.flatnonzero(free > 0)
        if len(cand) < 2:
            break
        # Are there any legal pairs left at all?
        # Quick probabilistic attempt first; exact check only when stalling.
        u, v = rng.choice(cand, size=2, replace=False)
        u, v = int(u), int(v)
        if v not in nbrs[u]:
            add_edge(u, v)
            stall = 0
            continue
        stall += 1
        if stall < 50:
            continue
        # Exact search for any legal pair among free-port nodes.
        found = False
        cand_list = cand.tolist()
        rng.shuffle(cand_list)
        for i, a in enumerate(cand_list):
            for b in cand_list[i + 1 :]:
                if b not in nbrs[a]:
                    add_edge(int(a), int(b))
                    found = True
                    break
            if found:
                break
        if not found:
            break  # no legal pair remains -> go to splice phase
        stall = 0

    # Phase 2: splice in nodes still holding >= 2 free ports (paper §3):
    # remove a random existing edge (x, y) with x, y not adjacent to u and
    # connect u-x, u-y.
    guard = 0
    while True:
        heavy = np.flatnonzero(free >= 2)
        if len(heavy) == 0 or not edges or guard > 10 * n + 100:
            break
        guard += 1
        u = int(rng.choice(heavy))
        edge_arr = list(edges)
        order = rng.permutation(len(edge_arr))
        for j in order:
            x, y = edge_arr[j]
            if x == u or y == u or x in nbrs[u] or y in nbrs[u]:
                continue
            remove_edge(x, y)
            add_edge(u, x)
            add_edge(u, y)
            break
        else:
            break  # no spliceable edge; give up (leaves free ports)

    # Phase 3: two ADJACENT nodes u, v each holding one free port cannot be
    # joined directly; fix with a 2-swap — remove (x, y) with x not adjacent
    # to u and y not adjacent to v, then add (u, x) and (v, y).
    guard = 0
    while guard < 10 * n + 100:
        guard += 1
        hot = np.flatnonzero(free > 0)
        if len(hot) < 2:
            break
        u, v = int(hot[0]), int(hot[1])
        if v not in nbrs[u]:
            add_edge(u, v)
            continue
        done = False
        edge_arr = list(edges)
        for j in rng.permutation(len(edge_arr)):
            x, y = edge_arr[j]
            if len({x, y} & {u, v}):
                continue
            for a, b in ((x, y), (y, x)):
                if a not in nbrs[u] and a != u and b not in nbrs[v] and b != v:
                    remove_edge(x, y)
                    add_edge(u, a)
                    add_edge(v, b)
                    done = True
                    break
            if done:
                break
        if not done:
            break  # genuinely stuck (tiny dense graphs); leave ports free

    return sorted(edges)


def jellyfish(
    n_switches: int,
    k_ports: int,
    r_net: int,
    seed: int | np.random.Generator = 0,
    name: str | None = None,
) -> Topology:
    """RRG(N, k, r): N switches, k ports each, r used for the interconnect."""
    if r_net > k_ports:
        raise ValueError("r (network degree) cannot exceed k (ports)")
    if r_net >= n_switches:
        raise ValueError("r must be < N for a simple graph")
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    edges = random_regular_edges(n_switches, r_net, rng)
    top = Topology.regular(
        n_switches,
        k_ports,
        r_net,
        edges,
        name=name or f"jellyfish(N={n_switches},k={k_ports},r={r_net})",
        kind="jellyfish",
        k=k_ports,
        r=r_net,
    )
    top.validate()
    return top


# Alias matching the paper's notation.
rrg = jellyfish


def jellyfish_heterogeneous(
    ports: np.ndarray | list[int],
    servers: np.ndarray | list[int],
    seed: int | np.random.Generator = 0,
    name: str | None = None,
) -> Topology:
    """Jellyfish over switches with per-switch port/server counts.

    This is the construction the paper's equal-equipment comparisons need:
    distributing S servers over N k-port switches leaves a non-uniform degree
    sequence (e.g. 54 servers on 45 6-port switches -> degrees {4, 5}), and
    wiring it as if it were min-degree regular strands ports.
    """
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    ports = np.asarray(ports, dtype=np.int64)
    servers = np.asarray(servers, dtype=np.int64)
    if (servers > ports).any():
        raise ValueError("more servers than ports on some switch")
    deg = ports - servers
    n = len(ports)
    edges = random_regular_edges(n, deg, rng)
    top = Topology(
        n_switches=n,
        edges=np.asarray(sorted(tuple(sorted(e)) for e in edges), dtype=np.int64)
        if edges
        else np.zeros((0, 2), dtype=np.int64),
        ports=ports,
        net_degree=deg,
        name=name or f"jellyfish-het(N={n})",
        meta={"kind": "jellyfish-heterogeneous"},
    )
    top.validate()
    return top
