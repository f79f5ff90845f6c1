"""Three-level k-ary fat-tree baseline (Al-Fares et al., SIGCOMM'08).

A k-ary fat-tree has k pods; each pod has k/2 edge switches and k/2
aggregation switches; there are (k/2)^2 core switches; every switch has k
ports.  Edge switches attach k/2 servers each, so the network supports k^3/4
servers at full bisection bandwidth, using 5k^2/4 switches.

Port copy of ``repro/core/fattree.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.

Switch numbering: for pod p in [0, k): edge switches come first
(p*k + 0 .. p*k + k/2-1), then aggregation (p*k + k/2 .. p*k + k-1); core
switches occupy the last (k/2)^2 ids.
"""

from __future__ import annotations

import numpy as np

from .topology import Topology

__all__ = ["fattree", "fattree_equipment"]


def fattree_equipment(k: int) -> dict:
    """Equipment budget of a k-ary fat-tree (used for equal-cost comparisons)."""
    return {
        "switches": 5 * k * k // 4,
        "ports_per_switch": k,
        "servers": k**3 // 4,
        "edge_switches": k * k // 2,
        "agg_switches": k * k // 2,
        "core_switches": k * k // 4,
        "cables": (k**3) // 2 + (k**3) // 4,  # edge-agg + agg-core switch links
    }


def fattree(k: int, name: str | None = None) -> Topology:
    if k % 2:
        raise ValueError("fat-tree requires even k")
    half = k // 2
    n_pod_sw = k * k  # k pods x k switches
    n_core = half * half
    n = n_pod_sw + n_core
    edges: list[tuple[int, int]] = []

    def edge_id(p: int, i: int) -> int:
        return p * k + i

    def agg_id(p: int, i: int) -> int:
        return p * k + half + i

    def core_id(i: int, j: int) -> int:
        # core switch (i, j): connects to aggregation switch j of every pod,
        # i indexes the core group within that aggregation switch's links.
        return n_pod_sw + j * half + i

    for p in range(k):
        for e in range(half):
            for a in range(half):
                edges.append((edge_id(p, e), agg_id(p, a)))
        for a in range(half):
            for c in range(half):
                edges.append((agg_id(p, a), core_id(c, a)))

    ports = np.full(n, k, dtype=np.int64)
    net_degree = np.full(n, k, dtype=np.int64)
    # Edge switches give half their ports to servers.
    for p in range(k):
        for e in range(half):
            net_degree[edge_id(p, e)] = half
    top = Topology(
        n_switches=n,
        edges=np.asarray(sorted(tuple(sorted(x)) for x in edges), dtype=np.int64),
        ports=ports,
        net_degree=net_degree,
        name=name or f"fattree(k={k})",
        meta={"kind": "fattree", "k": k, **fattree_equipment(k)},
    )
    top.validate()
    assert top.n_servers == k**3 // 4
    return top
