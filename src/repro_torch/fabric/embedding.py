"""Embedding logical collective patterns onto the physical fabric.

The port of ``repro/fabric/embedding.py``.  A multi-pod job runs ring
collectives over its mesh axes; ACROSS pods the traffic rides the
data-center fabric, exactly the object Jellyfish studies.  This module embeds
a logical ring over the participating pods into the physical topology:

1. order the pods along a short cyclic tour (nearest-neighbor on hop
   distances + 2-opt refinement: RRGs have no Hamiltonian structure to
   exploit, but their low diameter keeps stretch near 1);
2. route each ring hop on a near-shortest path, congestion-aware;
3. measure *stretch* (mean physical hops per logical hop) and *congestion*
   (max number of ring paths sharing a directed physical link).

Effective ring bandwidth = link_bw * min(1, capacity_share) where
capacity_share = 1 / congestion.  The same machinery scores all-to-all
(every pair routed) for MoE-style traffic.

Where it runs: the hop matrix is the routing cache's APSP on ``device``
(``routing._cached_dist``: on CUDA the int16 min-plus kernel
``minplus_hops``, on the CPU the host BFS), read as float32 through
``hops_to_f32`` before any arithmetic (hop counts are integers, so it equals
``apsp_hops`` exactly, and no int16 sum can wrap past the sentinel); the
candidate enumeration's admission prune runs on ``device`` as well.  The
tour, the greedy path choice and the usage counts are host code that keeps
the reference's order of random draws and of tie-breaking, so an embedding
is the same on every device and equals the reference's.

Host-boundary spans (``REPRO_TRACE``): ``fabric/ring/{hops,tour,enumerate,
route}`` and ``fabric/a2a/{hops,enumerate,usage}``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import obs
from ..core import routing
from ..core.metrics import hops_to_f32
from ..core.routing import k_shortest_paths
from ..core.topology import Topology
from ..device import resolve

__all__ = ["RingEmbedding", "embed_ring", "all_to_all_congestion"]


@dataclasses.dataclass
class RingEmbedding:
    order: np.ndarray  # (n,) cyclic order of participating nodes
    hop_paths: list[list[int]]  # physical node sequence per logical hop
    stretch: float  # mean physical hops per logical hop
    congestion: float  # max ring paths sharing one directed physical link
    efficiency: float  # 1 / (stretch-aware congestion): scales link bandwidth

    def summary(self) -> str:
        return (
            f"ring over {len(self.order)} nodes: stretch={self.stretch:.2f} "
            f"congestion={self.congestion:.0f} efficiency={self.efficiency:.2f}"
        )


def _hops(top: Topology, dev: torch.device) -> np.ndarray:
    """(N, N) float32 hop matrix (+inf unreachable) from the cached APSP."""
    entry = routing._topo_entry(top)
    return hops_to_f32(routing._cached_dist(top, entry, dev))


def _tour_length(order: np.ndarray, dist: np.ndarray) -> float:
    return float(sum(dist[order[i], order[(i + 1) % len(order)]] for i in range(len(order))))


def _two_opt(order: np.ndarray, dist: np.ndarray, iters: int | None = None, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    order = order.copy()
    n = len(order)
    if n < 4:
        return order
    if iters is None:
        iters = max(2000, 12 * n)  # budget must scale with tour length
    for _ in range(iters):
        i, j = sorted(rng.choice(n, 2, replace=False))
        if j - i < 1 or (i == 0 and j == n - 1):
            continue
        a, b = order[i - 1], order[i]
        c, d = order[j], order[(j + 1) % n]
        delta = (dist[a, c] + dist[b, d]) - (dist[a, b] + dist[c, d])
        if delta < 0:
            order[i : j + 1] = order[i : j + 1][::-1]
    return order


def _nearest_neighbor(sub: np.ndarray, start: int) -> list[int]:
    """Greedy tour over the members' (n, n) hop matrix from ``start``.

    The reference takes ``min`` over a Python set of the remaining indices;
    a set of small ints iterates in ascending order, so ties go to the
    smallest index.  ``np.argmin`` over the remaining indices in ascending
    order returns the first minimum: the same choice, +inf included."""
    n = sub.shape[0]
    left = np.ones(n, dtype=bool)
    left[start] = False
    seq = [start]
    for _ in range(n - 1):
        rest = np.flatnonzero(left)
        nxt = int(rest[np.argmin(sub[seq[-1], rest])])
        seq.append(nxt)
        left[nxt] = False
    return seq


def embed_ring(
    top: Topology,
    members: np.ndarray | list[int] | None = None,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> RingEmbedding:
    """Embed a logical ring over ``members`` (default: all switches); the
    hop matrix and the candidates' admission prune run on ``device``."""
    dev = resolve(device)
    members = np.asarray(members if members is not None else np.arange(top.n_switches))
    with obs.span("fabric/ring/hops", n=top.n_switches):
        dist = _hops(top, dev)
    with obs.span("fabric/ring/tour", members=len(members)):
        # nearest-neighbor construction, then 2-opt
        rng = np.random.default_rng(seed)
        start = int(rng.integers(len(members)))
        sub = dist[np.ix_(members, members)]
        seq = _nearest_neighbor(sub, start)
        order = members[_two_opt(np.asarray(seq), sub, seed=seed)]

    # route each hop CONGESTION-AWARE: among k candidate near-shortest paths
    # pick the one minimizing (current max-link reuse, path length).  A plain
    # shortest-path assignment leaves residual congestion 2 at ~1000 pods;
    # the random graph's path diversity is exactly what lets this greedy pass
    # restore congestion 1 (the paper's §4.1 diversity argument, applied to
    # collective scheduling).
    pairs = [
        (int(order[i]), int(order[(i + 1) % len(order)])) for i in range(len(order))
    ]
    with obs.span("fabric/ring/enumerate", pairs=len(pairs)):
        cand = k_shortest_paths(top, pairs, k=6, max_slack=2, dist=dist,
                                device=dev)
    with obs.span("fabric/ring/route", pairs=len(pairs)):
        usage: dict[tuple[int, int], int] = {}
        hops = 0
        hop_paths = []
        for plist in cand:
            if not plist:
                raise ValueError("fabric disconnected: cannot embed ring")

            def cost(p):
                links = list(zip(p[:-1], p[1:]))
                worst = max((usage.get(l, 0) for l in links), default=0)
                return (worst, len(p))

            p = min(plist, key=cost)
            hop_paths.append(p)
            hops += len(p) - 1
            for a, b in zip(p[:-1], p[1:]):
                usage[(a, b)] = usage.get((a, b), 0) + 1
    congestion = max(usage.values()) if usage else 1
    stretch = hops / max(len(order), 1)
    return RingEmbedding(
        order=order,
        hop_paths=hop_paths,
        stretch=stretch,
        congestion=float(congestion),
        efficiency=1.0 / max(congestion, 1),
    )


def all_to_all_congestion(
    top: Topology,
    members: np.ndarray | None = None,
    device: "str | torch.device" = "cuda",
) -> float:
    """Max directed-link multiplicity when all pairs route on shortest paths.

    Scores MoE/A2A-style inter-pod traffic on the fabric (normalized per
    pair; lower is better).  The hop matrix and the enumeration's admission
    prune run on ``device``."""
    dev = resolve(device)
    members = np.asarray(members if members is not None else np.arange(top.n_switches))
    with obs.span("fabric/a2a/hops", n=top.n_switches):
        dist = _hops(top, dev)
    pairs = [
        (int(a), int(b)) for a in members for b in members if a != b
    ]
    with obs.span("fabric/a2a/enumerate", pairs=len(pairs)):
        paths = k_shortest_paths(top, pairs, k=1, dist=dist, device=dev)
    with obs.span("fabric/a2a/usage", pairs=len(pairs)):
        usage: dict[tuple[int, int], float] = {}
        for plist in paths:
            if not plist:
                return float("inf")
            p = plist[0]
            for a, b in zip(p[:-1], p[1:]):
                usage[(a, b)] = usage.get((a, b), 0) + 1
    n_pairs = max(len(pairs), 1)
    return max(usage.values()) / n_pairs * len(members)
