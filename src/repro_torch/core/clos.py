"""Two-level folded-Clos (leaf–spine) networks, the substrate for the
LEGUP-style expansion baseline (paper §4.2, Fig 6).

A leaf–spine Clos has L leaf (ToR) switches, each with ``servers`` server
ports and ``uplinks`` network ports, and S spine switches with ``sp_ports``
ports each.  Leaf uplinks are spread as evenly as possible across spines
(multi-links between a leaf and a spine are physical reality in Clos fabrics;
our Topology is a simple graph, so we cap at one link per (leaf, spine) pair
and spill the remainder — with L >= uplinks this never triggers in the
configurations used here).

Port copy of ``repro/core/clos.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology

__all__ = ["ClosSpec", "build_clos"]


@dataclasses.dataclass
class ClosSpec:
    n_leaves: int
    servers_per_leaf: int
    uplinks_per_leaf: int
    n_spines: int
    spine_ports: int
    leaf_ports: int | None = None  # default: servers + uplinks

    @property
    def ports(self) -> int:
        return self.leaf_ports or (self.servers_per_leaf + self.uplinks_per_leaf)

    @property
    def n_servers(self) -> int:
        return self.n_leaves * self.servers_per_leaf

    @property
    def n_switches(self) -> int:
        return self.n_leaves + self.n_spines

    def ideal_bisection(self) -> float:
        """Normalized bisection of the ideal (fractional) leaf-spine fabric."""
        total_uplinks = min(
            self.n_leaves * self.uplinks_per_leaf, self.n_spines * self.spine_ports
        )
        cut = total_uplinks / 2.0
        denom = self.n_servers / 2.0
        return min(cut / max(denom, 1e-9), 1.0)


def build_clos(spec: ClosSpec, name: str = "clos") -> Topology:
    """Materialize the leaf–spine fabric as a Topology (leaves first)."""
    L, S = spec.n_leaves, spec.n_spines
    n = L + S
    spine_free = np.full(S, spec.spine_ports, dtype=np.int64)
    edges: set[tuple[int, int]] = set()
    # balanced-random spreading: per leaf, pick the spines with most free
    # ports, random tiebreak.  Deterministic striping clusters consecutive
    # leaves onto consecutive spines and craters the bisection.
    rng = np.random.default_rng(L * 1000003 + S)
    for leaf in range(L):
        noise = rng.random(S)
        order = np.lexsort((noise, -spine_free))
        placed = 0
        for s in order:
            if placed >= spec.uplinks_per_leaf:
                break
            if spine_free[s] <= 0:
                continue
            edges.add((leaf, L + int(s)))
            spine_free[s] -= 1
            placed += 1
    ports = np.concatenate(
        [np.full(L, spec.ports), np.full(S, spec.spine_ports)]
    ).astype(np.int64)
    net_degree = np.concatenate(
        [np.full(L, spec.uplinks_per_leaf), np.full(S, spec.spine_ports)]
    ).astype(np.int64)
    top = Topology(
        n_switches=n,
        edges=np.asarray(sorted(edges), dtype=np.int64),
        ports=ports,
        net_degree=net_degree,
        name=name,
        meta={"kind": "clos", "spec": dataclasses.asdict(spec)},
    )
    top.validate()
    return top
