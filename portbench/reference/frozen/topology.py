"""Topology: the central data structure of the Jellyfish reproduction.

A topology is a simple undirected graph over top-of-rack (ToR) switches, plus
per-switch port bookkeeping: switch ``i`` has ``ports[i]`` total ports, of which
``net_degree[i]`` may be used for switch-switch links and the remaining
``ports[i] - net_degree[i]`` attach servers.  In the paper's notation a
homogeneous topology is ``RRG(N, k, r)`` with ``ports = k`` and
``net_degree = r`` for every switch, supporting ``N * (k - r)`` servers.

Frozen copy of the seeded construction code (numpy only), kept by the
benchmark as its yardstick: a program whose seeded builds drift from this
copy fails the benchmark's exact comparison.

Edges are stored as a sorted numpy ``(E, 2)`` array (u < v).  All capacity /
path computations operate on dense adjacency matrices (paper-scale graphs are a
few thousand switches, which is MXU/BLAS territory), while construction and
expansion mutate a light adjacency-set view.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "Topology",
    "edges_to_adj",
    "adj_to_edges",
    "edge_fingerprint",
    "edge_delta",
]


def edges_to_adj(n: int, edges: np.ndarray, dtype=np.float32) -> np.ndarray:
    """Dense symmetric adjacency matrix from an (E, 2) edge array."""
    a = np.zeros((n, n), dtype=dtype)
    if len(edges):
        e = np.asarray(edges)
        a[e[:, 0], e[:, 1]] = 1
        a[e[:, 1], e[:, 0]] = 1
    return a


def adj_to_edges(adj: np.ndarray) -> np.ndarray:
    """Upper-triangular edge list (E, 2) from a dense adjacency matrix."""
    iu = np.triu_indices(adj.shape[0], k=1)
    mask = adj[iu] != 0
    return np.stack([iu[0][mask], iu[1][mask]], axis=1).astype(np.int64)


def edge_fingerprint(top: "Topology") -> str:
    """Stable hex digest of (n_switches, edge set) — the delta-contract key.

    Mutation producers (``core.expansion``, ``core.failures``) stamp
    ``meta["delta_parent"] = edge_fingerprint(parent)`` on their results so
    consumers (``core.routing.update_path_system``) can verify that a recorded
    ``node_remap`` really relates the two topologies at hand.
    """
    h = hashlib.sha1(f"{top.n_switches}:".encode())
    h.update(np.ascontiguousarray(top.edges).tobytes())
    return h.hexdigest()


def edge_delta(
    old: "Topology",
    new: "Topology",
    node_map: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Diff two edge sets under an (optional) old->new node renumbering.

    ``node_map`` maps old switch ids to new ids (-1 for dropped switches) and
    must be strictly increasing on surviving ids — the invariant every
    producer in this codebase preserves (renumbering only ever compacts ids),
    which keeps the u < v edge orientation stable across the map.  Identity
    when omitted.

    Returns ``(added, removed_mask, eid_map)``:

    * ``added``        — (A, 2) edges of ``new`` absent from mapped ``old``
                         (new-id space),
    * ``removed_mask`` — (E_old,) bool, True where an old edge did not survive
                         (including edges incident to dropped switches),
    * ``eid_map``      — (E_old,) int64, old edge id -> new edge id, -1 where
                         removed.
    """
    n_new = new.n_switches
    if node_map is None:
        nm = np.arange(old.n_switches, dtype=np.int64)
    else:
        nm = np.asarray(node_map, dtype=np.int64)
        if len(nm) != old.n_switches:
            raise ValueError("node_map length must equal old.n_switches")
        kept = nm[nm >= 0]
        if len(kept) > 1 and not np.all(np.diff(kept) > 0):
            raise ValueError("node_map must be strictly increasing on kept ids")
        if len(kept) and (kept.max() >= n_new):
            raise ValueError("node_map maps outside the new topology")
    E_old = old.n_edges
    eid_map = np.full(E_old, -1, dtype=np.int64)
    if E_old:
        me = nm[old.edges]  # (E_old, 2); -1 marks a dropped endpoint
        alive = (me >= 0).all(axis=1)
        old_keys = me[alive, 0] * n_new + me[alive, 1]
        new_keys = new.edges[:, 0] * n_new + new.edges[:, 1]  # sorted by invariant
        pos = np.searchsorted(new_keys, old_keys)
        pos_ok = pos < len(new_keys)
        found = pos_ok.copy()
        found[pos_ok] = new_keys[pos[pos_ok]] == old_keys[pos_ok]
        alive_ids = np.flatnonzero(alive)
        eid_map[alive_ids[found]] = pos[found]
        surviving_new = np.zeros(new.n_edges, dtype=bool)
        surviving_new[pos[found]] = True
    else:
        surviving_new = np.zeros(new.n_edges, dtype=bool)
    added = new.edges[~surviving_new]
    removed_mask = eid_map < 0
    return added, removed_mask, eid_map


@dataclasses.dataclass
class Topology:
    """Switch-level network topology with server attachment bookkeeping."""

    n_switches: int
    edges: np.ndarray  # (E, 2) int64, u < v, simple graph
    ports: np.ndarray  # (N,) total ports per switch
    net_degree: np.ndarray  # (N,) max ports usable for switch-switch links
    name: str = "topology"
    meta: dict = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------------ #
    # constructors / converters
    # ------------------------------------------------------------------ #
    @classmethod
    def regular(
        cls,
        n_switches: int,
        k_ports: int,
        r_net: int,
        edges: Iterable[Sequence[int]],
        name: str = "topology",
        **meta,
    ) -> "Topology":
        edges = np.asarray(sorted(tuple(sorted(e)) for e in edges), dtype=np.int64)
        if edges.size == 0:
            edges = np.zeros((0, 2), dtype=np.int64)
        return cls(
            n_switches=n_switches,
            edges=edges,
            ports=np.full(n_switches, k_ports, dtype=np.int64),
            net_degree=np.full(n_switches, r_net, dtype=np.int64),
            name=name,
            meta=dict(meta),
        )

    def copy(self) -> "Topology":
        return Topology(
            self.n_switches,
            self.edges.copy(),
            self.ports.copy(),
            self.net_degree.copy(),
            self.name,
            dict(self.meta),
        )

    # ------------------------------------------------------------------ #
    # views
    # ------------------------------------------------------------------ #
    @property
    def n_edges(self) -> int:
        return len(self.edges)

    @property
    def servers_per_switch(self) -> np.ndarray:
        return self.ports - self.net_degree

    @property
    def n_servers(self) -> int:
        return int(self.servers_per_switch.sum())

    def degrees(self) -> np.ndarray:
        d = np.zeros(self.n_switches, dtype=np.int64)
        if len(self.edges):
            np.add.at(d, self.edges[:, 0], 1)
            np.add.at(d, self.edges[:, 1], 1)
        return d

    def free_ports(self) -> np.ndarray:
        """Network ports not currently holding a link."""
        return self.net_degree - self.degrees()

    def adjacency(self, dtype=np.float32) -> np.ndarray:
        return edges_to_adj(self.n_switches, self.edges, dtype=dtype)

    def adjacency_sets(self) -> list[set[int]]:
        nbrs: list[set[int]] = [set() for _ in range(self.n_switches)]
        for u, v in self.edges:
            nbrs[u].add(int(v))
            nbrs[v].add(int(u))
        return nbrs

    def adjacency_lists(self) -> list[np.ndarray]:
        nbrs = self.adjacency_sets()
        return [np.array(sorted(s), dtype=np.int64) for s in nbrs]

    def edge_index(self) -> dict[tuple[int, int], int]:
        """Map (u, v) with u < v -> edge id."""
        return {(int(u), int(v)): i for i, (u, v) in enumerate(self.edges)}

    # ------------------------------------------------------------------ #
    # mutation helpers (used by construction / expansion)
    # ------------------------------------------------------------------ #
    def with_edges(self, edges: Iterable[Sequence[int]], name: str | None = None) -> "Topology":
        t = self.copy()
        e = np.asarray(sorted(tuple(sorted(x)) for x in edges), dtype=np.int64)
        if e.size == 0:
            e = np.zeros((0, 2), dtype=np.int64)
        t.edges = e
        if name:
            t.name = name
        return t

    # ------------------------------------------------------------------ #
    # validation
    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        e = self.edges
        if len(e):
            if not np.all(e[:, 0] < e[:, 1]):
                raise ValueError("edges must be stored as u < v")
            key = e[:, 0] * self.n_switches + e[:, 1]
            if len(np.unique(key)) != len(key):
                raise ValueError("duplicate edges (multigraph not allowed)")
            if e.min() < 0 or e.max() >= self.n_switches:
                raise ValueError("edge endpoint out of range")
        if np.any(self.degrees() > self.net_degree):
            raise ValueError("switch exceeds its network-port budget")
        if np.any(self.net_degree > self.ports):
            raise ValueError("net_degree exceeds total ports")

    def is_connected(self) -> bool:
        if self.n_switches <= 1:
            return True
        nbrs = self.adjacency_sets()
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for v in nbrs[u]:
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return len(seen) == self.n_switches

    def describe(self) -> str:
        d = self.degrees()
        return (
            f"{self.name}: N={self.n_switches} E={self.n_edges} "
            f"servers={self.n_servers} deg[min/mean/max]="
            f"{d.min() if len(d) else 0}/{d.mean():.2f}/{d.max() if len(d) else 0} "
            f"free_ports={int(self.free_ports().sum())}"
        )
