"""Failure and repair models (paper §4.3): uniform link failures and the
repair that restores them.

``fail_links`` removes links uniformly at random (``rng.choice`` over the
edge rows, without replacement, one call); ``heal_links`` adds a list of
links back and keeps the edge array sorted.  Each stamps the edge-level
delta on the result's ``meta`` (``edges_added``, ``edges_removed``,
``node_remap`` None, ``delta_parent``, ``delta_kind``).

Frozen copy of the seeded construction code (numpy only), kept by the
benchmark as its yardstick: a program whose seeded failures drift from this
copy fails the benchmark's exact comparison.
"""

from __future__ import annotations

import numpy as np

from .topology import Topology, edge_fingerprint

__all__ = ["fail_links", "heal_links"]


def _record_delta(parent: Topology, child: Topology, removed: np.ndarray,
                  added: np.ndarray | None = None,
                  kind: str = "fail_links") -> Topology:
    child.meta["edges_added"] = (
        [] if added is None else [tuple(map(int, e)) for e in added])
    child.meta["edges_removed"] = [tuple(map(int, e)) for e in removed]
    child.meta["node_remap"] = None
    child.meta["delta_parent"] = edge_fingerprint(parent)
    child.meta["delta_kind"] = kind
    return child


def fail_links(top: Topology, fraction: float = 0.0,
               seed: int | np.random.Generator = 0,
               n_links: int | None = None) -> Topology:
    """Remove ``fraction`` of the links (``round(fraction * E)``), or
    exactly ``n_links``, uniformly at random."""
    rng = (seed if isinstance(seed, np.random.Generator)
           else np.random.default_rng(seed))
    e = top.n_edges
    if n_links is None:
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fail_links: fraction must be in [0, 1]; "
                             f"got {fraction}")
        n_fail = int(round(fraction * e))
    else:
        n_fail = int(n_links)
    if not 0 <= n_fail <= e:
        raise ValueError(f"fail_links: cannot fail {n_fail} of {e} links")
    if n_fail == 0:
        out = top.copy()
        return _record_delta(top, out, np.zeros((0, 2), dtype=np.int64))
    keep = np.ones(e, dtype=bool)
    keep[rng.choice(e, size=n_fail, replace=False)] = False
    out = top.copy()
    out.edges = top.edges[keep]
    out.name = (f"{top.name}+fail{fraction:.0%}" if n_links is None
                else f"{top.name}+fail{n_fail}")
    return _record_delta(top, out, top.edges[~keep])


def heal_links(top: Topology, edges) -> Topology:
    """Restore the links ``edges`` (pairs in ``top``'s ids, typically a
    failure's ``meta["edges_removed"]``): each absent, loop-free, unique
    and within both ends' ``net_degree``."""
    healed = np.asarray([tuple(sorted((int(u), int(v)))) for u, v in edges],
                        dtype=np.int64).reshape(-1, 2)
    if len(healed):
        if healed.min() < 0 or healed.max() >= top.n_switches:
            raise ValueError("heal_links: edge endpoint out of range")
        if np.any(healed[:, 0] == healed[:, 1]):
            raise ValueError("heal_links: self-loop")
        if len(np.unique(healed, axis=0)) != len(healed):
            raise ValueError("heal_links: duplicate edges in the heal set")
        have = {tuple(e) for e in top.edges.tolist()}
        if any((u, v) in have for u, v in healed.tolist()):
            raise ValueError("heal_links: edge already present")
        deg = top.degrees() + np.bincount(healed.reshape(-1),
                                          minlength=top.n_switches)
        if np.any(deg > top.net_degree):
            raise ValueError("heal_links: a switch exceeds its net_degree")
    out = top.with_edges(np.concatenate([top.edges, healed], axis=0),
                         name=f"{top.name}+heal{len(healed)}")
    out.validate()
    return _record_delta(top, out, np.zeros((0, 2), dtype=np.int64),
                         added=healed, kind="heal_links")
