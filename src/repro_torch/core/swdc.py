"""Small-World Datacenter (SWDC, Shin et al. SOCC'11) baselines (paper Fig 3).

SWDC topologies are a regular lattice plus random "small-world" links.  The
paper compares degree-6 variants: ring (2 lattice + 4 random), 2D torus
(4 lattice + 2 random) and a 3D hex torus.  We reproduce ring and 2D torus
exactly as described; the 3D hex torus is approximated as stacked hexagonal
layers (3 in-layer honeycomb links + 2 inter-layer links = 5 lattice links,
plus 1 random link), which matches the degree budget and the lattice flavor
of the original (the SWDC paper's own construction details are terse).

Random links are added as a random matching over the remaining free ports,
avoiding parallel edges — the same primitive Jellyfish construction uses.

Port copy of ``repro/core/swdc.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.
"""

from __future__ import annotations

import numpy as np

from .jellyfish import random_regular_edges
from .topology import Topology

__all__ = ["swdc_ring", "swdc_torus2d", "swdc_hex3d"]


def _add_random_links(
    n: int,
    lattice_edges: set[tuple[int, int]],
    extra_degree: int,
    rng: np.random.Generator,
    lattice_dist: np.ndarray | None = None,
    alpha: float = 0.0,
) -> list[tuple[int, int]]:
    """Random matching adding ``extra_degree`` ports per node to the lattice.

    With ``lattice_dist``/``alpha``, endpoints are sampled Kleinberg-style
    with probability proportional to d(u, v)^-alpha — the defining property
    of small-world links (SWDC inherits it; alpha = lattice dimension).
    Uniform (alpha=0) would just be Jellyfish with a lattice glued on."""
    free = np.full(n, extra_degree, dtype=np.int64)
    nbrs: list[set[int]] = [set() for _ in range(n)]
    for u, v in lattice_edges:
        nbrs[u].add(v)
        nbrs[v].add(u)
    edges = set(lattice_edges)
    stall = 0
    while stall < 400:
        cand = np.flatnonzero(free > 0)
        if len(cand) < 2:
            break
        u = int(rng.choice(cand))
        others = cand[cand != u]
        if len(others) == 0:
            break
        if lattice_dist is not None and alpha > 0:
            d = np.maximum(lattice_dist[u, others], 1.0)
            w = d**-alpha
            v = int(rng.choice(others, p=w / w.sum()))
        else:
            v = int(rng.choice(others))
        if v not in nbrs[u]:
            edges.add((min(u, v), max(u, v)))
            nbrs[u].add(v)
            nbrs[v].add(u)
            free[u] -= 1
            free[v] -= 1
            stall = 0
        else:
            stall += 1
    return sorted(edges)


def _build(
    n: int,
    lattice: set[tuple[int, int]],
    k_ports: int,
    degree: int,
    extra: int,
    seed,
    name: str,
    lattice_dist: np.ndarray | None = None,
    alpha: float = 0.0,
) -> Topology:
    rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
    edges = _add_random_links(n, lattice, extra, rng, lattice_dist, alpha)
    top = Topology.regular(n, k_ports, degree, edges, name=name, kind="swdc")
    top.validate()
    return top


def swdc_ring(n: int, k_ports: int, seed=0, degree: int = 6) -> Topology:
    """Ring lattice (2 links) + (degree-2) Kleinberg links per node."""
    lattice = {(i, (i + 1) % n) if i < (i + 1) % n else ((i + 1) % n, i) for i in range(n)}
    idx = np.arange(n)
    dist = np.minimum(np.abs(idx[:, None] - idx[None, :]),
                      n - np.abs(idx[:, None] - idx[None, :])).astype(np.float64)
    return _build(n, lattice, k_ports, degree, degree - 2, seed,
                  f"swdc-ring(N={n})", lattice_dist=dist, alpha=1.0)


def swdc_torus2d(side: int, k_ports: int, seed=0, degree: int = 6) -> Topology:
    """2D torus lattice (4 links) + (degree-4) Kleinberg links per node."""
    n = side * side
    lattice: set[tuple[int, int]] = set()

    def nid(x, y):
        return (x % side) * side + (y % side)

    for x in range(side):
        for y in range(side):
            for dx, dy in ((1, 0), (0, 1)):
                a, b = nid(x, y), nid(x + dx, y + dy)
                lattice.add((min(a, b), max(a, b)))
    xs, ys = np.divmod(np.arange(n), side)
    ddx = np.abs(xs[:, None] - xs[None, :])
    ddy = np.abs(ys[:, None] - ys[None, :])
    dist = (np.minimum(ddx, side - ddx) + np.minimum(ddy, side - ddy)).astype(np.float64)
    return _build(
        n, lattice, k_ports, degree, degree - 4, seed,
        f"swdc-torus2d(N={n})", lattice_dist=dist, alpha=2.0,
    )


def swdc_hex3d(side: int, layers: int, k_ports: int, seed=0, degree: int = 6) -> Topology:
    """Stacked honeycomb (brick-wall) layers: 3 in-layer + 2 inter-layer
    lattice links + 1 random link = degree 6.  ``side`` must be even so the
    brick-wall parity tiles the torus."""
    if side % 2:
        raise ValueError("hex3d requires even side")
    per_layer = side * side
    n = per_layer * layers
    lattice: set[tuple[int, int]] = set()

    def nid(layer, x, y):
        return (layer % layers) * per_layer + (x % side) * side + (y % side)

    for l in range(layers):
        for x in range(side):
            for y in range(side):
                a = nid(l, x, y)
                # brick-wall honeycomb: horizontal ring (2 links/node) plus a
                # vertical link emitted on even parity (1 link/node total)
                nbs = [nid(l, x, y + 1)]
                if (x + y) % 2 == 0:
                    nbs.append(nid(l, x + 1, y))
                for b in nbs:
                    if a != b:
                        lattice.add((min(a, b), max(a, b)))
                # inter-layer links (up + down = 2/node when layers >= 3)
                if layers > 1:
                    b = nid(l + 1, x, y)
                    if a != b:
                        lattice.add((min(a, b), max(a, b)))
    extra = degree - (3 + (2 if layers >= 3 else 1))
    # hex lattice distance proxy: manhattan over (layer, x, y) on the torus
    ls, rem = np.divmod(np.arange(n), per_layer)
    xs, ys = np.divmod(rem, side)
    dl = np.abs(ls[:, None] - ls[None, :])
    dl = np.minimum(dl, layers - dl)
    dx = np.abs(xs[:, None] - xs[None, :])
    dx = np.minimum(dx, side - dx)
    dy = np.abs(ys[:, None] - ys[None, :])
    dy = np.minimum(dy, side - dy)
    dist = (dl + dx + dy).astype(np.float64)
    return _build(
        n, lattice, k_ports, degree, max(extra, 0), seed, f"swdc-hex3d(N={n})",
        lattice_dist=dist, alpha=3.0,
    )
