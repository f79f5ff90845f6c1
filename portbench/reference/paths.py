"""Plain k-shortest-path routing tables: the benchmark's reference.

Semantics (paper §5, the routing every cell of this benchmark uses): for a
switch pair ``(s, t)`` at hop distance ``d``, the routes are the first ``k``
simple paths in the order (length, node sequence read from the lower switch
id), among the simple paths of at most ``d + max_slack`` hops.  A pair with
fewer such paths keeps all of them; a pair with none is unrouted.  The path
of ``s -> t`` with ``s > t`` is the reverse of the path read from ``t``.

Hop ``u -> v`` of a path uses the directed capacity slot ``e`` when ``u < v``
and ``e + E`` otherwise, where ``e`` is the row of ``(min, max)`` in the
topology's sorted ``(E, 2)`` edge array; ``2E`` pads the slot table.

The enumeration is breadth-first over all pairs at once with numpy, pruning
a prefix when its hops plus the hop distance from its end to the target
exceed the budget.  It imports nothing of the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import shortest_path

__all__ = ["Routes", "hop_distances", "k_shortest_routes", "route_tables"]


def hop_distances(n: int, edges: np.ndarray) -> np.ndarray:
    """(n, n) hop distances (float64, inf where unreachable)."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    data = np.ones(2 * len(e))
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    adj = csr_matrix((data, (rows, cols)), shape=(n, n))
    return shortest_path(adj, method="D", unweighted=True, directed=False)


def _neighbours(n: int, edges: np.ndarray) -> np.ndarray:
    """(n, dmax) ascending neighbour ids, padded with ``n``."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    src = np.concatenate([e[:, 0], e[:, 1]])
    dst = np.concatenate([e[:, 1], e[:, 0]])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n)
    out = np.full((n, max(int(deg.max(initial=0)), 1)), n, dtype=np.int64)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    col = np.arange(len(src)) - start[src]
    out[src, col] = dst
    return out


def _enumerate(nbr, dist_pad, lo, hi, budget, k):
    """Paths of at most ``budget`` hops from ``lo[i]`` to ``hi[i]``, first
    ``k`` in (length, lexicographic) order; returns a list of lists."""
    q = len(lo)
    out: list[list[list[int]]] = [[] for _ in range(q)]
    done = np.zeros(q, dtype=np.int64)
    width = int(budget.max(initial=0)) + 1
    pid = np.arange(q)
    pref = np.full((q, width), -1, dtype=np.int64)
    pref[:, 0] = lo
    hops = 0
    while len(pid):
        node = pref[np.arange(len(pid)), hops]
        cand = nbr[node]  # (M, dmax)
        tgt = hi[pid]
        ok = (hops + 1 + dist_pad[cand, tgt[:, None]]) <= budget[pid][:, None]
        for c in range(hops + 1):  # simple paths only
            ok &= cand != pref[:, c][:, None]
        r, c = np.nonzero(ok)
        new_pid = pid[r]
        new_pref = pref[r].copy()
        new_pref[:, hops + 1] = cand[r, c]
        hops += 1
        fin = new_pref[:, hops] == tgt[r]
        if fin.any():
            fp, fr = new_pid[fin], new_pref[fin][:, : hops + 1]
            order = np.lexsort([fr[:, j] for j in range(hops, -1, -1)] + [fp])
            fp, fr = fp[order], fr[order]
            first = np.flatnonzero(np.r_[True, fp[1:] != fp[:-1]])
            rank = np.arange(len(fp)) - np.repeat(first, np.diff(np.r_[first, len(fp)]))
            keep = done[fp] + rank < k
            for i in np.flatnonzero(keep):
                out[fp[i]].append(fr[i].tolist())
            np.add.at(done, fp[keep], 1)
        go = ~fin & (done[new_pid] < k)
        pid, pref = new_pid[go], new_pref[go]
    return out


def k_shortest_routes(n, edges, src, dst, k, max_slack, dist=None):
    """Node paths for every (src[i], dst[i]) pair, by the module's rule."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if dist is None:
        dist = hop_distances(n, edges)
    nbr = _neighbours(n, edges)
    dist_pad = np.full((n + 1, n), np.inf)
    dist_pad[:n] = dist
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    keys, inv = np.unique(lo * n + hi, return_inverse=True)
    ulo, uhi = keys // n, keys % n
    base = dist[ulo, uhi]
    routes: list = [[] for _ in range(len(keys))]
    pending = np.flatnonzero(np.isfinite(base))
    for slack in range(max_slack + 1):
        if not len(pending):
            break
        found = _enumerate(nbr, dist_pad, ulo[pending], uhi[pending],
                           (base[pending] + slack).astype(np.int64), k)
        short = []
        for j, q in enumerate(pending):
            routes[q] = found[j]
            if len(found[j]) < k:
                short.append(q)
        pending = np.asarray(short, dtype=np.int64)
    out = []
    for i in range(len(src)):
        paths = routes[inv[i]]
        out.append([p[::-1] for p in paths] if src[i] > dst[i]
                   else [list(p) for p in paths])
    return out


@dataclasses.dataclass
class Routes:
    """A reference routing table, in the program's path-system layout."""

    path_edges: np.ndarray  # (P, L) directed slots, padded with 2E
    path_len: np.ndarray  # (P,) hops
    path_owner: np.ndarray  # (P,) index among routed commodities
    demands: np.ndarray  # (K,) demand of each routed commodity
    unrouted: np.ndarray  # (K0,) commodities with no path
    n_edges: int

    @property
    def n_slots(self) -> int:
        return 2 * self.n_edges

    @property
    def n_paths(self) -> int:
        return len(self.path_len)


def route_tables(n, edges, src, dst, demand, k, max_slack, dist=None) -> Routes:
    """The reference routing table of one traffic matrix."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    E = len(edges)
    paths = k_shortest_routes(n, edges, src, dst, k, max_slack, dist)
    unrouted = np.array([not p for p in paths], dtype=bool)
    flat = [p for ps in paths for p in ps]
    hops = np.array([len(p) - 1 for p in flat], dtype=np.int64)
    width = max(int(hops.max(initial=0)), 1)
    slot_of = {(int(u), int(v)): i for i, (u, v) in enumerate(edges)}
    pe = np.full((len(flat), width), 2 * E, dtype=np.int64)
    for r, p in enumerate(flat):
        for j in range(len(p) - 1):
            u, v = p[j], p[j + 1]
            pe[r, j] = slot_of[(u, v)] if u < v else slot_of[(v, u)] + E
    counts = np.array([len(p) for p in paths], dtype=np.int64)[~unrouted]
    owner = np.repeat(np.arange(len(counts)), counts)
    return Routes(pe, hops, owner,
                  np.asarray(demand, dtype=np.float64)[~unrouted], unrouted, E)
