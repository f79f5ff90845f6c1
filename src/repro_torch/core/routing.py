"""k-shortest-path routing (paper §5) — batched near-shortest-path engine.

The port of ``repro/core/routing.py``, cut to what ``build_path_system``
needs.  The enumerator is numpy host code carried over verbatim (same numpy
calls, same canonical tie order), so a seeded build gives byte-identical
path tables to the reference.  Two steps run on the build's ``device``:

* APSP (``_apsp``): on CUDA, ``auto`` resolves to the min-plus kernel
  driver ``kernels.ops.apsp_minplus_blocked`` (the int16 hop matrix stays
  on the card); on the CPU, to the reference's blocked / dense BLAS BFS.
  Every backend returns the identical canonical int16 hop matrix.
* the per-level admissibility prune (``_admission_mask``), when the
  admission backend is ``kernel``, or ``auto`` (the default) on a CUDA
  build (``REPRO_TORCH_ADMISSION_BACKEND`` / ``set_admission_backend``):
  the fused prune of ``kernels.admission``.
  ``numpy`` keeps it on the host.  Both give the same mask.

The paper routes on k=8 shortest paths per switch pair.  For unit-weight
graphs the engine precomputes the hop-distance matrix once, then expands
**all commodity frontiers together**, level-synchronously, with the
vectorized admissibility prune

    len(prefix) + 1 + dist(next, dst) <= dist(src, dst) + slack,

growing ``slack`` per commodity until at least k simple paths exist.
Because expansion is breadth-first, paths complete in non-decreasing length
order, and ties are broken canonically (lexicographic node sequence).

Directed-slot edge convention: undirected edge ``e`` (endpoints ``u < v``)
of a topology with ``E`` edges gives two directed capacity slots, ``e``
(``u -> v``) and ``e + E`` (``v -> u``); ``n_slots = 2E`` doubles as the
padding sentinel in ``path_edges``.

Delta routing (``update_path_system``, with ``_repair_dist``,
``_dist_is_exact`` and ``_bfs_rows``) re-routes after an expansion or a
failure and gives exactly what a rebuild would; its APSP and its
re-enumeration run on the call's ``device`` like a build's.

``build_path_system_batch`` builds B instances as ONE cross-instance
enumeration over a block-diagonal composition (``_BlockDist``), with each
group's APSP on the call's ``device``; its systems equal B sequential
builds byte for byte (CT-build).  ``ecmp_path_system`` is the equal-cost
(``max_slack=0``) build of the paper's Table 1, and
``_k_shortest_paths_dfs`` the historical per-pair DFS kept as a baseline.
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict

import numpy as np
import torch

from .. import env
from .. import obs
from ..analysis.contracts import (
    check_built_batch,
    check_path_system,
    checks_enabled,
)
from ..device import is_cuda, resolve
from .metrics import (
    INT16_INF,
    apsp_hops,
    apsp_hops_blocked,
    bollobas_diameter_bound,
    hops_to_f32,
    hops_to_int16,
    sparse_adjacency,
)
from .topology import Topology, edge_delta, edge_fingerprint
from .traffic import Commodities

__all__ = [
    "PathSystem",
    "k_shortest_paths",
    "build_path_system",
    "build_path_system_batch",
    "ecmp_path_system",
    "update_path_system",
    "clear_routing_cache",
    "set_apsp_backend",
    "set_admission_backend",
    "APSP_BACKENDS",
    "ADMISSION_BACKENDS",
]


# --------------------------------------------------------------------------- #
# per-topology cache
# --------------------------------------------------------------------------- #

_CACHE_MAX = 8
_topo_cache: "OrderedDict[tuple, dict]" = OrderedDict()


def _topo_key(top: Topology) -> tuple:
    digest = hashlib.sha1(np.ascontiguousarray(top.edges).tobytes()).digest()
    return (top.n_switches, top.n_edges, digest)


def _topo_entry(top: Topology, cache: bool = True) -> dict:
    """Cached derived arrays for a topology (keyed by edge-set fingerprint)."""
    if not cache:
        return {"top": top}
    key = _topo_key(top)
    entry = _topo_cache.get(key)
    if entry is None:
        entry = {"top": top}
        _topo_cache[key] = entry
        while len(_topo_cache) > _CACHE_MAX:
            _topo_cache.popitem(last=False)
    else:
        _topo_cache.move_to_end(key)
    return entry


def clear_routing_cache() -> None:
    """Drop all cached per-topology routing state (APSP, neighbor tables)."""
    _topo_cache.clear()


# --------------------------------------------------------------------------- #
# APSP backend dispatch
# --------------------------------------------------------------------------- #

# Owned by repro.env (the REPRO_APSP_BACKEND registry entry); re-exported
# here because routing is the module callers know to ask.
APSP_BACKENDS = env.APSP_BACKENDS

#: Below this size the one-shot dense BLAS BFS beats the blocked/sparse
#: machinery's per-block overhead; it is also the dense/sparse adjacency
#: crossover for the slack-budget row powers.
_BLOCKED_MIN_N = 1536

#: Float32 working-tile budget for the sharded enumerator (distance-row
#: tiles) and the slack-budget row-power chunks.
_FRONTIER_TILE_BYTES = env.read("REPRO_ROUTE_TILE_BYTES")

#: Full (diam+1, N, N) walk-count tables above this are replaced by batched
#: row powers over just the query pairs (same budgets, no N^3 table).
_WALK_TABLE_BYTES = 256 << 20

_apsp_backend = env.read("REPRO_APSP_BACKEND")


def set_apsp_backend(name: str) -> str:
    """Select the APSP backend; returns the previous setting.

    ``auto`` resolves to the min-plus kernel driver on a CUDA build device
    (``kernels.ops.apsp_minplus_blocked``), and on the CPU to the blocked
    sparse-BFS at N >= ``_BLOCKED_MIN_N`` and the one-shot dense BLAS BFS
    below that.  ``minplus`` / ``minplus_blocked`` on the CPU run the
    min-plus drivers through the plain torch product.  The
    ``REPRO_APSP_BACKEND`` environment variable sets the initial value.  Callers switching backends mid-process should also
    ``clear_routing_cache()`` — cached distance matrices are not invalidated.
    """
    global _apsp_backend
    if name not in APSP_BACKENDS:
        raise ValueError(f"unknown APSP backend {name!r}: expected {APSP_BACKENDS}")
    prev, _apsp_backend = _apsp_backend, name
    return prev


# Admissibility-prune backend for the enumerator's expansion rounds.  All
# backends compute the identical boolean mask (exact comparisons), so this
# is a platform/cost knob, never a results knob — see kernels.admission.
ADMISSION_BACKENDS = env.ADMISSION_BACKENDS

_admission_backend = env.read("REPRO_TORCH_ADMISSION_BACKEND")


def set_admission_backend(name: str) -> str:
    """Select the expansion-round admissibility-prune backend; returns the
    previous setting.

    ``numpy`` keeps the prune in the host enumerator's numpy broadcast;
    ``kernel`` routes it through ``kernels.admission`` on the build's device
    (the CUDA kernel on a GPU, its plain version on the CPU), which folds
    the membership test into a per-cell loop instead of the (rows, prefix,
    candidates) boolean temporary; ``auto`` (default) takes ``kernel`` when
    the build's device is CUDA and ``numpy`` otherwise, as the APSP ``auto``
    takes the min-plus kernel.  Path sets are identical in every mode.
    """
    global _admission_backend
    if name not in ADMISSION_BACKENDS:
        raise ValueError(
            f"unknown admission backend {name!r}: expected {ADMISSION_BACKENDS}"
        )
    prev, _admission_backend = _admission_backend, name
    return prev


def _admission_mask(
    dist_rows: np.ndarray,
    dst_row_b: np.ndarray,
    cand: np.ndarray,
    rem: np.ndarray,
    pref: np.ndarray | None,
    device: "str | torch.device",
) -> np.ndarray:
    """(M, C) admissibility (+ simplicity when ``pref`` given) mask.

    The hot allocation of an expansion level: the numpy form materializes an
    (M, W, C) boolean broadcast for the membership test, the kernel backend
    loops over the prefix per cell.  Exact comparisons -> identical masks.
    """
    if _admission_backend == "kernel" or (
        _admission_backend == "auto" and torch.device(device).type == "cuda"
    ):
        from ..kernels.admission import admission_prune

        return admission_prune(
            dist_rows, dst_row_b, cand, rem, pref=pref, device=device
        )
    ok = dist_rows[dst_row_b[:, None], cand] <= rem[:, None]
    if pref is not None:
        # simplicity: candidate must not already be on the prefix
        ok &= ~(pref[:, :, None] == cand[:, None, :]).any(axis=1)
    return ok


def _diameter_hint(top: Topology) -> int | None:
    """Diameter upper bound from (min degree, size) for the min-plus drivers.

    Uses the Bollobás–de la Vega RRG bound, which holds w.h.p. rather than
    certainly — the drivers therefore *certify* convergence (a single
    fixed-point check) instead of trusting the hint; the hint's job is only
    to replace the per-squaring host sync with one final one.
    """
    d = top.degrees()
    if len(d) == 0:
        return None
    r = int(d.min())
    if r < 3:
        return None
    bound = bollobas_diameter_bound(top.n_switches, r)
    if not np.isfinite(bound):
        return None
    return int(bound) + 2


def _apsp(
    adj: np.ndarray,
    diameter_hint: int | None = None,
    device: "str | torch.device" = "cuda",
) -> np.ndarray:
    """APSP dispatch returning the **canonical int16 hop matrix**.

    Every backend produces identical hop counts (``INT16_INF`` sentinel for
    unreachable pairs); they differ only in device and memory envelope —
    see ``set_apsp_backend``.
    """
    be = _apsp_backend
    n = adj.shape[0]
    if be == "auto":
        if is_cuda(device):
            be = "minplus_blocked"
        else:
            be = "blocked" if n >= _BLOCKED_MIN_N else "dense"
    if be == "dense":
        return hops_to_int16(apsp_hops(adj))
    if be == "blocked":
        return apsp_hops_blocked(adj)
    from ..kernels import ops

    if be == "minplus":
        d = ops.apsp_minplus(adj, diameter_hint=diameter_hint, device=device)
        return hops_to_int16(d.cpu().numpy())
    return ops.apsp_minplus_blocked(
        adj, diameter_hint=diameter_hint, device=device
    )


def _finite_dist_max(dist: np.ndarray) -> int:
    """Largest finite hop count in a canonical int16 / float hop matrix (-1
    when every pair is unreachable or the matrix is empty)."""
    if dist.dtype == np.int16:
        finite = dist[dist != INT16_INF]
        return int(finite.max()) if finite.size else -1
    finite = dist[np.isfinite(dist)]
    return int(finite.max()) if finite.size else -1


def _cached_adj(top: Topology, entry: dict) -> np.ndarray:
    if "adj" not in entry:
        entry["adj"] = top.adjacency()
    return entry["adj"]


def _slack_adj(top: Topology, entry: dict):
    """Adjacency operand for the slack-budget row powers: dense below the
    sparse crossover, CSR above it (one frontier step costs O(E * rows)
    instead of O(N^2 * rows))."""
    if top.n_switches < _BLOCKED_MIN_N:
        return _cached_adj(top, entry)
    if "adj_sp" not in entry:
        entry["adj_sp"] = sparse_adjacency(_cached_adj(top, entry))
    return entry["adj_sp"]


def _cached_dist(top: Topology, entry: dict, device: torch.device) -> np.ndarray:
    """The topology's int16 hop matrix, computed once on ``device``.  Every
    APSP backend gives the same matrix, so the cache ignores the device."""
    if "dist" not in entry:
        entry["dist"] = _apsp(
            _cached_adj(top, entry), diameter_hint=_diameter_hint(top),
            device=device,
        )
    return entry["dist"]


def _cached_nbr(top: Topology, entry: dict) -> np.ndarray:
    """Padded (N, d_max) neighbor table; missing entries hold N (sentinel)."""
    if "nbr" not in entry:
        n = top.n_switches
        e = top.edges
        if len(e):
            ends = np.concatenate([e, e[:, ::-1]])  # (2E, 2) directed
            order = np.argsort(ends[:, 0], kind="stable")
            u_s, v_s = ends[order, 0], ends[order, 1]
            deg = np.bincount(u_s, minlength=n)
            dmax = int(deg.max())
            nbr = np.full((n, max(dmax, 1)), n, dtype=np.int32)
            starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
            pos = np.arange(len(u_s)) - np.repeat(starts, deg)
            nbr[u_s, pos] = v_s
        else:
            nbr = np.full((n, 1), n, dtype=np.int32)
        entry["nbr"] = nbr
    return entry["nbr"]


def _cached_walk_counts(top: Topology, entry: dict, dist: np.ndarray) -> np.ndarray:
    """(L, N, N) clipped counts of s->t walks of length 1..L (L = diameter+1).

    ``A^d[s, t]`` with ``d = dist(s, t)`` exactly counts shortest simple
    paths, and every s->t walk of length ``d + 1`` is simple too (a repeated
    vertex would shortcut below the distance), so these powers exactly decide
    whether a pair has k paths within slack 0 or 1 — which is what lets the
    enumerator give every pair a (near-)minimal budget upfront.  Counts are
    clipped to dodge f32 overflow; only the comparison against k matters.
    """
    if "walk_counts" not in entry:
        lmax = max(_finite_dist_max(dist) + 1, 1)
        a = top.adjacency(dtype=np.float32)
        powers = np.empty((lmax, *a.shape), dtype=np.float32)
        w = a
        powers[0] = w
        for i in range(1, lmax):
            w = np.minimum(w @ a, np.float32(2 ** 20))
            powers[i] = w
        entry["walk_counts"] = powers
    return entry["walk_counts"]


def _cached_slot_lookup(top: Topology, entry: dict):
    """Sorted edge keys for vectorized (u, v) -> directed-slot conversion."""
    if "slot_keys" not in entry:
        n = top.n_switches
        e = top.edges
        keys = e[:, 0] * n + e[:, 1]  # u < v by Topology invariant
        # JF002: keys are unique, but only kind="stable" makes the order a
        # pure function of the inputs rather than of numpy's introsort.
        order = np.argsort(keys, kind="stable")
        entry["slot_keys"] = (keys[order], order.astype(np.int64))
    return entry["slot_keys"]


# --------------------------------------------------------------------------- #
# batched near-shortest-path enumeration
# --------------------------------------------------------------------------- #


def _rank_within_pair(pids: np.ndarray) -> np.ndarray:
    """Per-row 0-based rank among rows sharing the same pair id (stable)."""
    order = np.argsort(pids, kind="stable")
    spids = pids[order]
    starts = np.flatnonzero(np.r_[True, spids[1:] != spids[:-1]])
    run_start = np.repeat(starts, np.diff(np.r_[starts, len(spids)]))
    rank = np.empty(len(pids), dtype=np.int64)
    rank[order] = np.arange(len(pids)) - run_start
    return rank


def _collect_completed(
    out: list[list[list[int]]],
    done: np.ndarray,
    pids: np.ndarray,
    pref: np.ndarray,
    plen: np.ndarray,
    k: int,
) -> None:
    """Append completed prefix rows to their pair's result list, capped at k.

    The cap is applied vectorized (rank-within-pair) so the Python append loop
    only ever touches rows that are actually kept (<= k per pair).

    Rows completing in the same level (equal length — the only place ties can
    occur, since expansion is level-synchronous) are ordered by lexicographic
    node sequence before capping.  That makes the returned k-shortest *set* a
    function of (graph, pair, k) alone, independent of neighbor-table layout
    or slack budget — the canonical-tie property ``update_path_system``
    relies on to splice cached paths from a pre-mutation topology and still
    match a from-scratch rebuild exactly.  Lexicographic order specifically
    (rather than a sequence hash, which would decorrelate tie picks) because
    it is invariant under the monotone id compaction of ``remove_switch``:
    the same candidates keep the same relative order after renumbering, so
    splicing remains exact across node removals.  It also tracks the
    enumerator's natural frontier order (neighbor tables are id-sorted), so
    canonicalization leaves routing quality unchanged — unlike, e.g., a
    max-node-id-first order, which systematically steers every commodity away
    from high-id switches and measurably concentrates congestion.
    """
    if not len(pids):
        return
    w = int(plen.max())  # columns past the longest path are constant padding
    keys = [pref[:, c] for c in range(w - 1, -1, -1)] + [pids]
    order = np.lexsort(keys)
    pids_s, pref_s, plen_s = pids[order], pref[order], plen[order]
    # pids_s is sorted (lexsort primary key), so ranks come from run starts
    starts = np.flatnonzero(np.r_[True, pids_s[1:] != pids_s[:-1]])
    run_start = np.repeat(starts, np.diff(np.r_[starts, len(pids_s)]))
    rank = np.arange(len(pids_s)) - run_start
    idx = np.flatnonzero(done[pids_s] + rank < k)
    for i in idx:
        out[pids_s[i]].append(pref_s[i, : plen_s[i]].tolist())
    np.add.at(done, pids_s[idx], 1)


def _cap_per_pair(pids: np.ndarray, cap: int) -> np.ndarray:
    """Boolean mask keeping at most ``cap`` rows per pair id (first wins)."""
    return _rank_within_pair(pids) < cap


def _batched_round(
    nbr: np.ndarray,
    dist_rows: np.ndarray,  # (R, N+1) f32 tile: the dst rows this shard needs
    src: np.ndarray,
    dst: np.ndarray,
    dst_row: np.ndarray,  # (Q,) row of each pair's dst within dist_rows
    budget: np.ndarray,
    k: int,
    max_enum: int,
    check_simple: bool = True,
    device: "str | torch.device" = "cpu",
) -> list[list[list[int]]]:
    """All-pairs-at-once enumeration of simple paths with length <= budget.

    Level-synchronous frontier expansion: level L holds all admissible simple
    prefixes of L hops, across every pair, as flat arrays.  Paths therefore
    complete in non-decreasing length order and each pair stops contributing
    frontier rows once it has k completed paths.

    ``dist_rows`` is a sharded distance tile rather than the full matrix:
    row ``dst_row[i]`` holds hop distances *from pair i's destination*
    (distances are symmetric) over all N nodes plus a trailing +inf column
    that the padded neighbor sentinel (id N) gathers, so a shard only ever
    touches the rows its own destinations need.

    ``check_simple=False`` skips the explicit repeated-vertex prune.  It is
    exact whenever ``budget <= base + 1``: a prefix that repeats a vertex has
    a cycle of >= 2 hops, so any completion through it is >= dist(s, t) + 2
    long and the admissibility prune already rejects it.

    ``device`` is where the ``kernel`` admission backend runs the prune.
    """
    Q = len(src)
    out: list[list[list[int]]] = [[] for _ in range(Q)]
    done = np.zeros(Q, dtype=np.int64)

    lmax = int(np.max(budget)) + 1 if Q else 1
    # frontier state: row i is a simple prefix ending at node[i] for pair pid[i]
    pid = np.arange(Q, dtype=np.int64)
    node = src.astype(np.int32).copy()
    pref = np.full((Q, lmax), -1, dtype=np.int32)
    pref[:, 0] = node
    plen = np.ones(Q, dtype=np.int32)

    # degenerate pairs: src == dst complete immediately with the 1-node path
    at_dst = node == dst
    _collect_completed(out, done, pid[at_dst], pref[at_dst], plen[at_dst], k)
    live = ~at_dst
    pid, node, pref, plen = pid[live], node[live], pref[live], plen[live]

    while len(pid):
        cand = nbr[node]  # (M, d_max), padded with n (tile sentinel column)
        dst_b = dst[pid]
        # admissibility: hops so far = plen - 1; stepping to cand makes plen
        # hops; completing through cand needs plen + dist(cand, dst) <= budget.
        # distances are symmetric, so the shard tile stores dst rows and we
        # index [dst_row, cand] for row-contiguous reads; the sentinel
        # candidate gathers the tile's +inf column and prunes itself.
        rem = (budget[pid] - plen).astype(np.float32)
        ok = _admission_mask(
            dist_rows, dst_row[pid], cand, rem,
            pref if check_simple else None, device,
        )
        r, c = np.nonzero(ok)
        if r.size == 0:
            break
        new_pid = pid[r]
        new_node = cand[r, c]
        new_pref = pref[r]
        new_plen = plen[r] + 1
        new_pref[np.arange(len(r)), new_plen - 1] = new_node

        comp = new_node == dst_b[r]
        _collect_completed(
            out, done, new_pid[comp], new_pref[comp], new_plen[comp], k
        )
        # survivors: incomplete prefixes of pairs still short of k paths,
        # frontier-capped per pair to bound memory (mirrors the DFS max_enum)
        keep = ~comp & (done[new_pid] < k)
        pid, node = new_pid[keep], new_node[keep]
        pref, plen = new_pref[keep], new_plen[keep]
        # frontier cap can only bind when some pair COULD exceed it
        if max_enum > 0 and len(pid) > max_enum:
            cap = _cap_per_pair(pid, max_enum)
            if not cap.all():
                pid, node = pid[cap], node[cap]
                pref, plen = pref[cap], plen[cap]
    return out


def _adj_rows_f32(adj, rows: np.ndarray) -> np.ndarray:
    """Dense f32 gather of adjacency rows from a dense or CSR operand."""
    if hasattr(adj, "tocsr"):  # scipy sparse (array or matrix)
        return np.asarray(adj[rows].todense(), dtype=np.float32)
    return adj[rows].astype(np.float32)


def _subset_slack(
    adj,
    dist: np.ndarray,
    src: np.ndarray,
    dst: np.ndarray,
    k: int,
) -> np.ndarray:
    """Per-pair slack budgets from walk counts restricted to the query rows.

    Same decision rule as ``_cached_walk_counts`` (w_d >= k -> slack 0,
    w_d + w_{d+1} >= k -> 1, else 2) but computed as batched row powers
    ``R_{L+1} = R_L @ A`` over only the |pairs| source rows — O(q * N * diam)
    against a CSR adjacency instead of the O(diam * N^3) full-power table.
    Queries are processed in row chunks so the dense (chunk, N) power state
    respects the frontier tile budget; this is both the delta path's variant
    (small re-enumeration subsets) and the full-build path at sizes where the
    power table no longer fits.
    """
    q = len(src)
    slack = np.zeros(q, dtype=np.int64)
    if not q:
        return slack
    n = dist.shape[0]
    # two (chunk, N) f32 arrays live during a power step
    chunk = max(256, _FRONTIER_TILE_BYTES // max(8 * n, 1))
    for lo in range(0, q, chunk):
        sl = slice(lo, min(lo + chunk, q))
        slack[sl] = _subset_slack_block(adj, dist, src[sl], dst[sl], k)
    return slack


def _subset_slack_block(
    adj, dist: np.ndarray, src: np.ndarray, dst: np.ndarray, k: int
) -> np.ndarray:
    q = len(src)
    slack = np.zeros(q, dtype=np.int64)
    base = hops_to_f32(dist[src, dst])
    pos = np.isfinite(base) & (base >= 1)
    if not pos.any():
        return slack
    d = np.where(pos, base, 1).astype(np.int64)
    dmax = int(d[pos].max())
    w_d = np.zeros(q, dtype=np.float32)
    w_d1 = np.zeros(q, dtype=np.float32)
    r = _adj_rows_f32(adj, src)  # (q, N) length-1 walk counts per source
    for length in range(1, dmax + 2):
        hit_d = pos & (d == length)
        if hit_d.any():
            w_d[hit_d] = r[hit_d, dst[hit_d]]
        hit_d1 = pos & (d == length - 1)
        if hit_d1.any():
            w_d1[hit_d1] = r[hit_d1, dst[hit_d1]]
        if length <= dmax:
            r = np.minimum(np.asarray(r @ adj), np.float32(2 ** 20))
    slack[pos] = np.where(
        w_d[pos] >= k, 0, np.where(w_d[pos] + w_d1[pos] >= k, 1, 2)
    )
    return slack


def _shard_by_dst(
    sel: np.ndarray,
    dst: np.ndarray,
    rows_cap: int,
    pairs_cap: int,
    blocks: np.ndarray | None = None,
) -> list:
    """Split ``sel`` into dst-sorted shards of <= ``rows_cap`` distinct dsts
    AND <= ``pairs_cap`` pairs.

    Sorting by destination makes each shard's distance tile a compact gather
    of exactly the rows it touches, which is what bounds the enumerator's
    float working set to one tile instead of the full (N+1)^2 matrix.  The
    pair cap bounds the *frontier* working set the same way — per-level
    candidate/prefix temporaries scale with the number of pairs expanding
    together, and at 10k-switch scale an uncapped shard would hold every
    commodity at once.

    ``blocks`` (the cross-instance batch build's group bases) additionally
    splits at topology-block boundaries, so every shard's destinations live
    in ONE block and its tile can be block-compact (group width, not the
    composed width).  Since global ids sort block-contiguously this only
    inserts cut points, never reorders — per-pair results are shard-layout
    independent either way (CT-build).
    """
    if not len(sel):
        return []
    order = np.argsort(dst[sel], kind="stable")
    s = sel[order]
    d = dst[s]
    distinct = np.cumsum(np.r_[True, d[1:] != d[:-1]]) - 1
    row_grp = distinct // rows_cap
    pair_grp = np.arange(len(s)) // pairs_cap
    tail = (row_grp[1:] != row_grp[:-1]) | (pair_grp[1:] != pair_grp[:-1])
    if blocks is not None and len(blocks) > 1:
        blk = np.searchsorted(blocks, d, side="right")
        tail = tail | (blk[1:] != blk[:-1])
    change = np.r_[True, tail]
    bounds = np.flatnonzero(change)
    return [s[b:e] for b, e in zip(bounds, np.r_[bounds[1:], len(s)])]


def _dist_tile(dist: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """(len(rows), N+1) f32 gather of distance rows + the +inf sentinel col."""
    n = dist.shape[0]
    tile = np.empty((len(rows), n + 1), dtype=np.float32)
    tile[:, :n] = hops_to_f32(dist[rows])
    tile[:, n] = np.inf
    return tile


class _BlockDist:
    """Block-diagonal distance view over G disjoint topology groups.

    The cross-instance batch build places each distinct topology's node ids
    in its own contiguous block (group g occupies ``[bases[g], bases[g] +
    n_g)`` of the combined id space) and runs one dst-sharded enumeration
    over every group's pairs.  This view supplies what the enumerator needs
    — per-pair base hops over the composed id space, and per-shard
    expansion state — without ever materializing an (N_total)^2 matrix or
    an N_total-wide neighbor table.

    Shards are **block-local**: ``_shard_by_dst`` cuts at block boundaries,
    so every shard's pairs live in ONE group and ``shard_ctx`` hands
    ``_batched_round`` that group's own neighbor table, a group-width f32
    distance tile (exactly what ``_dist_tile`` would build for the
    standalone instance), and the pairs' LOCAL ids.  Each shard round is
    therefore literally the sequential build's computation — identical
    arrays in, identical canonical tie order out — which is why the
    composed build is bit-identical to B sequential builds (CT-build) with
    zero per-level translation cost, and why results arrive already in
    instance-local ids.
    """

    def __init__(self, dists: list, nbrs: list, bases: np.ndarray):
        self.dists = dists  # per-group canonical int16 (or float) matrices
        self.nbrs = nbrs  # per-group padded local neighbor tables
        self.bases = np.asarray(bases, dtype=np.int64)  # (G,) block offsets
        self.n = (
            int(self.bases[-1]) + int(dists[-1].shape[0]) if dists else 0
        )
        # shard tiles are group-wide, not composed-wide, so the row budget
        # follows the widest group
        self.n_tile = max((d.shape[0] for d in dists), default=0)

    def _group_of(self, ids: np.ndarray) -> np.ndarray:
        return np.searchsorted(self.bases, ids, side="right") - 1

    def pair_hops(self, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
        """f32 hop distances for global-id pairs (+inf across blocks)."""
        out = np.full(len(src), np.inf, dtype=np.float32)
        g = self._group_of(src)
        same = g == self._group_of(dst)
        for gi in np.unique(g[same]):
            m = same & (g == gi)
            b = int(self.bases[gi])
            out[m] = hops_to_f32(self.dists[gi][src[m] - b, dst[m] - b])
        return out

    def shard_ctx(
        self, rows: np.ndarray, src: np.ndarray, dst: np.ndarray
    ) -> tuple:
        """Block-local expansion state for one shard: ``(nbr, tile, src,
        dst)`` with every array in the shard's OWN group's local id space.

        ``rows``/``src``/``dst`` are global ids that must live in one group
        (``_shard_by_dst`` with ``blocks`` guarantees it).  The tile is the
        group-width gather ``_dist_tile`` would produce for the standalone
        instance — trailing +inf sentinel column included — and the group's
        padded neighbor table uses the matching local sentinel, so the
        receiving ``_batched_round`` is indistinguishable from a sequential
        per-instance call.
        """
        g = int(self._group_of(rows[:1])[0])
        b = int(self.bases[g])
        d = self.dists[g]
        n_g = d.shape[0]
        tile = np.empty((len(rows), n_g + 1), dtype=np.float32)
        tile[:, :n_g] = hops_to_f32(d[rows - b])
        tile[:, n_g] = np.inf
        return self.nbrs[g], tile, src - b, dst - b


def _k_shortest_unique(
    nbr: np.ndarray | None,
    dist: "np.ndarray | _BlockDist",
    src: np.ndarray,
    dst: np.ndarray,
    k: int,
    max_slack: int,
    max_enum: int,
    counts: np.ndarray | None = None,
    slack_init: np.ndarray | None = None,
    device: "str | torch.device" = "cpu",
) -> list[list[list[int]]]:
    """k shortest paths for unique pairs with per-pair slack budgets.

    Because expansion is level-synchronous, paths complete in non-decreasing
    length order (ties broken canonically in ``_collect_completed``), so any
    budget >= the minimal slack yields the same k-shortest set (per-pair early
    stop at k).  The budget is therefore purely a cost knob: walk counts
    decide exactly which pairs have k paths within slack 0 or 1 (the vast
    majority on low-diameter random graphs), those are enumerated once at
    that budget, and only the rare stragglers iterate.  ``slack_init``
    (from ``_subset_slack``) supplies the same per-pair budgets without the
    O(diam * N^3) walk-count table — the delta path's variant and the
    at-scale default.

    Pairs are processed in **dst-sharded row blocks** (``_shard_by_dst``):
    each shard gathers only its destinations' distance rows into an f32 tile
    bounded by ``_FRONTIER_TILE_BYTES``, so ``dist`` can stay in the 2-byte
    canonical form and no (N+1)^2 float copy ever exists.  Shards partition
    the pair set, and per-pair results are independent of sharding, so the
    returned path sets are identical to the unsharded enumeration.

    ``dist`` may also be a ``_BlockDist`` view — the cross-instance batch
    build's block-diagonal composition (``nbr`` is then unused; each
    shard gets its group's own table from ``shard_ctx``).  Global dst ids
    sort group-contiguously, so the same dst-sharding doubles as
    (instance-group, pair) sharding — with cuts at block boundaries so
    every shard is block-local — and both caps keep their
    ``REPRO_ROUTE_TILE_BYTES`` derivation with ``n`` the widest group's
    node count (the actual tile width), not the composed total.

    ``device`` is where the ``kernel`` admission backend runs the prune.
    """
    Q = len(src)
    results: list[list[list[int]]] = [[] for _ in range(Q)]
    if isinstance(dist, _BlockDist):
        base = dist.pair_hops(src, dst)
        n = dist.n_tile  # tiles (and their row budget) are group-wide
        ctx_of = dist.shard_ctx
        blocks = dist.bases
    else:
        base = hops_to_f32(dist[src, dst])
        n = dist.shape[0]
        blocks = None

        def ctx_of(rows: np.ndarray, s: np.ndarray, d: np.ndarray) -> tuple:
            return nbr, _dist_tile(dist, rows), s, d

    active = np.flatnonzero(np.isfinite(base))
    if len(active) == 0:
        return results
    rows_cap = max(1, _FRONTIER_TILE_BYTES // (4 * (n + 1)))
    # frontier temporaries measure ~65 KiB per expanding pair on the paper's
    # degree-36 graphs (diameter 4); budget each shard against that rate so
    # the knob really caps the frontier working set, not just the tile
    pairs_cap = max(256, _FRONTIER_TILE_BYTES // (64 << 10))

    if slack_init is not None:
        slack = np.minimum(slack_init, max_slack)
    else:
        slack = np.zeros(Q, dtype=np.int64)
    if counts is not None and max_slack >= 1 and len(counts):
        d = base[active].astype(np.int64)
        pos = d >= 1  # src == dst pairs keep slack 0
        ai, di = active[pos], d[pos]
        w_d = counts[di - 1, src[ai], dst[ai]]
        w_d1 = counts[np.minimum(di, len(counts) - 1), src[ai], dst[ai]]
        w_d1 = np.where(di < len(counts), w_d1, 0.0)
        slack[ai] = np.where(w_d >= k, 0, np.where(w_d + w_d1 >= k, 1, 2))
        slack = np.minimum(slack, max_slack)

    while len(active):
        still = []
        # bucket by slack: <= 1 runs without the repeated-vertex prune (the
        # admissibility prune is already exact there), >= 2 runs with it.
        # Small batches (the update_path_system re-enumeration subsets) run
        # as one bucket with the prune on — always exact, and one round's
        # fixed per-level numpy overhead instead of two's.
        if len(active) <= 64:
            buckets = [(False, active)]
        else:
            lo = slack[active] <= 1
            buckets = [(True, active[lo]), (False, active[~lo])]
        for lo_slack, sel in buckets:
            for sh in _shard_by_dst(sel, dst, rows_cap, pairs_cap, blocks):
                obs.counter("build/shards").inc()
                with obs.span("build/shard", pairs=len(sh),
                              lo_slack=bool(lo_slack)):
                    rows = np.unique(dst[sh])  # sorted — searchsorted below
                    nbr_sh, tile, src_sh, dst_sh = ctx_of(
                        rows, src[sh], dst[sh]
                    )
                    dst_row = np.searchsorted(rows, dst[sh])
                    found = _batched_round(
                        nbr_sh, tile, src_sh, dst_sh, dst_row,
                        base[sh] + slack[sh], k, max_enum,
                        check_simple=not lo_slack, device=device,
                    )
                    for j, q in enumerate(sh):
                        results[q] = found[j]
                        if len(found[j]) < k and slack[q] < max_slack:
                            still.append(q)
        active = np.asarray(sorted(still), dtype=np.int64)
        slack[active] += 1
    return results


def _k_shortest_paths_dfs(
    top: Topology,
    pairs: list[tuple[int, int]],
    k: int = 8,
    max_slack: int = 4,
    max_enum: int = 4096,
    dist: np.ndarray | None = None,
) -> list[list[list[int]]]:
    """Historical per-pair Python DFS (reference / benchmark baseline only)."""
    if dist is None:
        dist = apsp_hops(top.adjacency())
    nbrs = top.adjacency_lists()

    def enumerate_one(s, t, length_cap):
        paths: list[list[int]] = []
        stack: list[tuple[int, float, list[int]]] = [(s, length_cap, [s])]
        while stack and len(paths) < max_enum:
            u, remaining, path = stack.pop()
            if u == t:
                paths.append(path)
                continue
            if remaining <= 0:
                continue
            in_path = set(path)
            for v in nbrs[u]:
                v = int(v)
                if v in in_path:
                    continue
                if 1 + dist[v, t] <= remaining:
                    stack.append((v, remaining - 1, path + [v]))
        return paths

    out: list[list[list[int]]] = []
    for s, t in pairs:
        base = dist[s, t]
        if not np.isfinite(base):
            out.append([])
            continue
        found: list[list[int]] = []
        for slack in range(max_slack + 1):
            found = enumerate_one(s, t, base + slack)
            if len(found) >= k:
                break
        found.sort(key=len)
        out.append(found[:k])
    return out


def k_shortest_paths(
    top: Topology,
    pairs: list[tuple[int, int]],
    k: int = 8,
    max_slack: int = 4,
    max_enum: int = 4096,
    dist: np.ndarray | None = None,
    cache: bool = True,
    use_counts: "bool | str" = True,
    device: "str | torch.device" = "cuda",
) -> list[list[list[int]]]:
    """k shortest simple paths (node sequences) for each (src, dst) pair.

    Pairs are deduplicated and canonicalized to unordered form (the graph is
    undirected, so the k shortest t->s paths are the reverses of the s->t
    ones); each unique pair is enumerated once by the batched engine.
    ``max_enum`` bounds the per-pair frontier width per expansion level.
    ``use_counts`` selects the slack-budget precompute: ``True`` builds (and
    caches) the full O(diam * N^3) walk-count table — right when sweeping
    many traffic matrices over one topology, and silently degraded to the
    ``"subset"`` row powers once the table would exceed ``_WALK_TABLE_BYTES``
    (the budgets, and hence the path sets, are identical); ``"subset"``
    computes budgets for just the query pairs via batched row powers — right
    for the small re-enumeration sets of ``update_path_system``; ``False``
    skips budgets and iterates every pair's slack from 0.  The returned path
    sets are identical in every mode (budgets are purely a cost knob).

    ``device`` runs the APSP (when ``dist`` is not given) and the ``kernel``
    admission prune; the enumeration itself is host numpy.

    ``dist`` may be a float hop matrix or the canonical int16 form; the
    enumerator gathers per-shard f32 distance tiles either way (see
    ``_k_shortest_unique``) and never materializes a padded float copy.
    """
    dev = resolve(device)
    if not len(pairs):
        return []
    arr = np.asarray(pairs, dtype=np.int64).reshape(len(pairs), 2)
    entry = _topo_entry(top, cache=cache)
    if dist is None:
        dist = _cached_dist(top, entry, dev)
    else:
        dist = np.asarray(dist)
    nbr = _cached_nbr(top, entry)

    n = top.n_switches
    lo = np.minimum(arr[:, 0], arr[:, 1])
    hi = np.maximum(arr[:, 0], arr[:, 1])
    keys, inv = np.unique(lo * n + hi, return_inverse=True)
    # for k <= 1 the slack assignment is always 0 (any finite pair has >= 1
    # shortest path), so skip the slack precompute entirely
    counts = None
    slack_init = None
    if max_slack >= 1 and k > 1:
        mode = use_counts
        if mode is True:
            lmax = max(_finite_dist_max(dist) + 1, 1)
            if lmax * n * n * 4 > _WALK_TABLE_BYTES:
                mode = "subset"  # same budgets, no O(diam * N^3) table
        if mode is True:
            counts = _cached_walk_counts(top, entry, dist)
        elif mode == "subset":
            slack_init = _subset_slack(
                _slack_adj(top, entry), dist, keys // n, keys % n, k
            )
    uniq = _k_shortest_unique(
        nbr, dist, keys // n, keys % n, k, max_slack, max_enum,
        counts=counts, slack_init=slack_init, device=dev,
    )
    out: list[list[list[int]]] = []
    for i in range(len(arr)):
        paths = uniq[inv[i]]
        if arr[i, 0] > arr[i, 1]:
            paths = [p[::-1] for p in paths]
        else:
            # copy so duplicate pairs don't alias one mutable path list
            paths = [list(p) for p in paths]
        out.append(paths)
    return out


# --------------------------------------------------------------------------- #
# PathSystem
# --------------------------------------------------------------------------- #


@dataclasses.dataclass
class PathSystem:
    """Padded path-edge representation of a routing table over commodities.

    Links are full duplex: undirected edge ``e`` of the topology contributes
    two *directed capacity slots*, ``e`` (low->high endpoint) and
    ``e + n_edges`` (high->low).  ``path_edges[p, j]`` is the directed slot of
    hop j of path p, padded with ``n_slots`` (a sentinel).
    ``path_owner[p]`` is the commodity index.
    """

    n_edges: int  # undirected edge count E of the topology
    path_edges: np.ndarray  # (P, Lmax) int32 directed slots, padded with 2E
    path_len: np.ndarray  # (P,) int32
    path_owner: np.ndarray  # (P,) int32 commodity index
    demands: np.ndarray  # (K,) float32
    capacities: np.ndarray  # (2E,) float32, per direction
    n_commodities: int
    node_paths: list[list[list[int]]] | None = None  # per commodity, node seqs
    unrouted: np.ndarray | None = None  # (K0,) bool: commodities with no path
    # ---- delta pedigree (consumed by update_path_system / warm starts) ----
    src: np.ndarray | None = None  # (K0,) commodity sources (switch ids)
    dst: np.ndarray | None = None  # (K0,) commodity destinations
    k: int = 8  # paths per commodity this system was built with
    max_slack: int = 4  # slack budget this system was built with
    row_map: np.ndarray | None = None  # (P,) row index into the predecessor
    #   path system (-1 for freshly enumerated rows); set by
    #   update_path_system so flow solvers can warm-start from the
    #   predecessor's rate vector

    @property
    def n_slots(self) -> int:
        return len(self.capacities)

    @property
    def n_paths(self) -> int:
        return len(self.path_edges)

    def loads(self, rates: np.ndarray) -> np.ndarray:
        """Per-directed-slot load for per-path rates (numpy reference)."""
        load = np.zeros(self.n_slots + 1, dtype=np.float64)
        np.add.at(
            load,
            self.path_edges.reshape(-1),
            np.repeat(rates, self.path_edges.shape[1]),
        )
        return load[: self.n_slots]


def _slot_chunk_fill(
    flat: list[list[int]],
    lens: np.ndarray,
    lmax_nodes: int,
    n: int,
    E: int,
    sorted_keys: np.ndarray,
    order: np.ndarray,
    pe_out: np.ndarray,
    len_out: np.ndarray,
) -> None:
    """Slot-convert one row chunk of the flat path list into output views.

    Writes the chunk's padded slot rows into ``pe_out`` (prefilled with the
    ``2E`` sentinel) and hop counts into ``len_out``.  Chunk boundaries sit
    at path-row granularity and every row's conversion depends only on its
    own node sequence, so chunked assembly is byte-identical to one-shot.
    """
    from itertools import chain

    Pc = len(flat)
    if not Pc:
        return
    nodes = np.full((Pc, lmax_nodes), -1, dtype=np.int64)
    vals = np.fromiter(
        chain.from_iterable(flat), dtype=np.int64, count=int(lens.sum())
    )
    rows = np.repeat(np.arange(Pc), lens)
    cols = np.arange(len(vals)) - np.repeat(np.cumsum(lens) - lens, lens)
    nodes[rows, cols] = vals
    a, b = nodes[:, :-1], nodes[:, 1:]
    hop = b >= 0
    lo = np.minimum(a, b)
    hi = np.maximum(a, b)
    qkey = np.where(hop, lo * n + hi, 0)
    eid = order[np.searchsorted(sorted_keys, qkey)]
    slots = np.where(a < b, eid, eid + E)
    if lmax_nodes > 1:
        pe_out[:, : lmax_nodes - 1] = np.where(hop, slots, 2 * E)
    len_out[:] = hop.sum(axis=1)


def _paths_to_slots(
    top: Topology,
    entry: dict,
    all_paths: list[list[list[int]]],
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Streamed conversion of node sequences to the padded slot matrix.

    The output (P, Lmax) slot matrix is allocated once; the node-matrix and
    slot-conversion temporaries are built per bounded row chunk
    (``_slot_chunk_fill``), so assembly working memory is one chunk's —
    budgeted against ``REPRO_ROUTE_TILE_BYTES`` like the enumerator's tiles
    — instead of ~6 path-table-sized intermediates at once.  The batch
    builder leans on this: B instances' conversions stream through the same
    bounded scratch.
    """
    E = top.n_edges
    n = top.n_switches
    flat = [p for paths in all_paths for p in paths]
    P = len(flat)
    lens = np.fromiter(map(len, flat), dtype=np.int64, count=P)
    lmax_nodes = int(lens.max()) if P else 2
    per_comm = np.fromiter(map(len, all_paths), dtype=np.int64, count=len(all_paths))
    nonempty = per_comm > 0
    kept = np.int32(nonempty.sum())
    owner = np.repeat(
        np.arange(int(kept), dtype=np.int32), per_comm[nonempty]
    )

    pe = np.full((P, max(lmax_nodes - 1, 1)), 2 * E, dtype=np.int32)
    path_len = np.zeros(P, dtype=np.int32)
    sorted_keys, order = _cached_slot_lookup(top, entry)
    # ~6 (rows, lmax) int64/bool temporaries live during a chunk conversion
    rows_budget = max(1024, _FRONTIER_TILE_BYTES // max(48 * lmax_nodes, 1))
    for lo in range(0, P, rows_budget):
        hi = min(lo + rows_budget, P)
        _slot_chunk_fill(
            flat[lo:hi], lens[lo:hi], lmax_nodes, n, E,
            sorted_keys, order, pe[lo:hi], path_len[lo:hi],
        )
    return pe, path_len, owner, np.int32(kept)


def build_path_system(
    top: Topology,
    comm: Commodities,
    k: int = 8,
    max_slack: int = 4,
    dist: np.ndarray | None = None,
    keep_node_paths: bool = False,
    cache: bool = True,
    device: "str | torch.device" = "cuda",
) -> PathSystem:
    """Routing tables (k shortest paths) for every commodity of ``comm``.

    ``cache=True`` (default) reuses per-topology state (APSP distance matrix,
    neighbor table, edge-slot lookup) across calls, so evaluating several
    traffic matrices on one topology only pays for the APSP once.
    ``device`` is where the APSP and the ``kernel`` admission prune run; the
    returned tables are host numpy arrays, identical on every device.
    """
    entry = _topo_entry(top, cache=cache)
    pairs = list(zip(comm.src.tolist(), comm.dst.tolist()))
    all_paths = k_shortest_paths(
        top, pairs, k=k, max_slack=max_slack, dist=dist, cache=cache,
        device=device,
    )

    unrouted = np.array([len(p) == 0 for p in all_paths], dtype=bool)
    E = top.n_edges
    pe, path_len, owner, kept = _paths_to_slots(top, entry, all_paths)
    demands = comm.demand[~unrouted].astype(np.float32)
    ps = PathSystem(
        n_edges=E,
        path_edges=pe,
        path_len=path_len,
        path_owner=owner,
        demands=demands,
        capacities=np.ones(2 * E, dtype=np.float32),
        n_commodities=int(kept),
        node_paths=all_paths if keep_node_paths else None,
        unrouted=unrouted,
        src=np.asarray(comm.src, dtype=np.int64).copy(),
        dst=np.asarray(comm.dst, dtype=np.int64).copy(),
        k=k,
        max_slack=max_slack,
    )
    if checks_enabled():
        check_path_system(ps, top, name="build_path_system")
    return ps


def _group_slack_init(
    top: Topology,
    entry: dict,
    dist: np.ndarray,
    src_u: np.ndarray,
    dst_u: np.ndarray,
    k: int,
    max_slack: int,
) -> np.ndarray:
    """Per-unique-pair slack budgets for one topology group.

    Mirrors ``k_shortest_paths``' ``use_counts=True`` gating exactly — the
    cached walk-count table while it fits ``_WALK_TABLE_BYTES``, batched
    row powers (``_subset_slack``) beyond — and replicates the counts ->
    slack decision rule of ``_k_shortest_unique`` verbatim, so the batch
    build hands the combined enumeration the same per-pair budgets the
    sequential builds would compute.  Budgets are purely a cost knob
    (path sets are budget-invariant past the minimum), but matching them
    keeps the two paths' work — and wall-clock rows — comparable.
    """
    q = len(src_u)
    slack = np.zeros(q, dtype=np.int64)
    if max_slack < 1 or k <= 1 or not q:
        return slack
    n = top.n_switches
    lmax = max(_finite_dist_max(dist) + 1, 1)
    if lmax * n * n * 4 > _WALK_TABLE_BYTES:
        return _subset_slack(_slack_adj(top, entry), dist, src_u, dst_u, k)
    counts = _cached_walk_counts(top, entry, dist)
    base = hops_to_f32(dist[src_u, dst_u])
    active = np.flatnonzero(np.isfinite(base))
    if not len(active):
        return slack
    d = base[active].astype(np.int64)
    pos = d >= 1  # src == dst pairs keep slack 0
    ai, di = active[pos], d[pos]
    w_d = counts[di - 1, src_u[ai], dst_u[ai]]
    w_d1 = counts[np.minimum(di, len(counts) - 1), src_u[ai], dst_u[ai]]
    w_d1 = np.where(di < len(counts), w_d1, 0.0)
    slack[ai] = np.where(w_d >= k, 0, np.where(w_d + w_d1 >= k, 1, 2))
    return slack


def build_path_system_batch(
    tops: "list[Topology]",
    comms: "list[Commodities]",
    k: int = 8,
    max_slack: int = 4,
    max_enum: int = 4096,
    keep_node_paths: bool = False,
    cache: bool = True,
    bucket: bool = True,
    device: "str | torch.device" = "cuda",
):
    """Build B instances' routing tables as ONE cross-instance enumeration.

    Pipeline (the batch rung of the construction stack)::

        group by topology fingerprint     (identical topologies share a block)
          |  per group: APSP + neighbor table + slack budgets  (cached state)
          v
        block-diagonal composition        (group g's ids offset by bases[g])
          |  ONE level-synchronous frontier pass over every group's pairs,
          |  dst-sharded -> (instance-group, pair) shards, caps from
          |  REPRO_ROUTE_TILE_BYTES (block-compact tiles, no composed matrix)
          v
        per-instance distribution         (local ids; reverse src>dst)
          |  streamed _paths_to_slots per instance (bounded row chunks)
          v
        PathSystemBatch.from_systems      (common envelope, gather tables)

    Returns a ``core.flow.PathSystemBatch`` whose ``systems[i]`` is
    **byte-identical** to ``build_path_system(tops[i], comms[i], ...)``:
    per-pair enumeration never leaves its block (the composed neighbor
    table is block-diagonal and cross-block distances are +inf), the
    canonical (length, lex) tie order is invariant under the uniform
    per-block id offset, and the frontier cap binds per pair — so sharding
    instances together changes where the work happens, never its result
    (INVARIANTS.md CT-build; asserted by ``tests/test_torch_buildbatch.py``).

    The win is amortization: every expansion level's fixed numpy overhead
    is paid once for the whole batch instead of once per instance, and
    duplicate (topology, pair) work dedups across instances — a sweep's
    probe matrices over one topology collapse to the union of their pairs.

    ``device`` is where each group's APSP and the ``kernel`` admission
    prune run; the returned tables are host numpy arrays, identical on
    every device.
    """
    from .flow import PathSystemBatch  # local: flow imports PathSystem et al

    dev = resolve(device)

    tops = list(tops)
    comms = list(comms)
    if len(tops) != len(comms):
        raise ValueError(
            f"build_path_system_batch needs one Commodities per topology: "
            f"got {len(tops)} topologies, {len(comms)} commodity sets"
        )
    if not tops:
        raise ValueError("build_path_system_batch needs at least one instance")

    B = len(tops)
    entries = [_topo_entry(t, cache=cache) for t in tops]

    # ---- group instances by edge-set fingerprint ------------------------- #
    gid_of: dict[tuple, int] = {}
    group_rep: list[int] = []  # representative instance index per group
    inst_group = np.empty(B, dtype=np.int64)
    for i, t in enumerate(tops):
        key = _topo_key(t)
        g = gid_of.get(key)
        if g is None:
            g = len(group_rep)
            gid_of[key] = g
            group_rep.append(i)
        inst_group[i] = g
    G = len(group_rep)
    members: list[list[int]] = [[] for _ in range(G)]
    for i in range(B):
        members[int(inst_group[i])].append(i)

    # ---- per-instance canonical pair keys, per-group unique pair sets ---- #
    inst_keys: list[np.ndarray] = []
    for i in range(B):
        n_g = tops[i].n_switches
        s = np.asarray(comms[i].src, dtype=np.int64)
        d = np.asarray(comms[i].dst, dtype=np.int64)
        inst_keys.append(np.minimum(s, d) * n_g + np.maximum(s, d))
    group_keys = [
        np.unique(np.concatenate([inst_keys[i] for i in members[g]]))
        for g in range(G)
    ]

    # ---- block-diagonal composition -------------------------------------- #
    sizes = np.array([tops[group_rep[g]].n_switches for g in range(G)],
                     dtype=np.int64)
    bases = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    group_dist = []
    group_nbr = []
    for g in range(G):
        rep = group_rep[g]
        group_dist.append(_cached_dist(tops[rep], entries[rep], dev))
        group_nbr.append(_cached_nbr(tops[rep], entries[rep]))

    offs = np.concatenate(
        [[0], np.cumsum([len(gk) for gk in group_keys])]
    ).astype(np.int64)
    src_all = np.empty(int(offs[-1]), dtype=np.int64)
    dst_all = np.empty(int(offs[-1]), dtype=np.int64)
    slack_all = np.empty(int(offs[-1]), dtype=np.int64)
    for g in range(G):
        gk = group_keys[g]
        n_g = int(sizes[g])
        b = int(bases[g])
        rep = group_rep[g]
        s_u, d_u = gk // n_g, gk % n_g
        sl = slice(int(offs[g]), int(offs[g + 1]))
        src_all[sl] = s_u + b
        dst_all[sl] = d_u + b
        slack_all[sl] = _group_slack_init(
            tops[rep], entries[rep], group_dist[g], s_u, d_u, k, max_slack
        )

    # ---- ONE combined enumeration over every group's pairs --------------- #
    uniq = _k_shortest_unique(
        None, _BlockDist(group_dist, group_nbr, bases), src_all, dst_all,
        k, max_slack, max_enum, slack_init=slack_all, device=dev,
    )

    # ---- distribute per instance, stream slot assembly ------------------- #
    systems = []
    for i in range(B):
        g = int(inst_group[i])
        inv = np.searchsorted(group_keys[g], inst_keys[i]) + int(offs[g])
        s_i = np.asarray(comms[i].src, dtype=np.int64)
        d_i = np.asarray(comms[i].dst, dtype=np.int64)
        # enumeration already collected LOCAL ids (block-compact shards),
        # so distribution is copy + src>dst reversal, like the sequential
        # build — no per-element offset arithmetic here
        rev = (s_i > d_i).tolist()
        all_paths: list[list[list[int]]] = []
        for j, q in enumerate(inv.tolist()):
            found = uniq[q]
            if rev[j]:
                paths = [p[::-1] for p in found]
            else:
                # copy so duplicate pairs never alias
                paths = [list(p) for p in found]
            all_paths.append(paths)
        unrouted = np.array([len(p) == 0 for p in all_paths], dtype=bool)
        E = tops[i].n_edges
        pe, path_len, owner, kept = _paths_to_slots(tops[i], entries[i],
                                                    all_paths)
        systems.append(PathSystem(
            n_edges=E,
            path_edges=pe,
            path_len=path_len,
            path_owner=owner,
            demands=comms[i].demand[~unrouted].astype(np.float32),
            capacities=np.ones(2 * E, dtype=np.float32),
            n_commodities=int(kept),
            node_paths=all_paths if keep_node_paths else None,
            unrouted=unrouted,
            src=s_i.copy(),
            dst=d_i.copy(),
            k=k,
            max_slack=max_slack,
        ))
    batch = PathSystemBatch.from_systems(systems, bucket=bucket)
    if checks_enabled():
        check_built_batch(batch, tops, name="build_path_system_batch")
    return batch


def ecmp_path_system(
    top: Topology,
    comm: Commodities,
    n_ways: int = 64,
    dist: np.ndarray | None = None,
    keep_node_paths: bool = False,
    cache: bool = True,
    device: "str | torch.device" = "cuda",
) -> PathSystem:
    """Equal-cost shortest-path (ECMP) routing tables (paper §3, Table 1).

    ECMP forwarding can use exactly the *shortest* paths: every prefix of a
    shortest path extends along any next hop that stays on a shortest path,
    so the set of distinct s->t routes realizable by per-hop equal-cost
    splitting is the set of shortest simple paths, capped in practice by the
    hardware's way count (64-way in the paper's Table 1, 16-way commodity
    gear).  That is ``build_path_system`` with ``max_slack=0`` and
    ``k = n_ways``: the batched enumerator admits only prefixes that can
    still complete at the base distance, and its canonical (lexicographic)
    tie order makes the returned ECMP sets a pure function of (graph, pair,
    n_ways) — bit-identical across APSP backends and enumeration shards,
    which is what lets ``repro_torch.sim`` hash flows onto them deterministically.

    The paper's §3 observation (Table 1, Fig 9) falls straight out of the
    result: on a random graph most pairs have very few equal-cost paths, so
    ECMP leaves many links unused (``repro_torch.sim.telemetry.path_diversity``
    counts them), while a k-ary fat-tree gives every inter-pod edge-switch
    pair exactly ``(k/2)^2`` equal-cost paths.  Per-commodity distinct-path
    counts are ``np.bincount(ps.path_owner, minlength=ps.n_commodities)``.
    ``device`` runs the APSP and the ``kernel`` admission prune, as in
    ``build_path_system``.
    """
    if n_ways < 1:
        raise ValueError(f"n_ways must be >= 1, got {n_ways}")
    return build_path_system(
        top, comm, k=n_ways, max_slack=0, dist=dist,
        keep_node_paths=keep_node_paths, cache=cache, device=device,
    )


# --------------------------------------------------------------------------- #
# delta updates (paper §4.2 expansion / §4.3 failure workloads)
# --------------------------------------------------------------------------- #


def _bfs_rows(adj, rows: np.ndarray) -> np.ndarray:
    """Hop distances from each source in ``rows`` (batched BLAS frontier BFS).

    The rectangular sibling of ``metrics.apsp_hops``: (len(rows), N) instead
    of (N, N), so repairing a handful of APSP rows after a topology delta
    costs |rows| / N of a full recompute.  ``adj`` may be dense or CSR (the
    frontier product is a dense ndarray either way).
    """
    m, n = len(rows), adj.shape[0]
    if hasattr(adj, "tocsr"):
        a = adj
    else:
        a = (adj != 0).astype(np.float32)
    dist = np.full((m, n), np.inf, dtype=np.float32)
    dist[np.arange(m), rows] = 0.0
    reach = np.zeros((m, n), dtype=np.float32)
    reach[np.arange(m), rows] = 1.0
    for step in range(1, n + 1):
        newly = (np.asarray(reach @ a) > 0) & ~np.isfinite(dist)
        if not newly.any():
            break
        dist[newly] = step
        reach[dist < np.inf] = 1.0
    return dist


def _dist_is_exact(d: np.ndarray, nbr: np.ndarray) -> bool:
    """Check ``d`` is the exact APSP matrix of the graph behind ``nbr``.

    The Bellman system ``d[s,s] = 0``, ``d[s,t] = 1 + min_{w in N(t)} d[s,w]``
    has the true hop-distance matrix as its unique solution (downward
    violations propagate to a smaller violator; upward ones break the
    recurrence along a shortest path), so one O(N^2 * d_max) gather-min pass
    certifies a candidate built from stale state.  This turns the APSP delta
    into *construct optimistically, verify, recompute only on failure* —
    removals rarely shift distances on a low-diameter random graph, so the
    fallback is the exception.

    Accepts the canonical int16 hop matrix (sentinel ``INT16_INF``, verified
    in int32 so the sentinel + 1 gather-min cannot wrap) as well as float32
    with +inf — whichever form the blocked/dense APSP backends produced.
    """
    n = d.shape[0]
    if not (d.diagonal() == 0).all():
        return False
    is_i16 = d.dtype == np.int16
    if is_i16:
        pad_val, inf32 = INT16_INF, np.int32(INT16_INF)
        dpad = np.concatenate([d, np.full((n, 1), pad_val, dtype=np.int16)], axis=1)
    else:
        dpad = np.concatenate([d, np.full((n, 1), np.inf, dtype=np.float32)], axis=1)
    # chunk the gather to bound the (rows, chunk, d_max) temporary
    step = max(1, (1 << 22) // max(n * nbr.shape[1], 1))
    for lo in range(0, n, step):
        cols = nbr[lo: lo + step]  # (c, d_max) neighbor lists of chunk nodes
        if is_i16:
            best = dpad[:, cols].min(axis=2).astype(np.int32) + 1  # (n, c)
            want = d[:, lo: lo + step].astype(np.int32)
            # "unreachable" satisfies the recurrence when every neighbor is
            # unreachable too: best = sentinel + 1, want = sentinel
            eq = (best == want) | ((want == inf32) & (best > inf32))
        else:
            best = dpad[:, cols].min(axis=2) + 1.0
            want = d[:, lo: lo + step]
            eq = best == want
        ar = np.arange(lo, min(lo + step, n))
        eq[ar, ar - lo] = True  # diagonal handled above
        if not eq.all():
            return False
    return True


def _repair_dist(
    dist_old: np.ndarray,
    top_new: Topology,
    kept_old: np.ndarray,
    kept_new: np.ndarray,
    rows: np.ndarray,
    added: np.ndarray,
    adj=None,
) -> np.ndarray:
    """Candidate APSP for ``top_new`` from ``dist_old`` plus a bounded repair.

    1. Surviving rows/columns of the old matrix are copied over.
    2. ``rows`` (new switches plus endpoints of removed edges — the entries
       whose stale values are certainly wrong) are recomputed exactly by
       batched BFS on the new adjacency.
    3. Added edges are folded in Floyd-Warshall-style: seed their unit
       entries, then pivot once through each added endpoint.  Any new
       shortest path decomposes into old-graph segments joined at added
       endpoints, so one pass over those pivots (in any order) folds them
       in — the classical FW induction on the condensed graph.

    The result is exact unless a removal changed some distance between
    surviving rows; callers certify with ``_dist_is_exact`` and fall back to
    a full ``_apsp`` when the check fails, so the construction here only has
    to be right in the common case, never in all cases.

    ``dist_old`` may be canonical int16 or float32; the repair workspace is a
    transient float32 matrix (the FW pivots need +inf arithmetic) and the
    result is returned in the canonical int16 form.
    """
    n = top_new.n_switches
    d = np.full((n, n), np.inf, dtype=np.float32)
    d[np.ix_(kept_new, kept_new)] = hops_to_f32(dist_old[np.ix_(kept_old, kept_old)])
    np.fill_diagonal(d, 0.0)
    if adj is None:
        adj = top_new.adjacency()
    if len(rows):
        sub = _bfs_rows(adj, rows)
        d[rows, :] = sub
        d[:, rows] = sub.T
    if len(added):
        au, av = added[:, 0], added[:, 1]
        d[au, av] = np.minimum(d[au, av], 1.0)
        d[av, au] = d[au, av]
        for w in np.unique(added):
            np.minimum(d, d[:, w, None] + d[w, None, :], out=d)
    return hops_to_int16(d)


def _resolve_node_map(
    top_old: Topology, top_new: Topology, node_map: np.ndarray | None
) -> np.ndarray | None:
    """old-id -> new-id map relating the two topologies, or None if unknown.

    Priority: explicit argument; a producer-recorded ``meta["node_remap"]``
    whose ``meta["delta_parent"]`` fingerprint proves it relates exactly these
    two topologies; identity when ids are append-stable (n_old <= n_new, the
    case for every producer that does not renumber).
    """
    if node_map is not None:
        return np.asarray(node_map, dtype=np.int64)
    meta = top_new.meta or {}
    if (
        meta.get("node_remap") is not None
        and meta.get("delta_parent") == edge_fingerprint(top_old)
    ):
        return np.asarray(meta["node_remap"], dtype=np.int64)
    if top_old.n_switches <= top_new.n_switches:
        return np.arange(top_old.n_switches, dtype=np.int64)
    return None


def update_path_system(
    ps: PathSystem,
    top_old: Topology,
    top_new: Topology,
    comm: Commodities,
    k: int | None = None,
    max_slack: int | None = None,
    node_map: np.ndarray | None = None,
    dist_old: np.ndarray | None = None,
    cache: bool = True,
    rebuild_fraction: float = 0.25,
    keep_node_paths: bool = False,
    device: "str | torch.device" = "cuda",
) -> PathSystem:
    """Incrementally re-route after a topology delta (expansion / failure).

    Produces the path system ``build_path_system(top_new, comm, ...)`` would,
    but treats the edge-set delta between ``top_old`` and ``top_new`` as the
    common case (paper §4.2/§4.3: expansion steps and failures are small
    perturbations of a random graph):

    * the APSP matrix is repaired in place — batched BFS for the rows touched
      by removals plus new switches, Floyd-Warshall pivots over added-edge
      endpoints — instead of recomputed;
    * k-shortest paths are re-enumerated only for commodities whose cached
      paths cross a removed edge, whose endpoint distance changed, whose
      endpoints are new switches, or for which an added edge admits a path
      short enough to enter the k-shortest set;
    * every other commodity's path rows are spliced from ``ps`` with a pure
      slot-id remap — no ``_paths_to_slots`` re-run, no re-enumeration.

    Because the enumerator breaks length ties canonically, the spliced system
    is *identical* to a from-scratch rebuild (same path sets, same per-path
    order), so LP/MW alphas match to solver tolerance.  ``row_map`` on the
    result maps each path row to its row in ``ps`` (-1 for fresh rows), which
    ``mw_concurrent_flow(..., warm=...)`` uses to warm-start from the
    previous flow vector.

    Falls back to a full ``build_path_system`` when the delta is large
    (> ``rebuild_fraction`` of edges), the topologies cannot be related
    (unknown renumbering), or ``ps`` lacks pedigree (src/dst or a different
    k/max_slack).  Node ids must be stable between the two topologies unless
    a ``node_map`` (old -> new, -1 = dropped) is supplied or recorded by the
    producer in ``top_new.meta["node_remap"]`` (see ``core.expansion``).

    ``device`` is where every APSP (``_apsp``), the re-enumeration's
    admission prune and the rebuild run, as in ``build_path_system``; the
    repair and its certificate are host numpy.  The rebuild branch is the
    reference's semantics for a delta it cannot splice, not a device
    fallback: it runs on the same ``device``.
    """
    dev = resolve(device)
    kk = ps.k if k is None else k
    ms = ps.max_slack if max_slack is None else max_slack

    def rebuild() -> PathSystem:
        obs.counter("route/update/rebuilds").inc()
        return build_path_system(
            top_new, comm, k=kk, max_slack=ms, cache=cache,
            keep_node_paths=keep_node_paths, device=dev,
        )

    if ps.src is None or ps.dst is None or ps.unrouted is None:
        return rebuild()
    if kk != ps.k or ms != ps.max_slack:
        return rebuild()
    nm = _resolve_node_map(top_old, top_new, node_map)
    if nm is None:
        return rebuild()

    E_old, E_new = top_old.n_edges, top_new.n_edges
    n_new = top_new.n_switches
    added, removed_mask, eid_map = edge_delta(top_old, top_new, nm)
    n_changed = len(added) + int(removed_mask.sum())
    if n_changed > rebuild_fraction * max(E_new, 1):
        return rebuild()

    # ---- APSP: reuse / repair ------------------------------------------- #
    if dist_old is None:
        old_entry = _topo_cache.get(_topo_key(top_old)) if cache else None
        dist_old = old_entry.get("dist") if old_entry else None
    if dist_old is None:
        # No cached predecessor APSP: recompute it (still far cheaper than a
        # full rebuild, which would also redo walk counts and enumeration).
        dist_old = _apsp(top_old.adjacency(), diameter_hint=_diameter_hint(top_old),
                         device=dev)
    else:
        dist_old = np.asarray(dist_old)  # canonical int16 or caller float

    entry_new = _topo_entry(top_new, cache=cache)
    nbr_new = _cached_nbr(top_new, entry_new)
    if "dist" in entry_new:
        dist_new = entry_new["dist"]
    elif n_new < 384:
        # below a few hundred switches the dense BLAS APSP is cheaper than
        # candidate construction + certification — just recompute
        dist_new = _apsp(
            _cached_adj(top_new, entry_new), diameter_hint=_diameter_hint(top_new),
            device=dev,
        )
        entry_new["dist"] = dist_new
    else:
        kept_old = np.flatnonzero(nm >= 0)
        kept_new = nm[kept_old]
        # rows that are certainly stale: new switches, plus endpoints of
        # removed edges (their direct entry changed for sure); everything
        # else is assumed unchanged and certified below
        new_nodes = np.setdiff1d(np.arange(n_new, dtype=np.int64), kept_new)
        removed_ends = nm[np.unique(top_old.edges[removed_mask])]
        rows = np.union1d(removed_ends[removed_ends >= 0], new_nodes)
        cand = _repair_dist(
            dist_old, top_new, kept_old, kept_new, rows, added,
            adj=_slack_adj(top_new, entry_new),
        )
        if _dist_is_exact(cand, nbr_new):
            dist_new = cand
        else:  # a removal shifted distances between surviving rows
            dist_new = _apsp(
                _cached_adj(top_new, entry_new),
                diameter_hint=_diameter_hint(top_new), device=dev,
            )
        entry_new["dist"] = dist_new

    # ---- per-commodity reuse decision (vectorized) ----------------------- #
    src_n = np.asarray(comm.src, dtype=np.int64)
    dst_n = np.asarray(comm.dst, dtype=np.int64)
    K = len(src_n)

    # join new commodities against old ones on the (mapped) ordered pair key
    s_m, t_m = nm[ps.src], nm[ps.dst]
    alive_idx = np.flatnonzero((s_m >= 0) & (t_m >= 0))
    key_old = s_m[alive_idx] * n_new + t_m[alive_idx]
    order_o = np.argsort(key_old, kind="stable")  # dup pairs: first one wins
    sorted_keys = key_old[order_o]
    key_new = src_n * n_new + dst_n
    pos = np.searchsorted(sorted_keys, key_new)
    pos_ok = pos < len(sorted_keys)
    matched = pos_ok.copy()
    if len(sorted_keys):
        matched[pos_ok] = sorted_keys[pos[pos_ok]] == key_new[pos_ok]
    else:
        matched[:] = False
    old_of = np.full(K, -1, dtype=np.int64)
    old_of[matched] = alive_idx[order_o[pos[matched]]]

    n_kept_old = int((~ps.unrouted).sum())
    old_kept_of = np.cumsum(~ps.unrouted) - 1  # valid where routed
    owner_sorted = np.argsort(ps.path_owner, kind="stable")
    owner_bounds = np.searchsorted(
        ps.path_owner[owner_sorted], np.arange(n_kept_old + 1)
    )

    # rows whose slots touch a removed edge; per-commodity stats via reduceat
    # over owner-grouped rows (every kept commodity owns >= 1 row)
    slots = ps.path_edges
    valid = slots < 2 * E_old
    eid = np.where(valid, slots % max(E_old, 1), 0)
    row_broken = (removed_mask[eid] & valid).any(axis=1) if E_old else (
        np.zeros(len(slots), dtype=bool)
    )
    cnt = np.diff(owner_bounds)
    if n_kept_old:
        starts = owner_bounds[:-1]
        maxlen = np.maximum.reduceat(
            ps.path_len[owner_sorted].astype(np.int64), starts
        )
        broken_kept = np.maximum.reduceat(
            row_broken[owner_sorted].astype(np.uint8), starts
        ).astype(bool)
    else:
        maxlen = np.zeros(0, dtype=np.int64)
        broken_kept = np.zeros(0, dtype=bool)

    # Added-edge perturbation test, per new commodity.  An added edge can
    # only enter a pair's k-shortest set with a path no longer than the
    # pair's kept budget: strictly shorter always displaces, and a
    # tie-length candidate can reshuffle the canonical tie selection — so
    # any admissible added-edge path at or under the budget forces a
    # re-enumeration.
    d_pair_new = hops_to_f32(dist_new[src_n, dst_n])
    if len(added):
        au, av = added[:, 0], added[:, 1]
        # np.ix_ gathers keep the temporaries at (K, |added|) instead of the
        # (K, N) row gather the chained indexing used to materialize
        via_added = np.minimum(
            hops_to_f32(dist_new[np.ix_(src_n, au)])
            + hops_to_f32(dist_new[np.ix_(dst_n, av)]),
            hops_to_f32(dist_new[np.ix_(src_n, av)])
            + hops_to_f32(dist_new[np.ix_(dst_n, au)]),
        ).min(axis=1) + 1.0  # shortest path length through any added edge
    else:
        via_added = np.full(K, np.inf, dtype=np.float32)

    reuse = np.zeros(K, dtype=bool)
    mi = old_of[matched]  # old commodity index per matched new commodity
    m_js = np.flatnonzero(matched)
    unr_old = ps.unrouted[mi]
    # previously-unrouted pairs stay reusable iff still disconnected
    still_cut = ~np.isfinite(d_pair_new[m_js])
    reuse[m_js[unr_old]] = still_cut[unr_old]
    # routed pairs: intact rows, unchanged distance, no added-edge shortcut
    r_js = m_js[~unr_old]
    r_mi = mi[~unr_old]
    ci = old_kept_of[r_mi]
    ok = ~broken_kept[ci]
    ok &= hops_to_f32(dist_old[ps.src[r_mi], ps.dst[r_mi]]) == d_pair_new[r_js]
    budget = np.where(
        cnt[ci] >= kk, maxlen[ci].astype(np.float64), d_pair_new[r_js] + ms
    )
    ok &= via_added[r_js] > budget
    reuse[r_js] = ok

    # ---- re-enumerate the rest ------------------------------------------ #
    enum_js = np.flatnonzero(~reuse)
    pairs = [(int(src_n[j]), int(dst_n[j])) for j in enum_js]
    with obs.span("build/enum_delta", pairs=len(pairs)):
        if cache:
            enum_paths = k_shortest_paths(
                top_new, pairs, k=kk, max_slack=ms, cache=True,
                use_counts="subset", device=dev,
            )
        else:
            enum_paths = k_shortest_paths(
                top_new, pairs, k=kk, max_slack=ms, dist=dist_new,
                cache=False, use_counts="subset", device=dev,
            )
    pe_e, len_e, owner_e, kept_e = _paths_to_slots(top_new, entry_new, enum_paths)

    # ---- splice (vectorized) --------------------------------------------- #
    # old directed slot -> new directed slot (surviving edges keep identity
    # up to renumbering; the sentinel maps to the new sentinel)
    slot_map = np.full(2 * E_old + 1, 2 * E_new, dtype=np.int32)
    surv = np.flatnonzero(eid_map >= 0)
    slot_map[surv] = eid_map[surv].astype(np.int32)
    slot_map[surv + E_old] = (eid_map[surv] + E_new).astype(np.int32)

    # per new commodity: 0 = unrouted, 1 = spliced from ps, 2 = enumerated
    stat = np.zeros(K, dtype=np.int8)
    cnt_j = np.zeros(K, dtype=np.int64)
    ru_js = np.flatnonzero(reuse & ~ps.unrouted[np.maximum(old_of, 0)] & (old_of >= 0))
    ru_c = old_kept_of[old_of[ru_js]]
    stat[ru_js] = 1
    cnt_j[ru_js] = cnt[ru_c]
    has_paths = np.fromiter(
        (len(p) > 0 for p in enum_paths), dtype=bool, count=len(enum_paths)
    )
    en_js = enum_js[has_paths]
    stat[en_js] = 2
    cnt_j[en_js] = np.diff(
        np.searchsorted(owner_e, np.arange(int(kept_e) + 1))
    )
    unrouted_new = stat == 0
    # delta telemetry: how much of the update was splice vs re-enumeration
    obs.counter("route/update/deltas").inc()
    obs.counter("route/update/spliced").inc(int((stat == 1).sum()))
    obs.counter("route/update/enumerated").inc(len(enum_js))
    obs.counter("route/update/unrouted").inc(int(unrouted_new.sum()))
    obs.instant(
        "route/update",
        commodities=K,
        spliced=int((stat == 1).sum()),
        enumerated=len(enum_js),
        unrouted=int(unrouted_new.sum()),
    )

    kept_js = np.flatnonzero(stat > 0)
    counts = cnt_j[kept_js]
    P_new = int(counts.sum())
    n_seq = len(kept_js)
    owner_final = np.repeat(np.arange(n_seq, dtype=np.int32), counts)
    flags = np.repeat(stat[kept_js], counts)
    old_pos = np.flatnonzero(flags == 1)
    enum_pos = np.flatnonzero(flags == 2)

    # gather old rows group-by-group in commodity order (vectorized ranges)
    ru_in_kept = stat[kept_js] == 1
    c_seq = old_kept_of[old_of[kept_js[ru_in_kept]]]
    starts, lens = owner_bounds[c_seq], cnt[c_seq]
    total = int(lens.sum())
    if total:
        offs = np.repeat(starts, lens) + (
            np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)
        )
        old_rows = owner_sorted[offs]
    else:
        old_rows = np.zeros(0, dtype=np.int64)
    enum_rows = np.arange(len(pe_e), dtype=np.int64)  # pe_e is already in order

    w_old = ps.path_edges.shape[1] if len(old_pos) else 0
    w_new = pe_e.shape[1] if len(enum_pos) else 0
    lmax = max(w_old, w_new, 1)
    pe_final = np.full((P_new, lmax), 2 * E_new, dtype=np.int32)
    len_final = np.zeros(P_new, dtype=np.int32)
    row_map = np.full(P_new, -1, dtype=np.int64)
    if len(old_pos):
        pe_final[old_pos[:, None], np.arange(w_old)[None, :]] = slot_map[
            ps.path_edges[old_rows]
        ]
        len_final[old_pos] = ps.path_len[old_rows]
        row_map[old_pos] = old_rows
    if len(enum_pos):
        pe_final[enum_pos[:, None], np.arange(w_new)[None, :]] = pe_e[enum_rows]
        len_final[enum_pos] = len_e[enum_rows]

    node_paths_new: list[list[list[int]]] | None = None
    if keep_node_paths and ps.node_paths is not None:
        node_paths_new = []
        cursor = {int(j): p for j, p in zip(enum_js, enum_paths)}
        for j in range(K):
            if stat[j] == 1:
                node_paths_new.append(
                    [[int(nm[x]) for x in p] for p in ps.node_paths[old_of[j]]]
                )
            else:
                node_paths_new.append(cursor.get(j, []))

    ps_new = PathSystem(
        n_edges=E_new,
        path_edges=pe_final,
        path_len=len_final,
        path_owner=owner_final,
        demands=comm.demand[~unrouted_new].astype(np.float32),
        capacities=np.ones(2 * E_new, dtype=np.float32),
        n_commodities=n_seq,
        node_paths=node_paths_new,
        unrouted=unrouted_new,
        src=src_n.copy(),
        dst=dst_n.copy(),
        k=kk,
        max_slack=ms,
        row_map=row_map,
    )
    if checks_enabled():
        check_path_system(ps_new, top_new, name="update_path_system")
    return ps_new
