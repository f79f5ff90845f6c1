"""Path-length metrics (paper §4.1 "Path Length", Fig 4).

APSP on unit-weight graphs via dense frontier BFS: ``R_{t+1} = R_t | R_t @ A``
computed with BLAS fp32 matmuls.  For N ~ 3200 (the paper's largest path-length
experiment) one step is ~65 GFLOP, which single-core BLAS clears in seconds;
the whole APSP needs ~diameter (≈4) steps.  The same min-plus formulation is
what the Pallas kernel (`repro.kernels.minplus`) implements for TPU.

Port copy of ``repro/core/metrics.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.

Beyond a couple thousand switches the dense float path stops scaling — the
(N, N) float32 matrix plus its BLAS frontier temporaries blow the memory
envelope — so the scale path is **blocked**: ``apsp_hops_blocked`` computes
distances one source-row block at a time (sparse-matmul frontier BFS) and
stores them in the *canonical int16 hop representation*: hop counts as int16
with ``INT16_INF`` (= 32767) marking unreachable pairs.  int16 halves the
resident distance state relative to float32 and is exact for any graph with
diameter < 32767 (guarded — conversion raises on overflow rather than wrap).
``hops_to_int16`` / ``hops_to_f32`` convert between the two forms; everything
downstream of ``repro.core.routing`` accepts either.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .topology import Topology

__all__ = [
    "apsp_hops",
    "apsp_hops_blocked",
    "INT16_INF",
    "hops_to_int16",
    "hops_to_f32",
    "PathStats",
    "path_stats",
    "bollobas_diameter_bound",
]

_INF = np.float32(np.inf)

#: Sentinel for "unreachable" in the canonical int16 hop-distance matrix.
INT16_INF = np.int16(np.iinfo(np.int16).max)  # 32767

#: path_stats switches to the blocked int16 APSP at this size (the dense
#: float path's N^2 f32 + BLAS temporaries stop being free around here).
BLOCKED_STATS_MIN_N = 2048


def hops_to_int16(d: np.ndarray) -> np.ndarray:
    """Compact a float hop-distance matrix to the canonical int16 form.

    Finite entries must be < ``INT16_INF`` (= 32767); a finite distance at or
    above the sentinel raises ``ValueError`` instead of silently wrapping —
    the int16 overflow guard for pathological (path-graph-like) diameters.
    """
    d = np.asarray(d)
    if d.dtype == np.int16:
        return d
    finite = np.isfinite(d)
    if finite.any() and float(d[finite].max()) >= int(INT16_INF):
        raise ValueError(
            f"hop distance {d[finite].max():.0f} >= int16 sentinel "
            f"{int(INT16_INF)}; the int16 representation cannot hold this "
            "graph's diameter"
        )
    # route non-finite entries through the sentinel BEFORE the cast (casting
    # inf to int16 is undefined and warns); the sentinel scalar must carry
    # d's own dtype or NumPy-2 promotion widens the whole temporary to f64
    return np.where(finite, d, d.dtype.type(int(INT16_INF))).astype(np.int16)


def hops_to_f32(d: np.ndarray) -> np.ndarray:
    """Float32 view of a hop matrix: int16 sentinel becomes +inf."""
    d = np.asarray(d)
    if d.dtype != np.int16:
        return d.astype(np.float32, copy=False)
    out = d.astype(np.float32)
    out[d == INT16_INF] = np.inf
    return out


def apsp_hops(adj: np.ndarray, max_steps: int | None = None) -> np.ndarray:
    """All-pairs hop distance via BLAS frontier expansion.

    Returns (N, N) float32 with inf for unreachable pairs and 0 on the diagonal.
    """
    n = adj.shape[0]
    a = (adj != 0).astype(np.float32)
    reach = np.eye(n, dtype=np.float32)
    dist = np.full((n, n), _INF, dtype=np.float32)
    np.fill_diagonal(dist, 0.0)
    steps = max_steps if max_steps is not None else n
    for step in range(1, steps + 1):
        new_reach = (reach @ a) > 0
        newly = new_reach & (dist == _INF)
        if not newly.any():
            break
        dist[newly] = step
        reach = new_reach.astype(np.float32)
        reach[dist < _INF] = 1.0  # keep everything reached so far in the frontier set
    return dist


def _is_sparse(a) -> bool:
    return hasattr(a, "tocsr")


def sparse_adjacency(adj: np.ndarray):
    """CSR (scipy sparse-array) view of a dense {0,1} adjacency, or the dense
    matrix unchanged when scipy is unavailable.  One frontier step against the
    CSR costs O(E * block) instead of O(N^2 * block) — the difference between
    seconds and minutes at N ~ 10^4."""
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover - scipy present in this image
        return (np.asarray(adj) != 0).astype(np.float32)
    # build the CSR from the 1-byte boolean mask and upcast on the sparse
    # object: peak transient is N^2 bytes, not the 4 N^2 a dense f32 copy
    # would cost (256 MiB extra at N = 8192)
    return sp.csr_array(np.asarray(adj) != 0).astype(np.float32)


def _bfs_block_int16(a, sources: np.ndarray, n: int, max_steps: int) -> np.ndarray:
    """Hop distances from each node in ``sources`` as int16 rows.

    ``a`` is a dense f32 or scipy CSR adjacency; either way ``reach @ a`` is a
    dense (block, N) ndarray, so the float working set is one row block.
    """
    m = len(sources)
    dist = np.full((m, n), INT16_INF, dtype=np.int16)
    dist[np.arange(m), sources] = 0
    reach = np.zeros((m, n), dtype=np.float32)
    reach[np.arange(m), sources] = 1.0
    for step in range(1, max_steps + 1):
        newly = (np.asarray(reach @ a) > 0) & (dist == INT16_INF)
        if not newly.any():
            break
        dist[newly] = np.int16(step)
        reach = (dist != INT16_INF).astype(np.float32)
    return dist


def apsp_hops_blocked(
    adj,
    row_block: int = 2048,
    max_steps: int | None = None,
) -> np.ndarray:
    """All-pairs hop distances, source-row-block sharded, canonical int16 out.

    The scale sibling of ``apsp_hops``: runs the frontier BFS one block of
    ``row_block`` sources at a time against a sparse adjacency, writing into
    an (N, N) int16 matrix with the ``INT16_INF`` sentinel.  Resident distance
    state is ``2 N^2`` bytes plus one ``8 * row_block * N``-byte float
    frontier — ~2.1 GiB + 512 MiB at N = 32k, versus the >= 8 bytes/pair
    (matrix + padded copy) of the dense float path.  Exact (hop counts
    identical to ``apsp_hops``) at any N below the int16 sentinel.

    Without scipy the per-block frontier falls back to dense BLAS matmuls
    (same result, same bounded memory, more FLOPs).
    """
    adj = np.asarray(adj)
    n = adj.shape[0]
    if n >= int(INT16_INF):
        raise ValueError(
            f"N = {n} >= int16 sentinel {int(INT16_INF)}: distances could "
            "overflow the canonical int16 representation"
        )
    if n == 0:
        return np.zeros((0, 0), dtype=np.int16)
    a = sparse_adjacency(adj)
    steps = max_steps if max_steps is not None else n
    out = np.empty((n, n), dtype=np.int16)
    for lo in range(0, n, row_block):
        src = np.arange(lo, min(lo + row_block, n))
        out[lo : lo + row_block] = _bfs_block_int16(a, src, n, steps)
    return out


@dataclasses.dataclass
class PathStats:
    mean: float
    diameter: float
    p50: float
    p99: float
    p9999: float
    histogram: dict[int, int]
    connected: bool

    def __str__(self) -> str:
        return (
            f"mean={self.mean:.3f} diam={self.diameter:.0f} p50={self.p50:.0f} "
            f"p99={self.p99:.0f} p99.99={self.p9999:.0f} connected={self.connected}"
        )


def path_stats(top: Topology | np.ndarray) -> PathStats:
    """Switch-to-switch shortest-path statistics over all ordered pairs.

    Above ``BLOCKED_STATS_MIN_N`` switches the APSP runs blocked/int16
    (``apsp_hops_blocked``) so Fig-4-at-scale sweeps keep the distance state
    at 2 bytes/pair instead of 8+.
    """
    adj = top.adjacency() if isinstance(top, Topology) else np.asarray(top)
    n = adj.shape[0]
    off = ~np.eye(n, dtype=bool)
    if n >= BLOCKED_STATS_MIN_N:
        vals = apsp_hops_blocked(adj)[off]
        finite = vals[vals != INT16_INF].astype(np.float64)
    else:
        vals = apsp_hops(adj)[off]
        finite = vals[np.isfinite(vals)]
    connected = finite.size == vals.size
    if finite.size == 0:
        return PathStats(np.nan, np.nan, np.nan, np.nan, np.nan, {}, connected)
    hist_keys, hist_counts = np.unique(finite.astype(np.int64), return_counts=True)
    return PathStats(
        mean=float(finite.mean()),
        diameter=float(finite.max()),
        p50=float(np.percentile(finite, 50)),
        p99=float(np.percentile(finite, 99)),
        p9999=float(np.percentile(finite, 99.99)),
        histogram={int(k): int(c) for k, c in zip(hist_keys, hist_counts)},
        connected=connected,
    )


def bollobas_diameter_bound(n: int, r: int, eps: float = 0.001) -> float:
    """Bollobás & de la Vega: diam(RRG) <= 1 + ceil(log_{r-1}((2+eps) r N log N))."""
    if r <= 2:
        return float("inf")
    val = (2.0 + eps) * r * n * np.log(n)
    return 1.0 + float(np.ceil(np.log(val) / np.log(r - 1)))
