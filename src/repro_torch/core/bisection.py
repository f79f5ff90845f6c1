"""Bisection-bandwidth machinery (paper §4.1, Fig 1a/1b; §4.2 Fig 6).

Three estimators, used together:

Port copy of ``repro/core/bisection.py``, carried over unchanged apart from this
note, so that seeded builds stay byte-identical to the reference.

* ``bollobas_bound``      — the paper's closed-form lower bound for RRGs:
      B >= min( (r/2 - sqrt(r ln 2)) / (k - r), 1 )
  (normalized by server bandwidth N(k-r)/2; independent of N).
* ``spectral_lower_bound`` — cut(S, V\\S) >= lambda_2 |S||V\\S| / N for any S,
  so bisection width >= lambda_2 * N / 4.  lambda_2 of the Laplacian is
  computed with deflated power iteration (the all-ones vector is the known
  top eigenvector of cI - L); matvec-heavy, mirrored by the Pallas
  ``power`` kernel on TPU.
* ``kernighan_lin_bisection`` — heuristic *upper* bound: an actual balanced
  cut found by Kernighan–Lin refinement (numpy, O(N^2) per pass).

For same-equipment comparisons (Fig 6 / LEGUP), we report KL cut width
normalized by one partition's server bandwidth, bracketing it with the
spectral lower bound.

This module also hosts the paper-§4 *binary-search* machinery
(``max_feasible`` / ``speculative_max_feasible``): the Fig 1c
``max_servers_at_full_capacity`` search spends all of its wall-clock inside
one throughput probe per bracket-halving, so the speculative driver
evaluates several levels of the bisection tree per wave — one batched
``mw_concurrent_flow_batch`` call answers every probe the next ``levels``
halvings could possibly ask — and then descends the tree with the answers
in hand.  The result is IDENTICAL to the sequential search for any
predicate (both monotone and not): the wave only precomputes the exact
probes sequential bisection would make.
"""

from __future__ import annotations

import numpy as np

from .topology import Topology

__all__ = [
    "bollobas_bound",
    "spectral_lambda2",
    "spectral_lower_bound",
    "kernighan_lin_bisection",
    "normalized_bisection",
    "max_feasible",
    "speculative_max_feasible",
]


# --------------------------------------------------------------------------- #
# feasibility binary search (paper §4: servers supported at full capacity)
# --------------------------------------------------------------------------- #


def max_feasible(lo: int, hi: int, ok) -> int:
    """Classic bisection: largest m in [lo, hi] the probe accepts.

    Maintains the invariant that ``lo`` is accepted (callers pass a known
    floor) and everything above ``hi`` is rejected; one probe per halving.
    """
    lo, hi = int(lo), int(hi)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid - 1
    return lo


def _wave_candidates(lo: int, hi: int, levels: int) -> list[int]:
    """Every midpoint the next ``levels`` bisection steps could probe."""
    cands: set[int] = set()

    def rec(l: int, h: int, d: int) -> None:
        if d == 0 or l >= h:
            return
        m = (l + h + 1) // 2
        cands.add(m)
        rec(m, h, d - 1)  # the accept branch
        rec(l, m - 1, d - 1)  # the reject branch
    rec(lo, hi, levels)
    return sorted(cands)


def speculative_max_feasible(lo: int, hi: int, ok_batch, levels: int = 2) -> int:
    """Bisection that probes in speculative waves; result identical to
    ``max_feasible`` for ANY probe, monotone or not.

    Each wave hands ``ok_batch`` every candidate the next ``levels``
    sequential halvings could ask about (at most ``2**levels - 1`` of them
    — the top of the current bisection tree) and receives per-candidate
    verdicts, then replays the sequential descent using the precomputed
    answers.  Wall-clock rounds shrink by ``levels``x; the probe count grows
    by at most ``(2**levels - 1) / levels``x, which is what the batched MW
    solver's multi-instance throughput is for.

    ``ok_batch(candidates)`` takes a sorted list of ints and returns a
    same-length sequence of bools.
    """
    lo, hi = int(lo), int(hi)
    if levels < 1:
        raise ValueError(f"levels must be >= 1, got {levels}")
    while lo < hi:
        cands = _wave_candidates(lo, hi, levels)
        verdict = dict(zip(cands, ok_batch(cands)))
        for _ in range(levels):
            if lo >= hi:
                break
            mid = (lo + hi + 1) // 2
            if verdict[mid]:
                lo = mid
            else:
                hi = mid - 1
    return lo


def bollobas_bound(k: int, r: int) -> float:
    """Paper's Eq. in §4.1: normalized bisection bandwidth lower bound."""
    if k <= r:
        raise ValueError("need k > r (some ports must host servers)")
    val = (r / 2.0 - np.sqrt(r * np.log(2.0))) / (k - r)
    return float(min(max(val, 0.0), 1.0))


def spectral_lambda2(adj: np.ndarray, iters: int = 400, seed: int = 0) -> float:
    """lambda_2 of the graph Laplacian via deflated power iteration."""
    n = adj.shape[0]
    a = adj.astype(np.float64)
    deg = a.sum(axis=1)
    c = 2.0 * deg.max() + 1.0
    # B = cI - L = cI - D + A ;  top eigvec of B is ones (eigenvalue c - 0)
    ones = np.ones(n) / np.sqrt(n)
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v -= v @ ones * ones
    v /= np.linalg.norm(v)
    lam_b = c
    for _ in range(iters):
        w = c * v - deg * v + a @ v
        w -= (w @ ones) * ones  # deflate the known top eigenvector
        nw = np.linalg.norm(w)
        if nw < 1e-14:
            break
        lam_b = v @ w
        v = w / nw
    return float(max(c - lam_b, 0.0))


def spectral_lower_bound(top: Topology) -> float:
    """Lower bound on bisection width (edge count across a balanced cut)."""
    lam2 = spectral_lambda2(top.adjacency())
    n = top.n_switches
    return lam2 * (n // 2) * (n - n // 2) / n


def _kl_pass(
    a: np.ndarray, side: np.ndarray, weights: np.ndarray
) -> tuple[np.ndarray, bool]:
    """One Kernighan–Lin pass; swaps only equal-weight node pairs so the
    SERVER balance (not the switch-count balance) is preserved — bisection
    bandwidth partitions servers, and switches hosting no servers (Clos
    spines, Jellyfish capacity-only switches) must be free to land anywhere.
    Returns (new_side, improved)."""
    n = len(side)
    # D[v] = external degree - internal degree (gain of moving v alone)
    D = np.where(side, a @ (~side) - a @ side, a @ side - a @ (~side))
    locked = np.zeros(n, dtype=bool)
    classes = np.unique(weights)
    seq: list[tuple[int, int]] = []
    gains: list[float] = []
    for _ in range(n // 2):
        best = None
        for w in classes:
            wm = weights == w
            ca = np.where(~locked & side & wm, D, -np.inf)
            cb = np.where(~locked & ~side & wm, D, -np.inf)
            ia, ib = int(np.argmax(ca)), int(np.argmax(cb))
            if np.isneginf(ca[ia]) or np.isneginf(cb[ib]):
                continue
            g = float(D[ia] + D[ib] - 2.0 * a[ia, ib])
            if best is None or g > best[0]:
                best = (g, ia, ib)
        if best is None:
            break
        g, ia, ib = best
        gains.append(g)
        seq.append((ia, ib))
        locked[ia] = locked[ib] = True
        # standard KL D update, as if (ia, ib) were swapped and removed
        D = D + np.where(side, 2.0 * a[ia] - 2.0 * a[ib], 2.0 * a[ib] - 2.0 * a[ia])
    if not seq:
        return side, False
    cum = np.cumsum(gains)
    kbest = int(np.argmax(cum))
    if cum[kbest] <= 1e-12:
        return side, False
    new_side = side.copy()
    for ia, ib in seq[: kbest + 1]:
        new_side[ia], new_side[ib] = False, True
    return new_side, True


def _server_balanced_seed(
    weights: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Random partition with (near-)equal server weight per side; weightless
    switches are split evenly by count."""
    n = len(weights)
    order = rng.permutation(n)
    side = np.zeros(n, dtype=bool)
    half_w = weights.sum() / 2.0
    half_z = int((weights == 0).sum()) // 2
    acc = 0.0
    zeros_taken = 0
    for v in order:
        if weights[v] > 0:
            if acc + weights[v] <= half_w:
                side[v] = True
                acc += weights[v]
        elif zeros_taken < half_z:
            side[v] = True
            zeros_taken += 1
    return side


def kernighan_lin_bisection(
    top: Topology, passes: int = 12, seed: int = 0, restarts: int = 3
) -> tuple[float, np.ndarray]:
    """Server-balanced min-cut via Kernighan–Lin; returns (cut, side_mask)."""
    a = top.adjacency(dtype=np.float64)
    weights = top.servers_per_switch.astype(np.float64)
    best_cut, best_side = np.inf, None
    rng = np.random.default_rng(seed)
    for _ in range(restarts):
        side = _server_balanced_seed(weights, rng)
        for _ in range(passes):
            side, improved = _kl_pass(a, side, weights)
            if not improved:
                break
        cut = float(a[np.ix_(side, ~side)].sum())
        if cut < best_cut:
            best_cut, best_side = cut, side.copy()
    return best_cut, best_side


def normalized_bisection(top: Topology, method: str = "kl") -> float:
    """Bisection bandwidth normalized by one partition's server line rate."""
    servers = top.servers_per_switch
    if method == "kl":
        cut, side = kernighan_lin_bisection(top)
        denom = min(servers[side].sum(), servers[~side].sum())
        denom = max(denom, servers.sum() / 2.0 if servers.sum() else 1.0)
    elif method == "spectral":
        cut = spectral_lower_bound(top)
        denom = servers.sum() / 2.0
    else:
        raise ValueError(method)
    if denom == 0:
        return float("inf")
    return float(min(cut / denom, 10.0))
