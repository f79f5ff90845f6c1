"""Reductions over sim accumulators + the Table-1 / Fig-9 diversity counters.

The port of ``repro/sim/telemetry.py`` (numpy, unchanged).  Maps the
paper's §3 evidence onto code:

* Table 1 (path diversity): ``path_diversity`` counts, for every physical
  link, the number of distinct paths of a routing that cross it — ECMP path
  systems on a random graph leave a large fraction of links wholly unused,
  while 8-shortest-path routing covers nearly all of them.
* Fig 9 (ranked per-server throughput): ``ranked_normalized_throughput``
  sorts per-commodity delivered rate normalized by demand — the paper's
  ranked-servers x-axis — from a ``SimResult`` of ``sim.engine.simulate``.
* FCT percentiles come from the engine's log2-binned completion histogram
  (geometric-midpoint interpolation within a bin), link utilization from
  the per-step relative-load accumulator.
"""

from __future__ import annotations

import numpy as np

from ..core.routing import PathSystem
from .engine import SimResult

__all__ = [
    "event_summary",
    "fct_percentiles",
    "link_utilization",
    "path_diversity",
    "per_commodity_goodput",
    "per_commodity_throughput",
    "ranked_normalized_throughput",
    "steady_state_throughput",
]


def steady_state_throughput(res: SimResult, tail: float = 0.5) -> np.ndarray:
    """(B,) mean delivered volume per unit time over the trailing ``tail``
    fraction of the horizon (warm-up excluded)."""
    t0 = int(res.n_steps * (1.0 - tail))
    window = res.throughput[t0:]
    if len(window) == 0:
        return np.zeros(res.throughput.shape[1])
    return window.mean(axis=0) / res.dt


def per_commodity_throughput(res: SimResult) -> np.ndarray:
    """(B, K) delivered volume per unit time per commodity (dummy column of
    stacked batches dropped)."""
    k = res.demands.shape[1]
    if res.comm_delivered.shape[1] == k:  # stacked: both carry the dummy col
        k -= 1
    return res.comm_delivered[:, :k] / (res.n_steps * res.dt)


def per_commodity_goodput(res: SimResult) -> np.ndarray:
    """(B, K) delivered / offered volume per commodity (NaN where nothing
    was offered): the fraction of a commodity's admitted bytes the network
    actually carried over the run."""
    k = res.demands.shape[1]
    if res.comm_delivered.shape[1] == k:
        k -= 1
    off = res.comm_offered[:, :k]
    return np.where(off > 0, res.comm_delivered[:, :k] / np.maximum(off, 1e-12),
                    np.nan)


def ranked_normalized_throughput(
    res: SimResult, normalize: str = "offered"
) -> list[np.ndarray]:
    """Per instance: normalized per-commodity throughput, ranked ascending —
    the paper's Fig 9 curve (commodities stand in for servers; a commodity
    aggregates the server flows of one switch pair).

    ``normalize="offered"`` (default) ranks delivered / offered goodput over
    commodities that saw at least one flow — under an open-loop Poisson
    workload a commodity the sampler never picked says nothing about the
    routing.  ``normalize="demand"`` ranks delivered rate / demand instead.
    """
    if normalize == "offered":
        good = per_commodity_goodput(res)
        return [np.sort(g[np.isfinite(g)]) for g in good]
    if normalize != "demand":
        raise ValueError(f"unknown normalize mode {normalize!r}")
    rates = per_commodity_throughput(res)
    out = []
    for b in range(rates.shape[0]):
        dem = res.demands[b, : rates.shape[1]]
        live = dem > 0
        out.append(np.sort(rates[b, live] / dem[live]))
    return out


def fct_percentiles(
    res: SimResult, qs: tuple[float, ...] = (0.5, 0.9, 0.99)
) -> np.ndarray:
    """(B, len(qs)) FCT percentiles from the log2-binned histogram.

    Bin i holds completions with FCT in ``[2^i, 2^(i+1)) * dt`` (bin 0 also
    catches sub-step completions); the percentile is the geometric midpoint
    of the first bin where the cumulative count crosses q.  NaN where an
    instance completed no flows.
    """
    B, nbins = res.fct_hist.shape
    out = np.full((B, len(qs)), np.nan)
    mids = res.dt * (2.0 ** (np.arange(nbins) + 0.5))
    for b in range(B):
        total = res.fct_hist[b].sum()
        if total <= 0:
            continue
        cum = np.cumsum(res.fct_hist[b]) / total
        for qi, q in enumerate(qs):
            out[b, qi] = mids[np.searchsorted(cum, q, side="left")]
    return out


def link_utilization(res: SimResult) -> dict:
    """Per-instance utilization summary over real directed slots: mean, max,
    and the fraction of slots whose time-average load exceeds 90%."""
    util = res.util_sum / max(res.n_steps, 1)
    means, maxes, hot = [], [], []
    for b in range(util.shape[0]):
        u = util[b][res.slot_valid[b]]
        if len(u) == 0:
            means.append(0.0), maxes.append(0.0), hot.append(0.0)
            continue
        means.append(float(u.mean()))
        maxes.append(float(u.max()))
        hot.append(float((u > 0.9).mean()))
    return {"mean": means, "max": maxes, "frac_above_90": hot}


def event_summary(ev, window: int = 16) -> list[dict]:
    """Per-event impact metrics from an ``events.EventSimResult``.

    For each event boundary: **throughput retention** — mean delivered
    volume per step over the ``window`` steps after the event divided by
    the mean over the ``window`` steps before it (per instance; NaN when
    the pre-window delivered nothing); **blackholed bytes** attributed to
    the event (the blackhole accumulator's growth from this boundary to the
    next, including flows killed outright at the boundary); the migration
    counts recorded at the boundary; and **FCT degradation** — the mean FCT
    of flows completed after the event versus before it (NaN where either
    side completed none).
    """
    res = ev.result
    thr = res.throughput  # (T, B)
    B = thr.shape[1]
    out = []
    for n, rec in enumerate(ev.events):
        t = int(rec["step"])
        t_next = (
            int(ev.events[n + 1]["step"]) if n + 1 < len(ev.events)
            else res.n_steps
        )
        pre = thr[max(t - window, 0): t]
        post = thr[t: min(t + window, res.n_steps)]
        pre_m = pre.mean(axis=0) if len(pre) else np.zeros(B)
        post_m = post.mean(axis=0) if len(post) else np.zeros(B)
        retention = np.where(pre_m > 0, post_m / np.maximum(pre_m, 1e-12),
                             np.nan)
        # blackholed volume while this event's disruption was the latest one
        bh_end = (
            ev.events[n + 1]["blackholed_before"]
            if n + 1 < len(ev.events)
            else res.blackholed_total
        )
        bh_bytes = np.asarray(bh_end, np.float64) - np.asarray(
            rec["blackholed_before"], np.float64
        )
        # mean FCT before vs after the boundary (cumulative accumulators)
        s0 = np.asarray(rec["fct_sum_before"], np.float64)
        c0 = np.asarray(rec["fct_count_before"], np.float64)
        s1 = np.asarray(res.fct_sum, np.float64)
        c1 = np.asarray(res.fct_count, np.float64)
        pre_fct = np.where(c0 > 0, s0 / np.maximum(c0, 1), np.nan)
        post_fct = np.where(
            c1 > c0, (s1 - s0) / np.maximum(c1 - c0, 1), np.nan
        )
        out.append(
            {
                "step": t,
                "until": t_next,
                "kinds": list(rec["kinds"]),
                "tags": list(rec["tags"]),
                "throughput_retention": retention,
                "blackholed_bytes": bh_bytes,
                "survived": np.asarray(rec["survived"]),
                "disrupted": np.asarray(rec["disrupted"]),
                "reselected": np.asarray(rec["reselected"]),
                "killed": np.asarray(rec["killed"]),
                "fct_mean_before": pre_fct,
                "fct_mean_after": post_fct,
                "fct_degradation": np.where(
                    pre_fct > 0, post_fct / pre_fct, np.nan
                ),
            }
        )
    return out


def path_diversity(ps: PathSystem) -> dict:
    """Table-1 counters for one routing: distinct paths per physical link.

    Every path is simple, so it crosses a link at most once and a plain
    bincount of its hop edge-ids is exactly the distinct-path count.  Both
    directions of a full-duplex link are folded together (the paper counts
    physical links).  Returns per-link counts ranked descending, the
    covered-link fraction, and the per-commodity path-set sizes (the ECMP
    group sizes of an ``ecmp_path_system``).
    """
    E = ps.n_edges
    slots = np.asarray(ps.path_edges)
    valid = slots < 2 * E
    counts = (
        np.bincount(slots[valid] % E, minlength=E) if E else np.zeros(0, int)
    )
    per_comm = np.bincount(
        np.asarray(ps.path_owner), minlength=ps.n_commodities
    )
    return {
        "links_total": int(E),
        "links_covered": int((counts > 0).sum()),
        "coverage": float((counts > 0).mean()) if E else 0.0,
        "paths_per_link_ranked": np.sort(counts)[::-1],
        "paths_per_commodity": per_comm,
        "mean_paths_per_commodity": float(per_comm.mean())
        if len(per_comm)
        else 0.0,
    }
