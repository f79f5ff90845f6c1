"""Batched fluid flow-level simulator (the paper's §3/Fig 9 time domain).

The port of ``repro/sim/engine.py``.  One Python step loop of torch
operations on ``device`` advances B independent network instances —
different topology seeds, different routings, ragged shapes padded through
``core.flow.PathSystemBatch``'s masked envelope — through discrete time:

1. **Arrivals** (open loop): per step and instance, ``Poisson(rate_t)`` new
   flows (capped at ``SimConfig.max_arrivals``) sample a commodity from the
   demand distribution and a size from the elephant/mice mixture, then pick
   a path by policy — ``ecmp`` (the integer-mixing ``sim.ecmp.flow_hash``
   over the commodity's equal-cost set), ``ksp_lc`` (least-congested of the
   k candidate paths under the previous step's link loads), or ``mptcp``
   (one subflow per candidate path, size split evenly).
2. **Rate allocation**: iterative max-min waterfilling over path rows with
   flow multiplicities (``_waterfill_core``).  Its link-load inner loop is
   the congestion backends' load half, ``core.flow.make_loads_fn_batch``:
   the ordered ``gather`` fan-in tables (on CUDA the fan-in kernel, the
   ``auto`` choice on every device), or ``dense`` — the congestion kernel
   with zero prices over each member's extents on CUDA.
3. **Departures**: flows drain ``rate * dt`` of their remaining size;
   completions record FCT (log2-binned histogram + exact sum/count),
   per-commodity delivered volume, and free their slot.

Randomness.  The reference draws arrivals with ``jax.random`` keyed by
``fold_in(PRNGKey(seed), t)``; torch cannot reproduce that stream.  So
``simulate`` takes an optional pre-drawn stream (``arrivals``: Poisson
counts (T, B), commodities (T, B, A), elephant flags (T, B, A)) — the
parity tests draw it in JAX exactly as the reference's scan does.  Without
one, the port draws on the simulation's device from a ``torch.Generator``
re-seeded at every ABSOLUTE step from ``(seed, t)`` (``draw_arrivals``), so
a horizon split into segments replays the same draws.

Fixed-order sums.  Every float accumulation runs in an order fixed by
position, never through an atomic scatter-add: per-step throughput and FCT
sums fold positionally (``_fold_sum``); the per-commodity offered and
delivered volumes add each step's contributions in ascending slot order,
as XLA's CPU scatter-add applies them (``_ordered_scatter_add``).  Flow
counts and histogram bins add 1.0s, exact in any order below 2^24.

``REPRO_SIM_MAX_STEPS`` / ``REPRO_SIM_MAX_BATCH`` cap the horizon and the
batch width; both are validated at import by ``repro_torch.env``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import env, obs
from ..analysis.contracts import check_sim_state, checks_enabled
from ..analysis.registry import AuditCase, solver_entry
from ..core.flow import (
    PathSystem,
    PathSystemBatch,
    _columns,
    _fold_sum,
    _resolve_backend,
    make_loads_fn_batch,
)
from ..device import resolve
from .ecmp import flow_hash

__all__ = [
    "POLICIES",
    "SIM_MAX_STEPS",
    "SIM_MAX_BATCH",
    "SimConfig",
    "SimResult",
    "draw_arrivals",
    "simulate",
    "waterfill_rates",
]

#: Hard cap on a single run's step count, validated ONCE at import.
SIM_MAX_STEPS = env.read("REPRO_SIM_MAX_STEPS")
#: Hard cap on the instance batch width of one run.
SIM_MAX_BATCH = env.read("REPRO_SIM_MAX_BATCH")

POLICIES = ("ecmp", "ksp_lc", "mptcp")

#: Per-flow rate ceiling.  Zero-hop paths (src == dst commodities, which
#: regular traffic never produces) would otherwise waterfill to +inf and
#: NaN-poison the padded-slot shares (inf - inf) on the next round.
_RATE_CAP = 1e6

_F32 = torch.float32
_I64 = torch.int64
_MASK32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static engine knobs."""

    dt: float = 1.0  # step length in units of size / line-rate
    wf_iters: int = 12  # waterfilling rounds per step (each >= 1 bottleneck)
    wf_rule: str = "fast"  # per-step freeze rule ("fast" | "exact")
    max_flows: int = 1024  # concurrent flow slots per instance
    max_arrivals: int = 32  # Poisson arrival cap per step per instance
    nbins: int = 24  # log2-spaced FCT histogram bins
    salt: int = 0x5EED  # ECMP hash salt
    bh_rate: float = 1.0  # blackhole drain rate of a held flow (volume/step)


@dataclasses.dataclass
class SimResult:
    """Raw accumulators of one sim run (reduced by ``sim.telemetry``)."""

    throughput: np.ndarray  # (T, B) volume delivered per step
    active: np.ndarray  # (T, B) active flows after each step
    fct_hist: np.ndarray  # (B, nbins) completions per log2(FCT / dt) bin
    fct_sum: np.ndarray  # (B,) sum of completed-flow FCTs
    fct_count: np.ndarray  # (B,) completed flows
    comm_delivered: np.ndarray  # (B, K [+1]) volume delivered per commodity
    comm_offered: np.ndarray  # (B, K [+1]) volume admitted per commodity
    util_sum: np.ndarray  # (B, S) per-step relative link loads, summed
    drops: np.ndarray  # (B,) arrivals lost (slot table full / per-step cap)
    admitted: np.ndarray  # (B,) arrivals placed into a slot
    blackholed: np.ndarray  # (T, B) volume blackholed per step (held flows)
    blackholed_total: np.ndarray  # (B,) total blackholed incl. event kills
    inflight: np.ndarray  # (B,) admitted volume still undelivered at the end
    demands: np.ndarray  # (B, K [+1]) the batch's demand vectors
    slot_valid: np.ndarray  # (B, S) real-slot mask
    n_steps: int
    dt: float
    policy: str
    backend: str


# --------------------------------------------------------------------------- #
# position-ordered gathers and sums
# --------------------------------------------------------------------------- #


def _gather_cols(table: torch.Tensor, cols: list) -> list:
    """Each hop column's gather of a (B, N) table: ``cols`` holds (P,)
    indices (one table for every instance) or (B, P) ones."""
    return [table[:, c] if c.ndim == 1 else torch.gather(table, 1, c)
            for c in cols]


def _path_min_gather(share_pad: torch.Tensor, hop_cols: list) -> torch.Tensor:
    """(B, P) min over each path's hop slots of a padded (B, S+1) table,
    accumulated hop column by hop column (min is exact in any order)."""
    acc = None
    for v in _gather_cols(share_pad, hop_cols):
        acc = v if acc is None else torch.minimum(acc, v)
    return acc


def _slot_min_gather(per_path: torch.Tensor, L: int, n_slots: int,
                     slot_cols: list) -> torch.Tensor:
    """(B, S) min over each slot's crossing paths of a (B, P) per-path
    value, through the ``gather`` fan-in tables (positions per slot, padded
    with a position that gathers +inf)."""
    B = per_path.shape[0]
    fr = torch.cat([per_path.repeat_interleave(L, dim=1),
                    torch.full((B, 1), float("inf"), dtype=_F32,
                               device=per_path.device)], dim=1)
    acc = torch.full((B, n_slots), float("inf"), dtype=_F32,
                     device=per_path.device)
    for v in _gather_cols(fr, slot_cols):
        acc = torch.minimum(acc, v)
    return acc


def _ordered_scatter_add(acc: torch.Tensor, idx: torch.Tensor,
                         vals: torch.Tensor, tally: dict | None = None
                         ) -> torch.Tensor:
    """``acc[b, idx[b, m]] += vals[b, m]`` applied in ascending ``m`` order
    per target, as XLA's CPU scatter-add applies its updates, with no
    atomic race on any device.

    The non-zero updates are ranked by their position among the updates
    to the same target; each round adds the updates of one rank, so a
    target receives at most one non-zero addend a round (the others add
    +0.0, an exact identity, to whatever target they name).  Costs one
    host read of the largest rank, counted in ``tally["host_syncs"]`` when
    a tally is given.
    """
    B, M = idx.shape
    live = vals != 0
    n_acc = acc.shape[1]
    key = torch.where(live, idx, n_acc)
    skey, perm = torch.sort(key, dim=1, stable=True)
    pos = torch.arange(M, device=idx.device).expand(B, M)
    start = torch.ones_like(skey, dtype=torch.bool)
    start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first = torch.where(start, pos, 0).cummax(dim=1).values
    rank = torch.empty((B, M), dtype=_I64, device=idx.device).scatter_(
        1, perm, pos - first)
    rank = torch.where(live, rank, -1)
    n_rounds = int(rank.max()) + 1 if M else 0
    if M and tally is not None:
        tally["host_syncs"] += 1
    for r in range(n_rounds):
        sel = rank == r
        add = torch.where(sel, vals, 0.0)
        acc = acc.scatter_add(1, idx, add)  # repro-lint: disable=JF005 ordered
    return acc


# --------------------------------------------------------------------------- #
# max-min waterfilling over path rows with flow multiplicities
# --------------------------------------------------------------------------- #


@solver_entry(spec="_ir_cases_waterfill")
def _waterfill_core(loads_of, hop_cols, nflow, cap, sval, wf_iters: int,
                    slot_cols: list, rule: str = "exact"):
    """Progressive-filling max-min rates for ``nflow`` flows per path row.

    Flows on the same path row are symmetric, so state is per ROW: the
    per-flow rate of that row's flows plus a frozen mask.  Each round
    computes every link's fair share of its remaining capacity among its
    unfrozen flows (the two link-load products go through ``loads_of``)
    and every flow's limit (min share along its path), then freezes flows
    by ``rule``:

    * ``"exact"`` — every link that is **locally minimal** (all its
      unfrozen flows are limited by it) is a true max-min bottleneck, so
      ALL of its flows freeze; whole antichains of bottleneck levels
      resolve in one round.
    * ``"fast"`` — the textbook rule: freeze only the flows bottlenecked at
      the global minimum share; one level per round, cheaper rounds.

    Rows left unfrozen after ``wf_iters`` rounds take their final
    bottleneck share, which keeps the allocation feasible.  Returns
    ``(per-flow rate (B, P), loads (B, S))``.  Flow multiplicities may be
    FRACTIONAL, so presence tests use a tiny epsilon.
    """
    if rule not in ("exact", "fast"):
        raise ValueError(f"unknown waterfill rule {rule!r}")
    B, S = cap.shape[0], cap.shape[-1]
    L = len(hop_cols)
    inf_col = torch.full((B, 1), float("inf"), dtype=_F32, device=cap.device)
    inf = torch.tensor(float("inf"), dtype=_F32, device=cap.device)
    present = nflow > 1e-6

    def share_limit(fixed, rate):
        load_fixed = loads_of(rate * nflow * fixed)
        cnt = loads_of(nflow * (1.0 - fixed))
        avail = torch.clamp_min(cap - load_fixed, 0.0)
        share = torch.where(cnt > 1e-6, avail / torch.clamp_min(cnt, 1e-9),
                            inf)
        limit = _path_min_gather(torch.cat([share, inf_col], dim=1),
                                 hop_cols)
        limit = torch.clamp_max(limit, _RATE_CAP)
        binding = (cnt > 1e-6) & sval & torch.isfinite(cap)
        return share, limit, binding

    fixed = torch.zeros_like(nflow)
    rate = torch.zeros_like(nflow)
    for _ in range(wf_iters):
        share, limit, binding = share_limit(fixed, rate)
        unfixed = present & (fixed < 0.5)
        if rule == "exact":
            lim_or_inf = torch.where(unfixed, limit, inf)
            minlim = _slot_min_gather(lim_or_inf, L, S, slot_cols)
            bneck = binding & (minlim >= share * (1.0 - 1e-5))
            bshare = torch.where(bneck, share, inf)
            near = _path_min_gather(torch.cat([bshare, inf_col], dim=1),
                                    hop_cols)
            newly = (unfixed & torch.isfinite(near)
                     & (limit >= near * (1.0 - 1e-5)))
        else:
            theta = torch.clamp_max(
                torch.where(binding, share, inf).amin(dim=1), _RATE_CAP)
            newly = unfixed & (limit <= theta[:, None] * (1.0 + 1e-6))
        rate = torch.where(newly, limit, rate)
        fixed = torch.where(newly, 1.0, fixed)
    _, limit, _ = share_limit(fixed, rate)
    rate = torch.where(fixed > 0.5, rate, limit)
    rate = torch.where(present, rate, 0.0)
    return rate, loads_of(rate * nflow)


class _Tables:
    """A batch's device-side tables for the waterfill and the step loop."""

    def __init__(self, batch: PathSystemBatch, backend: str,
                 dev: torch.device):
        pe = torch.as_tensor(batch.path_edges, device=dev)
        self.pe = pe
        self.L = pe.shape[-1]
        self.hop_cols = _columns(batch.path_edges, dev)
        self.slot_cols = _columns(batch.slot_gather, dev)
        self.loads_of = make_loads_fn_batch(
            pe, batch.s_max, backend,
            batch.slot_gather if backend == "gather" else None,
            extents=None if batch.shared else (
                batch.n_paths, [ps.n_slots for ps in batch.systems]),
        )
        cap, inv, sval = _cap_arrays(batch)
        self.cap = torch.as_tensor(cap, device=dev)
        self.inv = torch.as_tensor(inv, device=dev)
        self.sval = torch.as_tensor(sval, device=dev)


def waterfill_rates(
    systems: "PathSystemBatch | Sequence[PathSystem]",
    n_flows_per_path: np.ndarray | None = None,
    wf_iters: int = 48,
    backend: str = "auto",
    rule: str = "exact",
    device: "str | torch.device" = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Max-min fair rates for a *static* flow population (no time loop).

    ``n_flows_per_path`` is a (B, <= p_max) array of persistent flows per
    path row — counts may be FRACTIONAL.  The default puts each
    commodity's demand's worth of flows on every one of its paths (the
    MPTCP-subflow saturation population).  ``backend``: ``"auto"``,
    ``"gather"`` (``auto``'s choice: the fan-in kernel on CUDA) or
    ``"dense"`` (the congestion kernel's load half on CUDA).  Returns
    ``(rates, loads)``: per-flow rate per path row (B, p_max) and
    per-directed-slot loads (B, s_max), as numpy arrays.
    """
    dev = resolve(device)
    batch = _as_batch(systems)
    B, P = batch.n_batch, batch.p_max
    if n_flows_per_path is None:
        n_flows_per_path = np.zeros((B, P), np.float32)
        for i, ps in enumerate(batch.systems):
            if ps.n_paths:
                n_flows_per_path[i, : ps.n_paths] = ps.demands[
                    np.asarray(ps.path_owner)
                ]
    nflow = np.asarray(n_flows_per_path, dtype=np.float32)
    if nflow.ndim != 2 or nflow.shape[0] != B or nflow.shape[1] > P:
        raise ValueError(
            f"n_flows_per_path must be ({B}, <= {P}); got {nflow.shape}"
        )
    if nflow.shape[1] < P:  # instance rows sit at the front of the envelope
        nflow = np.pad(nflow, ((0, 0), (0, P - nflow.shape[1])))
    backend = _resolve_backend(backend, P, batch.s_max, dev, loads_only=True)
    tabs = _Tables(batch, backend, dev)
    rate, loads = _waterfill_core(
        tabs.loads_of, tabs.hop_cols, torch.as_tensor(nflow, device=dev),
        tabs.cap, tabs.sval, wf_iters, tabs.slot_cols, rule=rule,
    )
    return rate.cpu().numpy(), loads.cpu().numpy()


# --------------------------------------------------------------------------- #
# host-side setup helpers (numpy, as in the reference)
# --------------------------------------------------------------------------- #


def _as_batch(systems) -> PathSystemBatch:
    if isinstance(systems, PathSystemBatch):
        return systems
    return PathSystemBatch.from_systems(list(systems))


def _cap_arrays(batch: PathSystemBatch):
    """(cap, inv_cap, slot_valid) as (B, S) numpy arrays (padded slots:
    inf capacity, zero inverse — they can never bind a fair share)."""
    inv = np.asarray(batch.inv_cap, np.float32)
    sval = np.asarray(batch.slot_valid)
    if inv.ndim == 1:
        inv = np.broadcast_to(inv, (batch.n_batch, inv.shape[0]))
        sval = np.broadcast_to(sval, inv.shape)
    cap = np.where(inv > 0, 1.0 / np.maximum(inv, 1e-30), np.inf).astype(
        np.float32
    )
    return cap, np.ascontiguousarray(inv), np.ascontiguousarray(sval)


def _commodity_tables(batch: PathSystemBatch, n_comm: int):
    """Per-instance commodity state for path selection, padded to the env:

    * ``rows``   (B, K, D) int32 — candidate path rows per commodity,
      padded with ``p_max`` (the engine's empty-slot sentinel);
    * ``counts`` (B, K) int32 — candidate count (ECMP group size / k);
    * ``src``/``dst`` (B, K) int32 — kept commodities' endpoint switches
      (hash inputs; commodity-index fallback when a hand-built system lacks
      pedigree).
    """
    B, P, K = batch.n_batch, batch.p_max, n_comm
    per: dict[int, tuple] = {}
    tabs, cnts, srcs, dsts = [], [], [], []
    for ps in batch.systems:
        got = per.get(id(ps))
        if got is None:
            owner = np.asarray(ps.path_owner)
            cnt = np.zeros(K, np.int32)
            if ps.n_paths:
                bc = np.bincount(owner, minlength=K)[:K]
                cnt[: len(bc)] = bc
                tab = PathSystemBatch._owner_table(owner, K, P).astype(
                    np.int32
                )
            else:
                tab = np.full((K, 1), P, np.int32)
            src = np.zeros(K, np.int32)
            dst = np.zeros(K, np.int32)
            if ps.src is not None and ps.unrouted is not None:
                kept = ~np.asarray(ps.unrouted)
                s, d = np.asarray(ps.src)[kept], np.asarray(ps.dst)[kept]
                src[: len(s)] = s.astype(np.int32)
                dst[: len(d)] = d.astype(np.int32)
            else:
                src[: ps.n_commodities] = np.arange(
                    ps.n_commodities, dtype=np.int32
                )
            got = (tab, cnt, src, dst)
            per[id(ps)] = got
        tabs.append(got[0])
        cnts.append(got[1])
        srcs.append(got[2])
        dsts.append(got[3])
    D = max(t.shape[1] for t in tabs)
    rows = np.full((B, K, D), P, np.int32)
    for i, t in enumerate(tabs):
        rows[i, :, : t.shape[1]] = t
    return (
        rows,
        np.stack(cnts),
        np.stack(srcs),
        np.stack(dsts),
    )


def _owner_padded(batch: PathSystemBatch, n_comm: int) -> np.ndarray:
    """(B, P+1) commodity of each path row; empty sentinel row -> K."""
    owner = np.asarray(batch.path_owner, np.int32)
    if owner.ndim == 1:
        owner = np.broadcast_to(owner, (batch.n_batch, owner.shape[0]))
    pad = np.full((batch.n_batch, 1), n_comm, np.int32)
    return np.concatenate([owner, pad], axis=1)


def _epoch_logits(workload, batch: PathSystemBatch, n_comm: int, n_steps: int):
    """Demand epochs -> ((E, B, K) commodity log-weights, (T,) epoch ids).

    ``-inf`` marks commodities that must never be sampled (zero demand)."""
    B, K, T = batch.n_batch, n_comm, n_steps
    de = workload.demand_epochs
    if de is None:
        de = np.asarray(batch.demands, np.float32)[None, :, :K]
        eos = np.zeros(T, np.int32)
    else:
        de = np.asarray(de, np.float32)
        if de.ndim == 2:  # (E, K) shared across instances
            de = np.broadcast_to(de[:, None, :], (de.shape[0], B, de.shape[1]))
        if de.shape[1:] != (B, K):
            raise ValueError(
                f"demand_epochs must be (E, {B}, {K}) or (E, {K}); "
                f"got {de.shape}"
            )
        if workload.epoch_of_step is None:
            raise ValueError(
                "workload sets demand_epochs but not epoch_of_step"
            )
        eos = np.asarray(workload.epoch_of_step, np.int32)
        if len(eos) != T or (len(eos) and eos.max() >= de.shape[0]):
            raise ValueError("epoch_of_step must be (T,) with values < E")
    logits = np.where(
        de > 0, np.log(np.maximum(de, 1e-30)), -np.inf
    ).astype(np.float32)
    return logits, eos


def _size_params(workload) -> np.ndarray:
    return np.asarray(
        [workload.p_elephant, workload.size_mice, workload.size_elephant],
        np.float32,
    )


def _host(x: torch.Tensor, dtype=None) -> np.ndarray:
    """A device tensor as a host numpy array (cast to ``dtype`` if given)."""
    a = x.cpu().numpy()
    return a if dtype is None else a.astype(dtype)


def _sim_result(carry: dict, inp: dict, cfg: SimConfig, n_steps: int,
                policy: str, **per_run) -> SimResult:
    """A ``SimResult`` from a finished carry; ``per_run`` holds the fields
    a caller assembles itself (the per-step series, the per-commodity
    volumes and the demands)."""
    return SimResult(
        fct_hist=_host(carry["fct_hist"])[:, : cfg.nbins],
        fct_sum=_host(carry["fct_sum"]),
        fct_count=_host(carry["fct_cnt"], np.int32),
        util_sum=_host(carry["util_sum"]),
        drops=_host(carry["drops"], np.int32),
        admitted=_host(carry["admitted"], np.int32),
        blackholed_total=_host(carry["bh_sum"]),
        inflight=_host(carry["rem"], np.float64).sum(axis=1),  # repro-lint: disable=JF005 host
        slot_valid=_host(inp["tabs"].sval),
        n_steps=n_steps,
        dt=cfg.dt,
        policy=policy,
        backend=inp["backend"],
        **per_run,
    )


def _batch_inputs(batch: PathSystemBatch, policy: str, cfg: SimConfig,
                  backend: str, dev: torch.device) -> dict:
    """Per-batch setup shared by ``simulate`` and the segmented driver
    (``sim.events``), the counterpart of the reference's ``_scan_inputs``:
    the batch-width and admission-width checks, the commodity and owner
    tables, the backend resolution and the waterfill's device tables —
    everything the step loop needs that depends only on the batch."""
    B, P, S = batch.n_batch, batch.p_max, batch.s_max
    if B > SIM_MAX_BATCH:
        raise ValueError(
            f"batch has {B} instances > REPRO_SIM_MAX_BATCH={SIM_MAX_BATCH}; "
            "raise the env cap or split the batch"
        )
    K = batch.demands.shape[1] - (0 if batch.shared else 1)
    rows_tab, rows_cnt, comm_src, comm_dst = _commodity_tables(batch, K)
    D = rows_tab.shape[-1]
    w_new = cfg.max_arrivals * D if policy == "mptcp" else cfg.max_arrivals
    if w_new > cfg.max_flows:
        raise ValueError(
            f"policy {policy!r} can admit {w_new} flows per step but "
            f"max_flows={cfg.max_flows}; raise max_flows or lower "
            "max_arrivals"
        )
    backend = _resolve_backend(backend, P, S, dev, loads_only=True)

    def dev_i64(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    return {
        "n_comm": K,
        "p_max": P,
        "backend": backend,
        "tabs": _Tables(batch, backend, dev),
        "owner_pad": dev_i64(_owner_padded(batch, K)),
        "rows_tab": dev_i64(rows_tab),
        "rows_cnt": dev_i64(rows_cnt),
        "comm_src": dev_i64(comm_src),
        "comm_dst": dev_i64(comm_dst),
    }


# --------------------------------------------------------------------------- #
# arrivals
# --------------------------------------------------------------------------- #


def _step_seed(seed: int, t: int) -> int:
    """The generator seed of absolute step ``t`` of a run seeded ``seed``:
    32 bits (the CPU generator keeps no more) mixed from both by numpy's
    ``SeedSequence``."""
    seq = np.random.SeedSequence([int(seed), int(t)])
    return int(seq.generate_state(1)[0])


def draw_arrivals(seed: int, ts, rates, logits_epochs, epoch_of_step,
                  p_elephant: float, n_arrivals: int,
                  device: "str | torch.device" = "cuda") -> tuple:
    """The port's own arrival stream: per ABSOLUTE step ``t`` of ``ts``, a
    ``torch.Generator`` on ``device`` seeded from ``(seed, t)`` draws the
    Poisson count of each instance (mean ``rates[i]``), ``n_arrivals``
    commodities from the epoch's demand weights, and the elephant flags.
    Returns ``(n_poisson (T, B), comm (T, B, A), eleph (T, B, A))`` on
    ``device``.  Instances without a commodity to draw get uniform
    weights (the step loop admits none of their arrivals)."""
    dev = resolve(device)
    logits = torch.as_tensor(np.asarray(logits_epochs), device=dev)
    B = logits.shape[1]
    has = torch.isfinite(logits).any(dim=2, keepdim=True)
    peak = torch.where(torch.isfinite(logits), logits,
                       float("-inf")).amax(dim=2, keepdim=True)
    weights = torch.where(has, torch.exp(logits - torch.where(has, peak, 0.0)),
                          1.0)
    gen = torch.Generator(device=dev)
    n_out, c_out, e_out = [], [], []
    for i, t in enumerate(np.asarray(ts).tolist()):
        gen.manual_seed(_step_seed(seed, t))
        lam = torch.full((B,), float(rates[i]), dtype=_F32, device=dev)
        n_out.append(torch.poisson(lam, generator=gen).to(_I64))
        w = weights[int(epoch_of_step[i])]
        c_out.append(torch.multinomial(w, n_arrivals, replacement=True,
                                       generator=gen))
        e_out.append(torch.rand((B, n_arrivals), generator=gen, device=dev)
                     < float(p_elephant))
    return torch.stack(n_out), torch.stack(c_out), torch.stack(e_out)


def _check_arrivals(arrivals, T: int, B: int, A: int, K: int,
                    dev: torch.device) -> tuple:
    """A caller's pre-drawn stream as device tensors, shapes validated."""
    if len(arrivals) != 3:
        raise ValueError("arrivals must be (n_poisson, comm, eleph)")
    n, c, e = (torch.as_tensor(np.asarray(x), device=dev) for x in arrivals)
    if tuple(n.shape) != (T, B) or tuple(c.shape) != (T, B, A) or \
            tuple(e.shape) != (T, B, A):
        raise ValueError(
            f"arrivals must be (T, B)=({T}, {B}), (T, B, A)=({T}, {B}, {A}) "
            f"and (T, B, A); got {tuple(n.shape)}, {tuple(c.shape)}, "
            f"{tuple(e.shape)}")
    if c.numel() and (int(c.min()) < 0 or int(c.max()) >= max(K, 1)):
        raise ValueError(f"arrival commodities must lie in [0, {K})")
    return n.to(_I64), c.to(_I64), e.to(torch.bool)


# --------------------------------------------------------------------------- #
# the step loop
# --------------------------------------------------------------------------- #


def _init_carry(n_batch: int, n_flows: int, p_max: int, s_max: int,
                n_comm: int, nbins: int, dev: torch.device) -> dict:
    """Fresh carry for a cold start (every slot empty), the reference's
    layout: ``row, rem, age, fid, hold, next_id, rel_prev, fct_hist,
    fct_sum, fct_cnt, comm_del, comm_off, util_sum, drops, admitted,
    bh_sum``.  ``fid`` and ``next_id`` hold uint32 values in int64 (torch's
    uint32 arithmetic is partial); every update masks them to 32 bits."""
    B, F = n_batch, n_flows

    def z(*shape, dtype=_F32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "row": torch.full((B, F), p_max, dtype=_I64, device=dev),
        "rem": z(B, F),
        "age": z(B, F),
        "fid": z(B, F, dtype=_I64),
        "hold": z(B, F, dtype=_I64),  # blackhole countdown
        # decorrelated flow ids per instance
        "next_id": torch.arange(B, dtype=_I64, device=dev) << 20,
        "rel_prev": z(B, s_max),
        "fct_hist": z(B, nbins + 1),  # + garbage column
        "fct_sum": z(B),
        "fct_cnt": z(B, dtype=_I64),
        "comm_del": z(B, n_comm + 1),  # + dummy column
        "comm_off": z(B, n_comm + 1),
        "util_sum": z(B, s_max),
        "drops": z(B, dtype=_I64),
        "admitted": z(B, dtype=_I64),
        "bh_sum": z(B),
    }


@solver_entry(spec="_ir_cases_run_steps")
def _run_steps(c: dict, inp: dict, logits_epochs, eos, stream, size_params,
               cfg: SimConfig, policy: str):
    """Advance the carry ``c`` through every step of ``stream`` over the
    batch tables ``inp`` (``_batch_inputs``); returns the per-step
    (throughput, active, blackholed), each (T, B).

    Counts ``sim/steps``, ``sim/loads_calls`` (calls of the loads product,
    whatever the backend) and ``sim/host_syncs`` (blocking device-to-host
    reads), each from a local tally, once a call; each step is the span
    ``sim/step`` with the children ``select``, ``place``, ``waterfill``
    and ``drain``."""
    tabs, owner_pad, P = inp["tabs"], inp["owner_pad"], inp["p_max"]
    rows_tab, rows_cnt = inp["rows_tab"], inp["rows_cnt"]
    comm_src, comm_dst = inp["comm_src"], inp["comm_dst"]
    n_poisson, comm_all, eleph_all = stream
    dev = tabs.cap.device
    T = n_poisson.shape[0]
    B, _, D = rows_tab.shape
    A = cfg.max_arrivals
    L = tabs.L
    S = tabs.cap.shape[-1]
    nbins = c["fct_hist"].shape[-1] - 1
    W_new = A * D if policy == "mptcp" else A
    dt = float(cfg.dt)
    arange_a = torch.arange(A, device=dev)
    arange_d = torch.arange(D, device=dev)
    arange_w = torch.arange(W_new, device=dev)
    has_comm_e = torch.isfinite(logits_epochs).any(dim=2)  # (E, B)
    if policy == "ksp_lc":
        pe = tabs.pe
        pe3 = pe if pe.ndim == 3 else pe[None].expand(B, P, L)
        pe_pad = torch.cat(
            [pe3, torch.full((B, 1, L), S, dtype=pe.dtype, device=dev)],
            dim=1).to(_I64)
        bidx3 = torch.arange(B, device=dev)[:, None, None]
        bidx4 = bidx3[..., None]
    p_el, size_mice, size_el = (float(x) for x in size_params)
    tally = {"loads_calls": 0, "host_syncs": 0}

    def loads_of(rates):
        tally["loads_calls"] += 1
        return tabs.loads_of(rates)

    thr_t, nact_t, bh_t = [], [], []
    for t in range(T):
        with obs.span("sim/step", t=t):
            row, rem, age, fid_c, hold = (c[k] for k in
                                          ("row", "rem", "age", "fid", "hold"))
            # ---- arrivals: Poisson count, commodity draw, size draw ------- #
            with obs.span("sim/step/select"):
                has_comm = has_comm_e[int(eos[t])]
                n_p = n_poisson[t]
                n_new = torch.where(has_comm, torch.clamp_max(n_p, A), 0)
                # arrivals past the per-step cap never materialize — count
                # them as drops so the offered load the run reports stays
                # honest
                c["drops"] = c["drops"] + torch.where(has_comm, n_p - n_new, 0)
                cand_live = arange_a[None, :] < n_new[:, None]  # (B, A)
                comm = comm_all[t]
                size = torch.where(eleph_all[t], size_el, size_mice).to(_F32)
                fid = (c["next_id"][:, None] + arange_a) & _MASK32
                c["next_id"] = (c["next_id"] + n_new) & _MASK32

                crows = torch.gather(rows_tab, 1,
                                     comm[:, :, None].expand(B, A, D))
                ccnt = torch.gather(rows_cnt, 1, comm)  # (B, A)
                cand_live = cand_live & (ccnt > 0)

                # ---- path selection --------------------------------------- #
                if policy == "ecmp":
                    csrc = torch.gather(comm_src, 1, comm)
                    cdst = torch.gather(comm_dst, 1, comm)
                    h = flow_hash(csrc, cdst, fid, cfg.salt)
                    j = torch.remainder(h, torch.clamp_min(ccnt, 1))
                    prow = torch.gather(crows, 2, j[:, :, None])[:, :, 0]
                    new_live, new_row, new_rem, new_fid = (cand_live, prow,
                                                           size, fid)
                elif policy == "ksp_lc":
                    # least-congested: bottleneck utilization of each
                    # candidate under the PREVIOUS step's loads (flow-level
                    # adaptive routing)
                    relp = torch.cat(
                        [c["rel_prev"],
                         torch.zeros((B, 1), dtype=_F32, device=dev)], dim=1)
                    hops = pe_pad[bidx3, crows]  # (B, A, D, L)
                    util = relp[bidx4, hops].amax(dim=3)
                    valid = arange_d[None, None, :] < ccnt[:, :, None]
                    util = torch.where(valid, util, float("inf"))
                    # first minimum: deterministic
                    j = torch.argmin(util, dim=2)
                    prow = torch.gather(crows, 2, j[:, :, None])[:, :, 0]
                    new_live, new_row, new_rem, new_fid = (cand_live, prow,
                                                           size, fid)
                else:  # mptcp: a subflow per candidate path, size split evenly
                    sub = arange_d[None, None, :] < ccnt[:, :, None]
                    new_live = (cand_live[:, :, None] & sub).reshape(B, W_new)
                    new_row = crows.reshape(B, W_new)
                    per = size / torch.clamp_min(ccnt, 1).to(_F32)
                    new_rem = per[:, :, None].expand(B, A, D).reshape(B, W_new)
                    # subflows share the parent's id
                    new_fid = fid[:, :, None].expand(B, A, D).reshape(B, W_new)

            # ---- place new flows into free slots (live-first packing) ----- #
            with obs.span("sim/step/place"):
                order = torch.argsort((~new_live).to(torch.int8), dim=1,
                                      stable=True)
                new_live = torch.gather(new_live, 1, order)
                new_row = torch.gather(new_row, 1, order)
                new_rem = torch.gather(new_rem, 1, order)
                new_fid = torch.gather(new_fid, 1, order)
                free = row == P
                n_free = free.sum(dim=1)  # repro-lint: disable=JF005 bool count
                # free slots first
                target = torch.argsort((~free).to(torch.int8), dim=1,
                                       stable=True)[:, :W_new]
                place = new_live & (arange_w[None, :] < n_free[:, None])

                def put(x, new):
                    """``x[b, target] = new`` where placed, else unchanged."""
                    cur = torch.gather(x, 1, target)
                    return x.scatter(1, target, torch.where(place, new, cur))

                row = put(row, new_row)
                rem = put(rem, new_rem)
                age = put(age, torch.zeros_like(new_rem))
                fid_c = put(fid_c, new_fid)
                hold = put(hold, torch.zeros_like(new_fid))
                c["drops"] = c["drops"] + (new_live & ~place).sum(dim=1)  # repro-lint: disable=JF005 bool count
                c["admitted"] = c["admitted"] + place.sum(dim=1)  # repro-lint: disable=JF005 bool count
                cnew = torch.gather(owner_pad, 1, new_row)  # (B, W_new)
                c["comm_off"] = _ordered_scatter_add(
                    c["comm_off"], cnew, torch.where(place, new_rem, 0.0),
                    tally)

            # ---- max-min waterfilling over path rows ---------------------- #
            with obs.span("sim/step/waterfill"):
                # Held flows (hold > 0) blackhole: they neither consume
                # capacity nor deliver.  Plain ``simulate`` never sets
                # ``hold``.
                active = row < P
                held = active & (hold > 0)
                flowing = active & ~held
                # flow counts add 1.0s: exact in any order below 2^24
                nflow = torch.zeros((B, P + 1), dtype=_F32, device=dev)
                nflow = nflow.scatter_add(  # repro-lint: disable=JF005 exact, see above
                    1, row, flowing.to(_F32))[:, :P]
                rate_p, loads = _waterfill_core(
                    loads_of, tabs.hop_cols, nflow, tabs.cap, tabs.sval,
                    cfg.wf_iters, tabs.slot_cols, rule=cfg.wf_rule)
                rel = loads * tabs.inv  # (B, S) relative link loads

            # ---- drain flows, record completions -------------------------- #
            with obs.span("sim/step/drain"):
                rate_pad = torch.cat([rate_p, torch.zeros((B, 1), dtype=_F32,
                                                          device=dev)], dim=1)
                r_f = torch.gather(rate_pad, 1, row)  # (B, F)
                delivered = torch.minimum(rem, r_f * dt) * flowing.to(_F32)
                bh = torch.where(held, torch.clamp_max(rem, cfg.bh_rate * dt),
                                 0.0)
                rem = rem - delivered - bh
                age = torch.where(active, age + 1.0, age)
                fin = active & (rem <= 1e-6)  # slot frees either way
                # only flows that finished delivering record FCT
                done = fin & ~held
                # _fold_sum: F is a padded axis, the sum must not depend on it
                c["fct_sum"] = c["fct_sum"] + _fold_sum(
                    torch.where(done, age * dt, 0.0))
                c["fct_cnt"] = c["fct_cnt"] + done.sum(dim=1)  # repro-lint: disable=JF005 bool count
                # floor(log2(age)) of an integer-valued age >= 1, exactly:
                # frexp's exponent.  XLA:CPU's log2 rounds 8192 and 32768
                # just below the power (checked up to 2^21), so ages of
                # exactly 8192 or 32768 steps fall one bin lower in the
                # reference; no other age differs.
                _, expo = torch.frexp(torch.clamp_min(age, 1.0))
                bins = torch.clamp(expo.to(_I64) - 1, 0, nbins - 1)
                # histogram counts add 1.0s: exact in any order below 2^24
                c["fct_hist"] = c["fct_hist"].scatter_add(  # repro-lint: disable=JF005 exact, see above
                    1, torch.where(done, bins, nbins), torch.ones_like(rem))
                cflow = torch.gather(owner_pad, 1, row)  # (B, F)
                c["comm_del"] = _ordered_scatter_add(c["comm_del"], cflow,
                                                     delivered, tally)
                c["util_sum"] = c["util_sum"] + rel
                thr_t.append(_fold_sum(delivered))
                bh_step = _fold_sum(bh)
                bh_t.append(bh_step)
                c["bh_sum"] = c["bh_sum"] + bh_step
                # in flight AFTER completions
                nact_t.append((active & ~fin).sum(dim=1))  # repro-lint: disable=JF005 bool count
                c["hold"] = torch.where(fin, 0, torch.clamp_min(hold - 1, 0))
                c["row"] = torch.where(fin, P, row)
                c["rem"] = torch.where(fin, 0.0, rem)
                c["age"] = torch.where(fin, 0.0, age)
                c["fid"] = fid_c
                c["rel_prev"] = rel
    obs.counter("sim/steps").inc(T)
    obs.counter("sim/loads_calls").inc(tally["loads_calls"])
    obs.counter("sim/host_syncs").inc(tally["host_syncs"])
    if not T:
        empty = torch.zeros((0, B), dtype=_F32, device=dev)
        return empty, empty.to(_I64), empty
    return torch.stack(thr_t), torch.stack(nact_t), torch.stack(bh_t)


@obs.spanned("sim/simulate")
def simulate(
    systems: "PathSystemBatch | Sequence[PathSystem]",
    workload,
    policy: str = "ecmp",
    config: SimConfig | None = None,
    seed: int = 0,
    backend: str = "auto",
    device: "str | torch.device" = "cuda",
    arrivals: tuple | None = None,
) -> SimResult:
    """Run the batched flow-level simulator for one workload on ``device``.

    ``systems`` is a ``PathSystemBatch`` (or a sequence of ``PathSystem``s,
    pad-and-stacked on the fly) — B independent instances advanced
    together.  ``workload`` is a ``sim.workloads.Workload``; ``policy`` is
    one of ``POLICIES``.  ``backend`` selects the congestion backend of
    the waterfilling inner loop (``auto``: ``gather``, a loads-only
    product, on every device — on CUDA the fan-in kernel; ``dense`` runs
    the congestion kernel with zero prices).

    ``arrivals`` is an optional pre-drawn stream ``(n_poisson (T, B), comm
    (T, B, A), eleph (T, B, A))`` with ``A = config.max_arrivals``; without
    one, ``draw_arrivals`` draws it from ``seed`` on ``device``.
    """
    dev = resolve(device)
    cfg = config or SimConfig()
    if policy not in POLICIES:
        raise ValueError(f"unknown sim policy {policy!r}: expected {POLICIES}")
    batch = _as_batch(systems)
    T = int(workload.n_steps)
    if T > SIM_MAX_STEPS:
        raise ValueError(
            f"workload has {T} steps > REPRO_SIM_MAX_STEPS={SIM_MAX_STEPS}; "
            "raise the env cap or split the horizon"
        )
    obs.annotate(steps=T, batch=batch.n_batch, policy=policy)
    with obs.span("sim/inputs"):
        inp = _batch_inputs(batch, policy, cfg, backend, dev)
    obs.annotate(backend=inp["backend"])
    B, K = batch.n_batch, inp["n_comm"]
    logits, eos = _epoch_logits(workload, batch, K, T)
    size_params = _size_params(workload)
    if arrivals is None:
        stream = draw_arrivals(seed, np.arange(T), workload.rate, logits, eos,
                               size_params[0], cfg.max_arrivals, device=dev)
    else:
        stream = _check_arrivals(arrivals, T, B, cfg.max_arrivals, K, dev)

    carry = _init_carry(B, cfg.max_flows, batch.p_max, batch.s_max, K,
                        cfg.nbins, dev)
    with obs.span("sim/run_steps"):
        thr, nact, bh = _run_steps(carry, inp,
                                   torch.as_tensor(logits, device=dev), eos,
                                   stream, size_params, cfg, policy)
    with obs.span("sim/result"):
        result = _sim_result(
            carry, inp, cfg, T, policy, throughput=_host(thr),
            active=_host(nact, np.int32), blackholed=_host(bh),
            comm_delivered=_host(carry["comm_del"]),
            comm_offered=_host(carry["comm_off"]),
            demands=np.asarray(batch.demands))
    if checks_enabled():
        check_sim_state(result)
    return result


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

_IR_SIM_STEPS, _IR_SIM_ARRIVALS = 4, 6

#: the sim's tallies scatter-add by design (engine.py, ``_run_steps``)
_IR_SIM_EXEMPT = {
    "JF102": "the per-commodity volumes accumulate through "
    "_ordered_scatter_add (one scatter_add round per rank, so each target "
    "gets at most one non-zero addend a round, no atomic race), and the "
    "flow counts and FCT histogram scatter-add 1.0s, exact in any order "
    "below 2^24 (the nflow and fct_hist lines of _run_steps); the "
    "congestion backend's loads go through make_loads_fn_batch(gather) "
    "(fanin.fan_in_loads) with no scatter in them",
    "JF104": "two host reads of the largest rank a step, int(rank.max()) "
    "in _ordered_scatter_add, called for comm_off and comm_del; queued in "
    "ROADMAP.md for a perf PR after a sim cell",
}


def _ir_batch() -> PathSystemBatch:
    from ..core.flow import _audit_systems

    return PathSystemBatch.from_systems(list(_audit_systems()))


def _ir_cases_waterfill():
    from ..core.flow import _IR_DENSE_EXEMPT

    def mk(backend):
        def make(dev):
            batch = _ir_batch()
            tabs = _Tables(batch, backend, dev)
            rng = np.random.default_rng(3)
            nflow = np.zeros((batch.n_batch, batch.p_max), np.float32)
            for i, ps in enumerate(batch.systems):
                nflow[i, : ps.n_paths] = rng.integers(0, 4, ps.n_paths)
            return (tabs.loads_of, tabs.hop_cols,
                    torch.as_tensor(nflow, device=dev), tabs.cap, tabs.sval,
                    4, tabs.slot_cols), {"rule": "exact"}

        return make

    return [
        AuditCase(label="gather", make=mk("gather"), backend="gather",
                  kernels=("fan_in_loads",)),
        AuditCase(label="dense", make=mk("dense"), backend="dense",
                  exempt=_IR_DENSE_EXEMPT, budget=False,
                  kernels=("congestion_batch",)),
    ]


def _ir_cases_run_steps():
    from ..core.flow import _IR_DENSE_EXEMPT
    from .workloads import steady_poisson

    def mk(backend):
        def make(dev):
            batch = _ir_batch()
            T, A = _IR_SIM_STEPS, _IR_SIM_ARRIVALS
            cfg = SimConfig(max_flows=16, max_arrivals=A, wf_iters=4,
                            wf_rule="exact", nbins=4)
            inp = _batch_inputs(batch, "ecmp", cfg, backend, dev)
            B, K = batch.n_batch, inp["n_comm"]
            workload = steady_poisson(T, rate=4.0, size=3.0)
            logits, eos = _epoch_logits(workload, batch, K, T)
            rng = np.random.default_rng(5)
            stream = _check_arrivals(
                (rng.poisson(4.0, (T, B)), rng.integers(0, K, (T, B, A)),
                 np.zeros((T, B, A), bool)), T, B, A, K, dev)
            carry = _init_carry(B, cfg.max_flows, batch.p_max, batch.s_max,
                                K, cfg.nbins, dev)
            return (carry, inp, torch.as_tensor(logits, device=dev), eos,
                    stream, _size_params(workload), cfg, "ecmp"), {}

        return make

    return [
        AuditCase(label="ecmp-gather", make=mk("gather"), backend="gather",
                  exempt=_IR_SIM_EXEMPT, kernels=("fan_in_loads",)),
        AuditCase(label="ecmp-dense", make=mk("dense"), backend="dense",
                  exempt={**_IR_DENSE_EXEMPT, **_IR_SIM_EXEMPT},
                  budget=False, kernels=("congestion_batch",)),
    ]
