"""Maximum concurrent flow over a k-shortest-path system (paper §4).

The port of ``repro/core/flow.py``.  Two solvers over an explicit path
system:

* ``lp_concurrent_flow`` — exact LP (scipy/HiGHS), the oracle; host code
  carried over verbatim.
* ``mw_concurrent_flow`` / ``mw_concurrent_flow_batch`` — the
  multiplicative-weights (mirror-descent) iteration minimizing the smoothed
  max edge load, on ``device``.  Each ``lax.scan`` of the reference becomes
  a Python loop of torch operations and kernel launches; the recurrence is
  the reference's, step for step (same anneal, same one-step price lag, same
  exact alpha bookkeeping, same window-wise adaptive stop).

Congestion backends
-------------------
Each MW iteration needs ``loads = B^T r`` and ``costs = B w`` (B the {0,1}
path x directed-slot incidence):

* ``gather`` — no materialized B.  Slot loads come from the transposed
  fan-in tables of ``PathSystemBatch`` (for every slot, the flat positions
  of the path hops crossing it), summed LEFT-TO-RIGHT in flat-position
  order by ``_ordered_fan_in_sum``; path costs from per-hop-column gathers
  folded by the positional halving tree.  That is the reference's
  ``scatter``/``gather`` arithmetic exactly, in the same order.
* ``dense`` — materializes B once and calls ``kernels.ops.congestion``: the
  hand-written fused kernel on CUDA (one read of B per iteration and batch
  member), the plain torch product on the CPU.  Reassociation drift against
  ``gather`` is ~1e-4 in alpha after the anneal, as in the reference.

There is no ``scatter`` backend: on CUDA, torch's ``index_add_`` and
``scatter_add_`` are atomics, whose order of addition is not fixed, and the
MW anneal amplifies single-ulp load differences into visible alpha drift.
Every sum of the solver (loads, the per-commodity split normalization, the
softmax denominator, path costs) therefore runs in an order fixed by
position: the ordered fan-in tables or the ``_fold_sum`` halving tree.

``backend="auto"`` picks via ``kernels.ops.preferred_congestion_backend``
(size + device): ``dense`` on CUDA while the stacked incidence fits the
card's budget, ``gather`` beyond it and for CPU batches; a loads-only
product (``make_loads_fn_batch``'s callers) is ``gather`` everywhere, on
CUDA through the fan-in kernel.

Batched solves
--------------
``PathSystemBatch`` pads B path systems to a common (P, L, S, K) envelope
(padded slots carry zero inverse capacity and are masked out of the softmax;
padded path rows belong to a zero-demand dummy commodity) and
``mw_concurrent_flow_batch`` runs the recurrence over the stack, with
per-instance adaptive stops.  The sequential solver runs the same
recurrence on one unpadded instance, so a batched solve equals the
sequential one bit for bit under ``gather`` (CT-batch): every sum is
padding-invariant by construction.

``REPRO_LP_PATH_LIMIT`` (validated at import) moves the ``throughput()``
LP-vs-MW cutoff from its 20000-path default.
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Sequence

import numpy as np
import torch

from .. import env
from .. import obs
from ..analysis.registry import AuditCase, solver_entry
from ..analysis.contracts import check_path_system_batch, checks_enabled
from ..device import resolve
from ..kernels import ops
from ..kernels.fanin import fan_in_loads, fan_in_table
from .routing import PathSystem

__all__ = [
    "FlowResult",
    "PathSystemBatch",
    "dense_incidence",
    "make_congestion_fn",
    "make_congestion_fn_batch",
    "make_loads_fn_batch",
    "mw_concurrent_flow",
    "mw_concurrent_flow_batch",
    "lp_concurrent_flow",
    "lp_edge_concurrent_flow",
    "throughput",
    "LP_PATH_LIMIT",
]


#: throughput()'s auto dispatch solves instances with at most this many path
#: variables exactly.  Validated ONCE at import through the registry.
LP_PATH_LIMIT = env.read("REPRO_LP_PATH_LIMIT")

_F32 = torch.float32


@dataclasses.dataclass
class FlowResult:
    alpha: float  # max concurrent fraction: every commodity ships alpha * d_i
    rates: np.ndarray  # (P,) per-path rates of the feasible scaled solution
    max_load: float  # max relative edge load of the *unscaled* routing
    method: str
    iters: int = 0

    def normalized_throughput(self) -> float:
        """Per-server normalized throughput, capped at line rate (<= 1)."""
        return float(min(self.alpha, 1.0))


# --------------------------------------------------------------------------- #
# position-ordered sums
# --------------------------------------------------------------------------- #


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis by positional halving.

    A positional halving tree is PADDING-INVARIANT: pad to a power of two
    and fold, and any all-zero half merges as an exact identity, so the
    grouping of the real elements depends only on their positions.  Both
    the sequential and the batched solver sum through this, which keeps
    padded batches bit-identical to sequential solves.
    """
    n = x.shape[-1]
    if n == 0:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    pow2 = 1 << (n - 1).bit_length() if n > 1 else 1
    if pow2 != n:
        x = torch.nn.functional.pad(x, (0, pow2 - n))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _path_cost_gather(pr_pad: torch.Tensor, cols_idx: list) -> torch.Tensor:
    """Per-path price sums: one gather per hop column, halved positionally.

    ``pr_pad`` is (S + 1,) or (Bt, S + 1) prices with a trailing zero (the
    padding sentinel gathers it); ``cols_idx`` holds the path table's hop
    columns as int64 tensors, each (P,) (one table for every instance) or
    (Bt, P).  The halving tree over the column list is the grouping
    ``_fold_sum`` applies along the hop axis, so the sum is padding-invariant
    in L.
    """
    cols = []
    for idx in cols_idx:
        if idx.ndim == 1:
            cols.append(pr_pad[..., idx])
        else:
            cols.append(torch.gather(pr_pad, 1, idx))
    L = len(cols)
    pow2 = 1 << (L - 1).bit_length() if L > 1 else 1
    if pow2 != L:
        zero = torch.zeros_like(cols[0])
        cols = cols + [zero] * (pow2 - L)
    while len(cols) > 1:
        h = len(cols) // 2
        cols = [cols[i] + cols[i + h] for i in range(h)]
    return cols[0]


def _ordered_fan_in_sum(fr: torch.Tensor, table_cols: list) -> torch.Tensor:
    """Sum ``fr`` entries selected by a fan-in table, LEFT-TO-RIGHT.

    ``fr`` is (N + 1,) or (Bt, N + 1) with a trailing zero pad;
    ``table_cols`` holds the table's D columns as int64 tensors, each (S,)
    (one table for every instance) or (Bt, S), listing one segment's
    members in ascending position order, padded with N.  The columns are
    accumulated one by one, so each segment's sum associates exactly like
    the reference's scatter-add (updates applied in position order), with
    no atomics on any device.
    """
    acc = None
    for idx in table_cols:
        v = fr[..., idx] if idx.ndim == 1 else torch.gather(fr, 1, idx)
        acc = v if acc is None else acc + v
    return acc


def _columns(table: np.ndarray, device: torch.device) -> list:
    """A (.., S, D) index table as D contiguous int64 device tensors."""
    t = torch.as_tensor(np.ascontiguousarray(table), device=device)
    return [t[..., j].to(torch.int64).contiguous() for j in range(t.shape[-1])]


def _masked_softmax(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with ``-inf`` masking and a fold-sum
    denominator (padding-invariant, unlike a library softmax)."""
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.where(torch.isfinite(logits), torch.exp(logits - m), 0.0)
    return e / _fold_sum(e)[..., None]


def dense_incidence(path_edges: torch.Tensor, n_slots: int) -> torch.Tensor:
    """(P, S) {0,1} incidence from the padded path-edge table.

    Entries at or beyond ``n_slots`` (the padding sentinel) are dropped.
    Built one hop column at a time: within a column every path row appears
    once, so no index repeats inside one write and the counts are exact.
    """
    P, L = path_edges.shape
    b = torch.zeros((P, n_slots), dtype=_F32, device=path_edges.device)
    _fill_incidence(b, path_edges, n_slots)
    return b


def _stacked_incidence(path_edges: torch.Tensor,
                       n_slots: int) -> torch.Tensor:
    """(Bt, P, S) {0,1} incidences of a (Bt, P, L) stack of path tables."""
    b3 = torch.zeros(path_edges.shape[:2] + (n_slots,), dtype=_F32,
                     device=path_edges.device)
    for i in range(path_edges.shape[0]):
        _fill_incidence(b3[i], path_edges[i], n_slots)
    return b3


def _fill_incidence(out: torch.Tensor, path_edges: torch.Tensor,
                    n_slots: int) -> None:
    rows = torch.arange(path_edges.shape[0], device=path_edges.device)
    for j in range(path_edges.shape[1]):
        col = path_edges[:, j].to(torch.int64)
        keep = col < n_slots
        r, c = rows[keep], col[keep]
        out[r, c] = out[r, c] + 1.0


# --------------------------------------------------------------------------- #
# congestion closures
# --------------------------------------------------------------------------- #

#: The span around every closure the three factories below return: the
#: program's own label of a congestion product, whatever its backend.
_CONGESTION = "kernels/congestion"


def make_congestion_fn(  # repro-lint: disable=JF100 builds fused, run by entries
    path_edges: torch.Tensor,
    n_slots: int,
    backend: str,
    slot_gather: np.ndarray | None = None,
):
    """Fused (loads, costs) = (B^T r, B w) closure for ONE instance.

    ``path_edges`` is the (P, L) table on the solve's device; the closure
    maps (P,) rates and (S,) prices to (S,) loads and (P,) costs.
    ``gather`` needs the instance's (S, D) fan-in table (``slot_gather``,
    from ``PathSystemBatch._slot_table``); ``dense`` materializes B once and
    calls ``ops.congestion`` (the CUDA kernel on a GPU).
    """
    dev = path_edges.device
    P, L = path_edges.shape
    if backend == "gather":
        if slot_gather is None:
            raise ValueError("gather backend needs the slot fan-in table")
        tab = _columns(slot_gather, dev)
        hop_cols = _columns(path_edges.cpu().numpy(), dev)
        pad = torch.zeros(1, dtype=_F32, device=dev)

        def fused(rates, prices):
            fr = torch.cat([rates.repeat_interleave(L), pad])
            loads = _ordered_fan_in_sum(fr, tab)
            if loads is None:
                loads = torch.zeros(n_slots, dtype=_F32, device=dev)
            costs = _path_cost_gather(torch.cat([prices, pad]), hop_cols)
            return loads, costs

        return obs.spanned(_CONGESTION)(fused)
    if backend != "dense":
        raise ValueError(f"unknown congestion backend: {backend!r}")
    b = dense_incidence(path_edges, n_slots)

    def fused(rates, prices):
        return ops.congestion(b, rates, prices)

    return obs.spanned(_CONGESTION)(fused)


def make_congestion_fn_batch(  # repro-lint: disable=JF100 builds fused, run by entries
    path_edges: torch.Tensor,
    n_slots: int,
    n_batch: int,
    backend: str,
    slot_gather: np.ndarray | None = None,
    extents: tuple | None = None,
):
    """Batched fused (loads, costs) closure over a stack of path systems.

    ``path_edges`` is (Bt, P, L) — or (P, L) for the shared-topology fast
    path, where all instances route over one table and only rates and
    prices vary.  The closure maps (Bt, P) rates and (Bt, S) prices to
    (Bt, S) loads and (Bt, P) costs:

    * ``gather`` — per-slot transposed fan-in tables (``slot_gather``,
      precomputed by ``PathSystemBatch``) accumulated left-to-right
      (``_ordered_fan_in_sum``), the same order as the single-instance
      closure, which keeps batched solves at bit parity with sequential
      ones.
    * ``dense`` — the stacked rank-3 (Bt, P, S) incidence, materialized
      once, through ``ops.congestion``: one fused kernel launch per
      iteration for the whole stack on CUDA, over each member's real
      ``extents=(n_paths, n_slots)`` when given (exact: see
      ``kernels.congestion.congestion``).  Shared tables use two plain
      matrix products over one B.
    """
    dev = path_edges.device
    shared = path_edges.ndim == 2
    L = path_edges.shape[-1]
    if backend == "gather":
        if slot_gather is None:
            raise ValueError(
                "gather backend needs the PathSystemBatch fan-in tables"
            )
        tab = _columns(slot_gather, dev)
        hop_cols = _columns(path_edges.cpu().numpy(), dev)
        pad = torch.zeros((n_batch, 1), dtype=_F32, device=dev)

        def fused(rates, prices):
            fr = torch.cat([rates.repeat_interleave(L, dim=1), pad], dim=1)
            loads = _ordered_fan_in_sum(fr, tab)
            if loads is None:
                loads = torch.zeros((n_batch, n_slots), dtype=_F32, device=dev)
            costs = _path_cost_gather(torch.cat([prices, pad], dim=1),
                                      hop_cols)
            return loads, costs

        return obs.spanned(_CONGESTION)(fused)
    if backend != "dense":
        raise ValueError(f"unknown congestion backend: {backend!r}")
    if shared:
        b = dense_incidence(path_edges, n_slots)  # (P, S)

        def fused(rates, prices):
            return rates @ b, prices @ b.T

        return obs.spanned(_CONGESTION)(fused)
    b3 = _stacked_incidence(path_edges, n_slots)

    def fused(rates, prices):
        return ops.congestion(b3, rates, prices, extents)

    return obs.spanned(_CONGESTION)(fused)


def make_loads_fn_batch(  # repro-lint: disable=JF100 builds loads_of, run by entries
    path_edges: torch.Tensor,
    n_slots: int,
    backend: str,
    slot_gather: np.ndarray | None = None,
    extents: tuple | None = None,
):
    """Loads-only ``B^T r`` batched closure — the congestion backends' load
    half, for inner loops that never consume path costs.

    The flow-level simulator's waterfilling (``repro_torch.sim.engine``)
    needs per-slot loads and flow counts but no ``B w`` product.  The
    closure maps (Bt, P) rates to (Bt, S) loads:

    * ``gather`` — the fan-in tables, transposed once to (Bt, D, S), summed
      left to right by ``fanin.fan_in_loads`` (the fan-in kernel on CUDA,
      one launch a call; on the CPU the arithmetic of
      ``_ordered_fan_in_sum``), the reference's scatter-add order, equal bit
      for bit to ``make_congestion_fn_batch``'s loads half; slots past a
      member's ``extents`` load exact zeros;
    * ``dense`` — the stacked (Bt, P, S) incidence through
      ``ops.congestion_loads`` (the congestion kernel on CUDA, zero
      prices), over each member's real ``extents=(n_paths, n_slots)`` when
      given; a shared (P, L) table is one plain matrix product.
    """
    shared = path_edges.ndim == 2
    dev = path_edges.device
    if backend == "gather":
        if slot_gather is None:
            raise ValueError(
                "gather backend needs the PathSystemBatch fan-in tables"
            )
        L = path_edges.shape[-1]
        tab = fan_in_table(slot_gather, dev)
        slots = None if extents is None else extents[1]

        def loads_fn(rates):
            return fan_in_loads(tab, rates, L, slots)

        return obs.spanned(_CONGESTION)(loads_fn)
    if backend != "dense":
        raise ValueError(f"unknown congestion backend: {backend!r}")
    if shared:
        b = dense_incidence(path_edges, n_slots)

        def loads_fn(rates):
            return rates @ b

        return obs.spanned(_CONGESTION)(loads_fn)
    b3 = _stacked_incidence(path_edges, n_slots)

    def loads_fn(rates):
        return ops.congestion_loads(b3, rates, extents)

    return obs.spanned(_CONGESTION)(loads_fn)


def _resolve_backend(
    backend: str, n_paths: int, n_slots: int, device: torch.device,
    n_batch: int = 1, loads_only: bool = False,
) -> str:
    if backend == "auto":
        backend = ops.preferred_congestion_backend(
            n_paths, n_slots, n_batch=n_batch, device=device,
            loads_only=loads_only,
        )
        obs.counter(f"flow/backend/{backend}").inc()
        return backend
    if backend not in ("gather", "dense"):
        raise ValueError(
            f"unknown congestion backend {backend!r}: expected auto, gather "
            "or dense"
        )
    return backend


# --------------------------------------------------------------------------- #
# the MW recurrence (shared by the sequential and the batched solver)
# --------------------------------------------------------------------------- #


def _schedule(iters: int, device: torch.device) -> tuple:
    """Per-step anneal fraction and step size over the full ``iters``
    horizon, in float32, computed on the host once and moved to ``device``
    (so every device and both solvers see the same values):

        frac[t] = 0.2 * (0.005 / 0.2) ** (t / iters)   (geometric anneal)
        eta[t]  = 2 / sqrt(1 + t)                       (step decay)
    """
    t = torch.arange(max(iters, 1), dtype=_F32)
    frac = 0.2 * torch.pow(torch.tensor(0.005 / 0.2, dtype=_F32), t / iters)
    eta = 2.0 / torch.sqrt(1.0 + t)
    return frac.to(device), eta.to(device)


def _make_seg_norm(owner: torch.Tensor, owner_cols: list, dummy: bool):
    """Per-commodity normalization of split weights from the ordered path-row
    table: each commodity's sum runs left-to-right in row order (the
    reference's scatter-add association).  With ``dummy`` (a stacked batch)
    the dummy commodity's divisor is pinned to 1: its padded rows feed
    nothing real."""

    def seg_norm(x):
        pad = torch.zeros(x.shape[:-1] + (1,), dtype=_F32, device=x.device)
        s = _ordered_fan_in_sum(torch.cat([x, pad], dim=-1), owner_cols)
        if dummy:
            s = torch.cat([s, torch.ones_like(pad)], dim=-1)
        if owner.ndim == 1:
            return x / s[..., owner]
        return x / torch.gather(s, 1, owner)

    return seg_norm


@solver_entry(spec="_ir_cases_mw_steps")
def _mw_steps(fused, seg_norm, carry, t_lo, t_hi, dem, inv, slot_valid,
              frac, eta, active=None):
    """Steps ``t_lo .. t_hi - 1`` of the lagged MW recurrence.

    Rank-generic: the sequential solver passes (P,)/(S,) tensors, the batch
    (Bt, P)/(Bt, S) with ``slot_valid`` masking padded slots out of the
    softmax and ``active`` freezing converged instances bit-exactly.
    """
    x, rel_prev, best_alpha, best_x = carry
    neg_inf = torch.tensor(float("-inf"), dtype=_F32, device=x.device)
    for t in range(t_lo, t_hi):
        # softmax weights from the PREVIOUS iterate's loads (one-step lag) so
        # the fused kernel computes this iterate's loads and the gradient's
        # path costs in a single pass over B; rel_prev = 0 at t = 0 gives
        # uniform weights
        mx_prev = rel_prev.amax(dim=-1)
        tau = torch.clamp_min(mx_prev, 1e-12) * frac[t]
        logits = rel_prev / tau[..., None]
        if slot_valid is not None:
            logits = torch.where(slot_valid, logits, neg_inf)
        w = _masked_softmax(logits)
        rates = x * dem
        loads, costs = fused(rates, w * inv)
        rel = loads * inv  # relative load per directed slot (exact)
        mx = rel.amax(dim=-1)
        alpha = 1.0 / torch.clamp_min(mx, 1e-12)
        take = alpha > best_alpha
        if active is not None:
            take = take & active
        best_alpha = torch.where(take, alpha, best_alpha)
        best_x = torch.where(take[..., None], x, best_x)
        g = costs * dem
        g = g / torch.clamp_min(g.amax(dim=-1, keepdim=True), 1e-12)
        x_next = seg_norm(x * torch.exp(-eta[t] * g))
        if active is None:
            x, rel_prev = x_next, rel
        else:
            x = torch.where(active[:, None], x_next, x)
            rel_prev = torch.where(active[:, None], rel, rel_prev)
    return x, rel_prev, best_alpha, best_x


@solver_entry(spec="_ir_cases_mw_final")
def _mw_final(fused, carry, dem, inv):
    """One exact evaluation of the last iterate, then the best-iterate
    result: ``(best_alpha, best_rates, 1 / best_alpha)``."""
    x, _, best_alpha, best_x = carry
    zero_prices = torch.zeros(x.shape[:-1] + inv.shape[-1:], dtype=_F32,
                              device=x.device)
    loads, _ = fused(x * dem, zero_prices)
    mx = (loads * inv).amax(dim=-1)
    alpha = 1.0 / torch.clamp_min(mx, 1e-12)
    better = alpha > best_alpha
    best_alpha = torch.where(better, alpha, best_alpha)
    best_x = torch.where(better[..., None], x, best_x)
    best_rates = best_x * dem * torch.clamp_max(best_alpha, 1.0)[..., None]
    return best_alpha, best_rates, 1.0 / best_alpha


def _warm_split(ps: PathSystem, warm: "FlowResult | np.ndarray") -> np.ndarray:
    """Initial per-path split from a predecessor flow vector via ``row_map``
    (host numpy, as in the reference).  Fresh rows get a floor share of
    their commodity: MW updates are multiplicative, so a hard zero could
    never recover."""
    rates = warm.rates if isinstance(warm, FlowResult) else np.asarray(warm)
    x0 = np.ones(ps.n_paths, dtype=np.float32)
    rm = ps.row_map
    if rm is None or len(rates) == 0:
        return x0
    ok = (rm >= 0) & (rm < len(rates))
    x0 = np.where(ok, rates[np.clip(rm, 0, len(rates) - 1)], 0.0).astype(np.float32)
    ssum = np.bincount(ps.path_owner, weights=x0, minlength=ps.n_commodities)
    cnt = np.bincount(ps.path_owner, minlength=ps.n_commodities)
    mean = (ssum / np.maximum(cnt, 1)).astype(np.float32)
    floor = np.where(mean[ps.path_owner] > 0, 0.05 * mean[ps.path_owner], 1.0)
    return np.maximum(x0, floor)


def _adaptive_done(best: float, state: dict, target_alpha, early_stop,
                   rel_tol, patience) -> str | None:
    """The reference's between-window stop decision for one instance;
    returns the stop reason or None to go on."""
    if target_alpha is not None and best >= target_alpha:
        return "target"
    if early_stop:
        if best - state["best_prev"] < rel_tol * max(best, 1e-12):
            state["stall"] += 1
            if state["stall"] >= patience:
                return "plateau"
        else:
            state["stall"] = 0
        state["best_prev"] = max(best, state["best_prev"])
    return None


def _seq_setup(ps: PathSystem, backend: str, x_init: np.ndarray,
               dev: torch.device) -> tuple:
    """A sequential solve's operands on ``dev``: ``(fused, seg_norm, carry,
    dem, inv_cap)``, the carry started from the split ``x_init``."""
    S, K = ps.n_slots, ps.n_commodities
    pe = torch.as_tensor(np.asarray(ps.path_edges, np.int32), device=dev)
    owner = torch.as_tensor(np.asarray(ps.path_owner, np.int64), device=dev)
    demands = torch.as_tensor(np.asarray(ps.demands, np.float32), device=dev)
    inv_cap = torch.as_tensor(
        np.asarray(1.0 / ps.capacities, dtype=np.float32), device=dev
    )
    slot_tab = None
    if backend == "gather":
        slot_tab, _ = PathSystemBatch._slot_table(np.asarray(ps.path_edges), S)
    owner_tab = PathSystemBatch._owner_table(
        np.asarray(ps.path_owner), K, ps.n_paths
    )
    fused = make_congestion_fn(pe, S, backend, slot_tab)
    seg_norm = _make_seg_norm(owner, _columns(owner_tab, dev), dummy=False)
    x0 = seg_norm(torch.as_tensor(x_init, dtype=_F32, device=dev))
    carry = (x0, torch.zeros_like(inv_cap),
             torch.tensor(0.0, dtype=_F32, device=dev), x0)
    return fused, seg_norm, carry, demands[owner], inv_cap


@obs.spanned("mw/solve")
def mw_concurrent_flow(
    ps: PathSystem,
    iters: int = 400,
    backend: str = "auto",
    warm: "FlowResult | np.ndarray | None" = None,
    early_stop: bool = False,
    check_every: int = 50,
    rel_tol: float = 1e-3,
    patience: int = 2,
    target_alpha: float | None = None,
    device: "str | torch.device" = "cuda",
) -> FlowResult:
    """MW/mirror-descent max concurrent flow on ``device``.

    ``backend``: ``"auto"`` (size/device dispatch), ``"gather"`` or
    ``"dense"`` (incidence through ``ops.congestion``: the fused CUDA kernel
    on a GPU).

    ``warm``: a FlowResult (or raw per-path rate vector) from the
    predecessor path system of a delta update; requires ``ps.row_map``.

    Adaptive iteration count: with ``early_stop=True`` the solve runs in
    ``check_every``-iteration windows and stops once the best alpha has
    improved by less than ``rel_tol`` (relative) for ``patience``
    consecutive windows; ``target_alpha`` stops as soon as the best (exactly
    evaluated) alpha reaches it.  The anneal stays pinned to the full
    ``iters`` horizon, so a run that never stops early equals
    ``early_stop=False``.  ``FlowResult.iters`` reports the iterations run.
    """
    dev = resolve(device)
    if ps.n_paths == 0:
        return FlowResult(0.0, np.zeros(0), np.inf, "mw", 0)
    backend = _resolve_backend(backend, ps.n_paths, ps.n_slots, dev)
    warm_start = warm is not None and ps.row_map is not None
    obs.annotate(paths=ps.n_paths, backend=backend, warm=warm_start)
    if warm_start:
        x_init = _warm_split(ps, warm)
    else:
        x_init = np.ones(ps.n_paths, dtype=np.float32)
    fused, seg_norm, carry, dem, inv_cap = _seq_setup(ps, backend, x_init,
                                                       dev)
    frac, eta = _schedule(iters, dev)
    adaptive = early_stop or target_alpha is not None
    if not adaptive:
        carry = _mw_steps(fused, seg_norm, carry, 0, iters, dem, inv_cap,
                          None, frac, eta)
        done = iters
    else:
        done = 0
        state = {"best_prev": 0.0, "stall": 0}
        stop_reason = "budget"
        while done < iters:
            step = min(check_every, iters - done)
            with obs.span("mw/window", t0=done, step=step):
                carry = _mw_steps(fused, seg_norm, carry, done, done + step,
                                  dem, inv_cap, None, frac, eta)
                done += step
                best = float(carry[2])  # best alpha so far (exact evals)
            obs.counter("mw/windows").inc()
            obs.counter_event("mw/alpha", best)
            reason = _adaptive_done(best, state, target_alpha, early_stop,
                                    rel_tol, patience)
            if reason is not None:
                stop_reason = reason
                break
        obs.counter(f"mw/stop/{stop_reason}").inc()
    alpha, rates, max_load = _mw_final(fused, carry, dem, inv_cap)
    res = FlowResult(
        float(alpha), rates.cpu().numpy(), float(max_load), f"mw-{backend}",
        done,
    )
    obs.annotate(iters=done)
    obs.counter("mw/solves").inc()
    obs.counter("mw/iters").inc(done)
    obs.gauge("mw/alpha").set(res.alpha)
    return res


# --------------------------------------------------------------------------- #
# Batched multi-instance MW solver
# --------------------------------------------------------------------------- #


def _bucket_up(n: int, step: int) -> int:
    """Round ``n`` up to a multiple of ``step``."""
    return max(((int(n) + step - 1) // step) * step, step)


def _bucket_up_geom(n: int) -> int:
    """Scale-proportional shape bucket: the step is ~n/8 (at least 256)."""
    n = max(int(n), 1)
    step = max(256, 1 << max(n.bit_length() - 3, 0))
    return _bucket_up(n, step)


@dataclasses.dataclass
class PathSystemBatch:
    """Pad-and-stack of B independent path systems for one batched MW solve.

    Instances are padded to the common (P_max, L_max, S_max, K_max)
    envelope, exactly as in the reference:

    * padded SLOTS carry zero inverse capacity and are masked out of the
      softmax via ``slot_valid``;
    * padded PATH rows belong to a dummy commodity (index K_max) with zero
      demand;
    * an instance's own padding sentinel (its ``n_slots``) lands on one of
      its padded slots or, for the widest instance, on the shared garbage
      slot.

    ``from_shared`` stores ONE (P, L) path table and per-instance demands.

    Construction also precomputes the transposed fan-in tables of the
    ``gather`` backend: ``slot_gather[.., s, :]`` holds the flat positions
    (``p * L + l``) of every real path hop crossing slot s, and
    ``owner_gather[.., k, :]`` the path rows of commodity k, both padded
    with a sentinel that gathers a zero.  The port always builds them (it
    has no scatter path to fall back on), and also uses the owner table for
    the per-commodity normalization under ``dense``.  Arrays are host numpy;
    the solver moves them to its device.
    """

    path_edges: np.ndarray  # (B, P, L) int32 — or (P, L) when shared
    path_owner: np.ndarray  # (B, P) int32 — or (P,) when shared
    demands: np.ndarray  # (B, K [+ 1 dummy when stacked]) f32
    inv_cap: np.ndarray  # (B, S) f32, 0 on padded slots — or (S,) shared
    slot_valid: np.ndarray  # (B, S) bool — or (S,) all-True shared
    n_paths: np.ndarray  # (B,) true per-instance path counts
    systems: list  # the original PathSystem objects (result slicing, warm)
    shared: bool = False
    slot_gather: np.ndarray | None = None  # (B, S, D) int32 — or (S, D)
    owner_gather: np.ndarray | None = None  # (B, K, D2) int32 — or (K, D2)

    @property
    def n_batch(self) -> int:
        return len(self.systems)

    @property
    def p_max(self) -> int:
        return self.path_edges.shape[-2]

    @property
    def s_max(self) -> int:
        return self.inv_cap.shape[-1]

    @staticmethod
    def _slot_table(pe2d: np.ndarray, n_slots: int) -> tuple[np.ndarray, np.ndarray]:
        """(positions-by-slot ragged table as (tab, counts)) for ONE instance.

        ``pe2d`` is that instance's (P, L) padded slot matrix; positions are
        flat ``p * L + l`` indices into the row-major hop array.  Entries at
        or beyond ``n_slots`` (padding sentinels) are excluded.
        """
        flat = pe2d.reshape(-1)
        valid = flat < n_slots
        slots = flat[valid]
        pos = np.flatnonzero(valid)
        order = np.argsort(slots, kind="stable")
        slots_s = slots[order]
        cnt = np.bincount(slots_s, minlength=n_slots)
        d = int(cnt.max()) if n_slots else 0
        if d == 0:
            return np.zeros((n_slots, 0), np.int32), cnt
        col = np.arange(len(slots_s)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        tab = np.full((n_slots, d), pe2d.size, dtype=np.int32)
        tab[slots_s, col] = pos[order]
        return tab, cnt

    @staticmethod
    def _owner_table(owner: np.ndarray, n_comm: int, n_rows: int) -> np.ndarray:
        """(K, D2) path-row table for ONE instance's real commodities."""
        order = np.argsort(owner, kind="stable")
        cnt = np.bincount(owner, minlength=n_comm)
        d = int(cnt.max()) if n_comm else 0
        tab = np.full((n_comm, max(d, 1)), n_rows, dtype=np.int32)
        if d:
            col = np.arange(len(owner)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            tab[owner[order], col] = order
        return tab

    @classmethod
    def from_systems(
        cls, systems: "Sequence[PathSystem]", bucket: bool = True
    ) -> "PathSystemBatch":
        """Stack B (possibly ragged) path systems; empty instances allowed.

        ``bucket=True`` (default) rounds the common envelope up to the
        reference's coarse shape buckets.  All padding is masked, so
        bucketing never changes results.
        """
        systems = list(systems)
        if not systems:
            raise ValueError("PathSystemBatch needs at least one path system")
        B = len(systems)
        P = max(max((ps.n_paths for ps in systems), default=0), 1)
        L = max(
            max(
                (ps.path_edges.shape[1] for ps in systems if ps.n_paths),
                default=1,
            ),
            1,
        )
        S = max(max((ps.n_slots for ps in systems), default=0), 1)
        K = max(ps.n_commodities for ps in systems)
        if bucket:
            P, L, S, K = (
                _bucket_up_geom(P),
                _bucket_up(L, 4),
                _bucket_up_geom(S),
                _bucket_up_geom(K),
            )
        pe = np.empty((B, P, L), dtype=np.int32)
        owner = np.full((B, P), K, dtype=np.int32)  # dummy commodity
        dem = np.zeros((B, K + 1), dtype=np.float32)
        inv = np.zeros((B, S), dtype=np.float32)
        sval = np.zeros((B, S), dtype=bool)
        for i, ps in enumerate(systems):
            pe[i, :, :] = ps.n_slots  # instance's own padding sentinel
            if ps.n_paths:
                pb, lb = ps.path_edges.shape
                pe[i, :pb, :lb] = ps.path_edges
                owner[i, :pb] = ps.path_owner
            dem[i, : ps.n_commodities] = ps.demands
            if ps.n_slots:
                inv[i, : ps.n_slots] = 1.0 / ps.capacities
                sval[i, : ps.n_slots] = True
        # transposed fan-in tables (positions use the COMMON (P, L) layout)
        per = [cls._slot_table(pe[i], ps.n_slots) for i, ps in enumerate(systems)]
        d = max((t.shape[1] for t, _ in per), default=0)
        if bucket:
            d = _bucket_up(max(d, 1), 8)
        slot_tab = np.full((B, S, max(d, 1)), P * L, dtype=np.int32)
        for i, (t, _) in enumerate(per):
            slot_tab[i, : t.shape[0], : t.shape[1]] = t
        otabs = [
            cls._owner_table(np.asarray(ps.path_owner), ps.n_commodities, P)
            if ps.n_paths
            else None
            for ps in systems
        ]
        d2 = max((t.shape[1] for t in otabs if t is not None), default=1)
        if bucket:
            d2 = _bucket_up(d2, 4)
        owner_tab = np.full((B, K, d2), P, dtype=np.int32)
        for i, t in enumerate(otabs):
            if t is not None:
                owner_tab[i, : t.shape[0], : t.shape[1]] = t
        batch = cls(
            path_edges=pe,
            path_owner=owner,
            demands=dem,
            inv_cap=inv,
            slot_valid=sval,
            n_paths=np.array([ps.n_paths for ps in systems], dtype=np.int64),
            systems=systems,
            slot_gather=slot_tab,
            owner_gather=owner_tab,
        )
        if checks_enabled():
            check_path_system_batch(batch, name="from_systems")
        return batch

    @classmethod
    def from_shared(
        cls, ps: PathSystem, demands: np.ndarray
    ) -> "PathSystemBatch":
        """B instances over ONE path system, differing only in demands.

        ``demands`` is (B, n_commodities); the path table, owners, and
        capacities are stored once and broadcast by the solver.
        """
        dem = np.ascontiguousarray(np.asarray(demands, dtype=np.float32))
        if dem.ndim != 2 or dem.shape[1] != ps.n_commodities:
            raise ValueError(
                f"shared-batch demands must be (B, {ps.n_commodities}); "
                f"got {dem.shape}"
            )
        S = max(ps.n_slots, 1)
        inv = np.zeros(S, dtype=np.float32)
        sval = np.zeros(S, dtype=bool)
        if ps.n_slots:
            inv[: ps.n_slots] = 1.0 / ps.capacities
            sval[: ps.n_slots] = True
        pe = np.asarray(ps.path_edges, dtype=np.int32)
        owner = np.asarray(ps.path_owner, dtype=np.int32)
        slot_tab: np.ndarray | None = None
        owner_tab: np.ndarray | None = None
        if ps.n_paths:
            tab, _ = cls._slot_table(pe, ps.n_slots)
            slot_tab = np.full((S, max(tab.shape[1], 1)), pe.size,
                               dtype=np.int32)
            slot_tab[: tab.shape[0], : tab.shape[1]] = tab
            owner_tab = cls._owner_table(owner, ps.n_commodities, ps.n_paths)
        batch = cls(
            path_edges=pe,
            path_owner=owner,
            demands=dem,
            inv_cap=inv,
            slot_valid=sval,
            n_paths=np.full(dem.shape[0], ps.n_paths, dtype=np.int64),
            systems=[ps] * dem.shape[0],
            shared=True,
            slot_gather=slot_tab,
            owner_gather=owner_tab,
        )
        if checks_enabled():
            check_path_system_batch(batch, name="from_shared")
        return batch


def _empty_path_system() -> PathSystem:
    """Zero-path filler instance for batch-size bucketing (inactive from the
    first window; its result row is dropped before returning)."""
    return PathSystem(
        n_edges=0,
        path_edges=np.zeros((0, 1), dtype=np.int32),
        path_len=np.zeros(0, dtype=np.int32),
        path_owner=np.zeros(0, dtype=np.int32),
        demands=np.zeros(0, dtype=np.float32),
        capacities=np.zeros(0, dtype=np.float32),
        n_commodities=0,
    )


def _batch_setup(batch: PathSystemBatch, backend: str, x_init: np.ndarray,
                 dev: torch.device) -> tuple:
    """A batched solve's operands on ``dev``: ``(fused, seg_norm, carry,
    dem, inv_cap, slot_valid)``, the carry started from the (B, P) split
    ``x_init``."""
    B = batch.n_batch
    pe = torch.as_tensor(batch.path_edges, device=dev)
    owner = torch.as_tensor(batch.path_owner.astype(np.int64), device=dev)
    demands = torch.as_tensor(batch.demands, device=dev)
    inv_cap = torch.as_tensor(batch.inv_cap, device=dev)
    slot_valid = torch.as_tensor(batch.slot_valid, device=dev)
    if not batch.shared:
        dem = torch.gather(demands, 1, owner)
    else:
        dem = demands[:, owner]
        inv_cap = inv_cap[None, :]
        slot_valid = slot_valid[None, :]
    fused = make_congestion_fn_batch(
        pe, batch.s_max, B, backend,
        batch.slot_gather if backend == "gather" else None,
        extents=None if batch.shared else (
            batch.n_paths, [ps.n_slots for ps in batch.systems]),
    )
    seg_norm = _make_seg_norm(owner, _columns(batch.owner_gather, dev),
                              dummy=not batch.shared)
    x0 = seg_norm(torch.as_tensor(x_init, device=dev))
    carry = (
        x0,
        torch.zeros((B, batch.s_max), dtype=_F32, device=dev),
        torch.zeros(B, dtype=_F32, device=dev),
        x0,
    )
    return fused, seg_norm, carry, dem, inv_cap, slot_valid


@obs.spanned("mw/solve_batch")
def mw_concurrent_flow_batch(
    systems: "PathSystemBatch | Sequence[PathSystem]",
    iters: int = 400,
    backend: str = "auto",
    warm: "Sequence[FlowResult | np.ndarray | None] | None" = None,
    early_stop: bool = False,
    check_every: int = 50,
    rel_tol: float = 1e-3,
    patience: int = 2,
    target_alpha: float | None = None,
    device: "str | torch.device" = "cuda",
) -> list[FlowResult]:
    """Solve B independent MW instances together on ``device``.

    Accepts a ``PathSystemBatch`` or any sequence of ``PathSystem``s (padded
    and stacked on the fly, the batch size bucketed to a multiple of 4 with
    empty fillers as in the reference).  Per-instance results equal
    ``mw_concurrent_flow`` with the same arguments bit for bit under
    ``gather``, and the adaptive state (plateau early-stop, ``target_alpha``)
    is tracked PER INSTANCE: a converged instance's carry is frozen
    bit-exactly while the rest of the batch runs on.

    ``backend``: ``"auto"`` (dense on CUDA while the stack fits the card's
    budget, gather otherwise and on CPU), ``"gather"`` or ``"dense"``.
    """
    dev = resolve(device)
    n_asked: int | None = None
    if isinstance(systems, PathSystemBatch):
        batch = systems
    else:
        systems = list(systems)
        n_asked = len(systems)
        pad_b = _bucket_up(n_asked, 4) if n_asked > 1 else n_asked
        if pad_b != n_asked:
            systems = systems + [
                _empty_path_system() for _ in range(pad_b - n_asked)
            ]
        batch = PathSystemBatch.from_systems(systems)
    B = batch.n_batch
    empty = batch.n_paths == 0
    method_tag = "mw-batch"
    if bool(empty.all()):
        out = [FlowResult(0.0, np.zeros(0), np.inf, method_tag, 0)
               for _ in range(B)]
        return out if n_asked is None else out[:n_asked]
    # max(B, 2): even a B=1 batch wants the BATCH backend policy
    backend = _resolve_backend(backend, batch.p_max, batch.s_max, dev,
                               n_batch=max(B, 2))
    method_tag = f"mw-batch-{backend}"
    members = int((~empty).sum())  # repro-lint: disable=JF005 bool count
    obs.annotate(members=members, backend=backend, warm=warm is not None)
    x_init = np.ones((B, batch.p_max), dtype=np.float32)
    if warm is not None:
        for i, (ps, w) in enumerate(zip(batch.systems, warm)):
            if w is not None and ps.row_map is not None and ps.n_paths:
                x_init[i, : ps.n_paths] = _warm_split(ps, w)
    fused, seg_norm, carry, dem, inv_cap, slot_valid = _batch_setup(
        batch, backend, x_init, dev)
    frac, eta = _schedule(iters, dev)
    done = np.zeros(B, dtype=np.int64)
    active = ~empty
    adaptive = early_stop or target_alpha is not None
    if not adaptive:
        carry = _mw_steps(fused, seg_norm, carry, 0, iters, dem, inv_cap,
                          slot_valid, frac, eta,
                          torch.as_tensor(active, device=dev))
        done[active] = iters
    else:
        states = [{"best_prev": 0.0, "stall": 0} for _ in range(B)]
        t0 = 0
        while t0 < iters and active.any():
            step = min(check_every, iters - t0)
            with obs.span("mw/window_batch", t0=t0, step=step,
                          active=int(active.sum())):  # repro-lint: disable=JF005 bool count
                carry = _mw_steps(fused, seg_norm, carry, t0, t0 + step, dem,
                                  inv_cap, slot_valid, frac, eta,
                                  torch.as_tensor(active, device=dev))
                t0 += step
                done[active] += step
                best = carry[2].cpu().numpy()
            obs.counter("mw/windows_batch").inc()
            if obs.trace_enabled():
                obs.counter_event("mw/alpha_batch_mean",
                                  float(best[active].mean()))
            for b in np.flatnonzero(active):
                # identical decision sequence to mw_concurrent_flow's window
                # loop, applied per instance
                reason = _adaptive_done(float(best[b]), states[b],
                                        target_alpha, early_stop, rel_tol,
                                        patience)
                if reason is not None:
                    active[b] = False
                    obs.counter(f"mw/stop/{reason}").inc()
        if active.any():
            n_left = int(active.sum())  # repro-lint: disable=JF005 bool count
            obs.counter("mw/stop/budget").inc(n_left)
    alpha, rates, max_load = _mw_final(fused, carry, dem, inv_cap)
    alpha = alpha.cpu().numpy()
    rates = rates.cpu().numpy()
    max_load = max_load.cpu().numpy()
    member_iters = int(done.sum())  # repro-lint: disable=JF005 int count
    obs.annotate(iters=int(done.max()), member_iters=member_iters)
    obs.counter("mw/solves").inc(members)
    obs.counter("mw/iters").inc(member_iters)
    out = []
    for b in range(B):
        if empty[b]:
            out.append(FlowResult(0.0, np.zeros(0), np.inf, method_tag, 0))
        else:
            nb = int(batch.n_paths[b])
            out.append(
                FlowResult(
                    float(alpha[b]), rates[b, :nb].copy(),
                    float(max_load[b]), method_tag, int(done[b]),
                )
            )
    return out if n_asked is None else out[:n_asked]


# --------------------------------------------------------------------------- #
# Exact LP solver (scipy / HiGHS), host code carried over verbatim
# --------------------------------------------------------------------------- #


def lp_concurrent_flow(ps: PathSystem, alpha_cap: float = 8.0) -> FlowResult:
    """Exact max concurrent flow restricted to the path system."""
    import scipy.sparse as sp
    from scipy.optimize import linprog

    P = ps.n_paths
    if P == 0:
        return FlowResult(0.0, np.zeros(0), np.inf, "lp")
    E, K = ps.n_slots, ps.n_commodities
    # COO assembly in three vectorized strips:
    #   directed-slot capacity rows — one entry per real hop,
    #   commodity rows (alpha * d_i - sum_p r_p <= 0),
    #   the alpha column.
    lens = ps.path_len.astype(np.int64)
    hop_mask = np.arange(ps.path_edges.shape[1])[None, :] < lens[:, None]
    rows = np.concatenate(
        [
            ps.path_edges[hop_mask].astype(np.int64),  # row-major: path order
            E + ps.path_owner.astype(np.int64),
            E + np.arange(K, dtype=np.int64),
        ]
    )
    cols = np.concatenate(
        [
            np.repeat(np.arange(P, dtype=np.int64), lens),
            np.arange(P, dtype=np.int64),
            np.full(K, P, dtype=np.int64),
        ]
    )
    vals = np.concatenate(
        [
            np.ones(int(lens.sum())),  # repro-lint: disable=JF005 integer sum
            -np.ones(P),
            ps.demands.astype(np.float64),
        ]
    )
    A = sp.coo_matrix((vals, (rows, cols)), shape=(E + K, P + 1)).tocsr()
    b = np.concatenate([ps.capacities.astype(np.float64), np.zeros(K)])
    c = np.zeros(P + 1)
    c[P] = -1.0
    bounds = [(0, None)] * P + [(0, alpha_cap)]
    res = linprog(c, A_ub=A, b_ub=b, bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"LP failed: {res.message}")
    alpha = float(res.x[P])
    rates = res.x[:P] * min(1.0, alpha) / max(alpha, 1e-12)
    return FlowResult(alpha, rates, 1.0 / max(alpha, 1e-12), "lp")


def lp_edge_concurrent_flow(top, comm, alpha_cap: float = 8.0) -> float:
    """Edge-formulation exact max concurrent flow (small instances only).

    Used in tests to validate that the path system (k paths, bounded slack)
    is rich enough.  Variables: per-commodity directed edge flows.
    """
    import scipy.sparse as sp
    from scipy.optimize import linprog

    N = top.n_switches
    E2 = 2 * top.n_edges  # directed copies (full-duplex: unit cap per direction)
    K = comm.k
    src = np.asarray(comm.src, dtype=np.int64)
    dst = np.asarray(comm.dst, dtype=np.int64)
    dem = np.asarray(comm.demand, dtype=np.float64)
    # directed edge list
    de = np.concatenate([top.edges, top.edges[:, ::-1]], axis=0)  # (E2, 2)
    nvar = K * E2 + 1
    # flow conservation per commodity per node: row i*N + v holds
    # sum_out - sum_in - alpha*d*(v==src_i) + alpha*d*(v==dst_i) = 0.
    # Assembled with index arithmetic over the (commodity x directed-edge)
    # grid — the per-commodity flatnonzero scans were O(K * N * E2).
    i_rep = np.repeat(np.arange(K, dtype=np.int64), E2)
    ee = np.tile(np.arange(E2, dtype=np.int64), K)
    var_cols = i_rep * E2 + ee
    out_rows = i_rep * N + np.tile(de[:, 0].astype(np.int64), K)
    in_rows = i_rep * N + np.tile(de[:, 1].astype(np.int64), K)
    # alpha-column entries: -d at the source row, +d at the destination row
    # (destination only when distinct, matching the src-first branch order)
    ndd = dst != src
    rows = np.concatenate(
        [out_rows, in_rows, np.arange(K) * N + src, np.arange(K)[ndd] * N + dst[ndd]]
    )
    n_dd = int(ndd.sum())  # repro-lint: disable=JF005 bool count
    cols = np.concatenate(
        [var_cols, var_cols,
         np.full(K, nvar - 1, dtype=np.int64),
         np.full(n_dd, nvar - 1, dtype=np.int64)]
    )
    vals = np.concatenate(
        [np.ones(K * E2), -np.ones(K * E2), -dem, dem[ndd]]
    )
    Aeq = sp.coo_matrix((vals, (rows, cols)), shape=(K * N, nvar)).tocsr()
    beq = np.zeros(K * N)
    # capacity rows: each DIRECTED edge has unit capacity (full duplex)
    A_ub = sp.coo_matrix(
        (np.ones(K * E2), (ee, var_cols)), shape=(E2, nvar)
    ).tocsr()
    b_ub = np.ones(E2)
    c = np.zeros(nvar)
    c[-1] = -1.0
    bounds = [(0, None)] * (nvar - 1) + [(0, alpha_cap)]
    res = linprog(
        c, A_ub=A_ub, b_ub=b_ub, A_eq=Aeq, b_eq=np.asarray(beq), bounds=bounds,
        method="highs",
    )
    if not res.success:
        raise RuntimeError(f"edge LP failed: {res.message}")
    return float(res.x[-1])


# LP failures worth falling back from: our own "LP failed" RuntimeError,
# scipy/HiGHS input rejections (ValueError), and a missing scipy entirely.
_LP_FALLBACK_ERRORS = (RuntimeError, ValueError, ImportError)


def throughput(ps: PathSystem, method: str = "auto", iters: int = 400,
               device: "str | torch.device" = "cuda") -> FlowResult:
    """Concurrent-flow throughput with automatic solver selection.

    ``auto`` dispatches to the exact LP at or below ``LP_PATH_LIMIT`` path
    variables (20000 by default; override with ``REPRO_LP_PATH_LIMIT``) and
    to the MW solver on ``device`` beyond it.
    """
    if method == "lp" or (method == "auto" and ps.n_paths <= LP_PATH_LIMIT):
        try:
            return lp_concurrent_flow(ps)
        except _LP_FALLBACK_ERRORS as exc:
            warnings.warn(
                f"LP solver failed ({type(exc).__name__}: {exc}); "
                "falling back to the MW solver",
                RuntimeWarning,
                stacklevel=2,
            )
            return mw_concurrent_flow(ps, iters=iters, device=device)
    return mw_concurrent_flow(ps, iters=iters, device=device)


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

_IR_ITERS, _IR_STEPS = 10, 4  # anneal horizon, steps run by a case

_IR_DENSE_EXEMPT = {
    "JF101": "dense backend contracts through the incidence product by "
    "design (the congestion kernel on CUDA, the plain product on the CPU); "
    "its reassociation drift against gather is a documented contract "
    "(CG-3), not a bug",
}


@functools.cache
def _audit_systems() -> tuple:
    """Two tiny seeded path systems (Jellyfish of 12 and 10 switches, 5
    ports, 3 network links each; k = 3 paths of a random permutation),
    built on the CPU once: the audit cases' shared inputs."""
    from .jellyfish import jellyfish
    from .routing import build_path_system
    from .traffic import random_permutation_traffic

    out = []
    for n, seed in ((12, 1), (10, 2)):
        top = jellyfish(n, 5, 3, seed=seed)
        comm = random_permutation_traffic(top, seed=seed + 7)
        out.append(build_path_system(top, comm, k=3, device="cpu"))
    return tuple(out)


def _ir_split(n_rows, seed: int) -> np.ndarray:
    """A seeded positive start split (uniform in [0.5, 1.5))."""
    return np.random.default_rng(seed).uniform(
        0.5, 1.5, n_rows).astype(np.float32)


def _ir_seq(dev: torch.device, backend: str) -> tuple:
    """``_mw_steps`` arguments over the first audit system, as
    ``mw_concurrent_flow`` builds them."""
    ps = _audit_systems()[0]
    fused, seg_norm, carry, dem, inv = _seq_setup(
        ps, backend, _ir_split(ps.n_paths, 0), dev)
    frac, eta = _schedule(_IR_ITERS, dev)
    return fused, seg_norm, carry, dem, inv, None, frac, eta, None


def _ir_batch(dev: torch.device, backend: str) -> tuple:
    """``_mw_steps`` arguments over both audit systems stacked, as
    ``mw_concurrent_flow_batch`` builds them."""
    batch = PathSystemBatch.from_systems(list(_audit_systems()))
    x_init = np.ones((batch.n_batch, batch.p_max), np.float32)
    for i, ps in enumerate(batch.systems):
        x_init[i, : ps.n_paths] = _ir_split(ps.n_paths, i)
    fused, seg_norm, carry, dem, inv, sval = _batch_setup(batch, backend,
                                                          x_init, dev)
    frac, eta = _schedule(_IR_ITERS, dev)
    return (fused, seg_norm, carry, dem, inv, sval, frac, eta,
            torch.ones(batch.n_batch, dtype=torch.bool, device=dev))


def _ir_cases_mw_steps():
    def mk(setup, backend):
        def make(dev):
            (fused, seg_norm, carry, dem, inv, sval, frac, eta,
             active) = setup(dev, backend)
            return (fused, seg_norm, carry, 0, _IR_STEPS, dem, inv, sval,
                    frac, eta, active), {}

        return make

    return [
        AuditCase(label="seq-gather", make=mk(_ir_seq, "gather"),
                  backend="gather"),
        AuditCase(label="seq-dense", make=mk(_ir_seq, "dense"),
                  backend="dense", exempt=_IR_DENSE_EXEMPT, budget=False,
                  kernels=("congestion",)),
        AuditCase(label="batch-gather", make=mk(_ir_batch, "gather"),
                  backend="gather"),
        AuditCase(label="batch-dense", make=mk(_ir_batch, "dense"),
                  backend="dense", exempt=_IR_DENSE_EXEMPT, budget=False,
                  kernels=("congestion_batch",)),
    ]


def _ir_cases_mw_final():
    def mk(setup, backend):
        def make(dev):
            fused, _, carry, dem, inv, *_ = setup(dev, backend)
            return (fused, carry, dem, inv), {}

        return make

    return [
        AuditCase(label="seq-gather", make=mk(_ir_seq, "gather"),
                  backend="gather"),
        AuditCase(label="batch-gather", make=mk(_ir_batch, "gather"),
                  backend="gather"),
        AuditCase(label="batch-dense", make=mk(_ir_batch, "dense"),
                  backend="dense", exempt=_IR_DENSE_EXEMPT, budget=False,
                  kernels=("congestion_batch",)),
    ]
