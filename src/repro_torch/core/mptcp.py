"""Fluid-level MPTCP model (paper §5, Fig 8) on torch.

The port of ``repro/core/mptcp.py``.  The paper runs the MPTCP authors'
packet simulator with 8 subflows over the k=8 shortest paths and reports
flow-level normalized throughput.  The standard fluid abstraction of
coupled multipath congestion control (Kelly/Wischik): at equilibrium,
coupled MPTCP allocates rates approximately at the *proportional-fairness*
optimum over the available path system, subject to link capacities and the
sender NIC cap.

We solve   max  sum_i d_i * log(x_i)
           s.t. x_i = sum_{p in paths(i)} r_p <= d_i  (NIC cap)
                sum_{p: e in p} r_p <= c_e            (link caps)
                r >= 0

by a link-price iteration (a Python loop of torch operations on
``device``), followed by a global feasibility rescale.

The iteration's two incidence products per step — path prices ``q = B p``
and link loads ``ld = B^T r`` — go through the MW solver's congestion
closure (``core.flow.make_congestion_fn``): ``gather`` (ordered fan-in
tables) or ``dense`` (one launch of the congestion kernel a step on CUDA).
The price update uses the previous step's rates (one-step Jacobi lag), so
both products come from one pass over B.

Segment reductions over each commodity's path rows: the minimum
(``scatter_reduce(amin)``) is exact in any order; the sums (the softmin
normalization and the final per-commodity rate) run left to right over
each commodity's rows in ascending row order through the owner table
(``PathSystemBatch._owner_table``), the order XLA's CPU scatter-add applies
them in, and never through an atomic scatter-add.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..analysis.registry import AuditCase, solver_entry
from ..device import resolve
from .flow import (
    PathSystemBatch,
    _columns,
    _ordered_fan_in_sum,
    _resolve_backend,
    _warm_split,
    make_congestion_fn,
)
from .routing import PathSystem

__all__ = ["MptcpResult", "mptcp_throughput"]

_F32 = torch.float32


@dataclasses.dataclass
class MptcpResult:
    per_flow: np.ndarray  # (K,) normalized per-commodity throughput in [0, 1]
    mean_throughput: float
    jain_index: float
    iters: int
    rates: np.ndarray | None = None  # (P,) per-path rates; feeds warm starts

    def summary(self) -> str:
        return (
            f"mean={self.mean_throughput:.4f} jain={self.jain_index:.4f} "
            f"min={self.per_flow.min():.4f} max={self.per_flow.max():.4f}"
        )


def _segment_sum(x: torch.Tensor, owner_cols: list) -> torch.Tensor:
    """(K,) per-commodity sums of the (P,) ``x``, each left to right over
    the commodity's path rows in ascending row order."""
    pad = torch.zeros(1, dtype=_F32, device=x.device)
    return _ordered_fan_in_sum(torch.cat([x, pad]), owner_cols)


@solver_entry(spec="_ir_cases_pf_solve")
def _pf_solve(fused, owner, owner_cols, demands, caps, n_comm: int,
              iters: int, r_init=None):
    """Kelly-style dual (link-price) iteration for coupled multipath PF.

    Prices ``p_e`` ascend on overload; each commodity responds with total
    rate ``min(d_i, w_i / q_i)`` where ``q_i`` is the cheapest path price,
    split over near-minimum-price paths by a softmin.  Rates averaged over
    the tail half give the reported allocation, then an exact feasibility
    rescale.  Each step makes ONE fused congestion call: (ld_prev, q) =
    (B^T r_prev, B p).  Returns ``(x, r)``: per-commodity and per-path
    rates.
    """
    dev = demands.device
    E = caps.shape[0]
    P = owner.shape[0]
    K = n_comm
    inf_k = torch.full((K,), float("inf"), dtype=_F32, device=dev)
    beta0 = 0.2
    temp = 0.05  # softmin temperature over path prices

    def response(q):
        """Commodity rate response to path prices q."""
        qmin = inf_k.scatter_reduce(0, owner, q, reduce="amin")
        # commodity rate response (w_i = d_i: weighted PF, NIC-capped)
        x = torch.minimum(demands, demands / torch.clamp_min(qmin, 1e-3))
        # softmin split over that commodity's paths
        z = torch.exp(-(q - qmin[owner]) / temp)
        zsum = _segment_sum(z, owner_cols)
        return x[owner] * z / torch.clamp_min(zsum[owner], 1e-9)

    # the step sizes, float32 as the reference's scan computes them
    t = torch.arange(max(iters, 1), dtype=_F32)
    beta = (beta0 / torch.sqrt(1.0 + t)).to(dev)
    p = torch.full((E,), 0.1, dtype=_F32, device=dev)
    # seed the lagged rates with the response to the initial prices — or,
    # warm-starting from a predecessor allocation, with its mapped rates
    if r_init is None:
        _, q0 = fused(torch.zeros(P, dtype=_F32, device=dev), p)
        r_prev = response(q0)
    else:
        r_prev = r_init
    r_avg = torch.zeros(P, dtype=_F32, device=dev)
    n_avg = 0
    caps_safe = torch.clamp_min(caps, 1e-9)
    for step in range(iters):
        ld_prev, q = fused(r_prev, p)
        r = response(q)
        p = torch.clamp_min(p + beta[step] * (ld_prev - caps) / caps_safe, 0.0)
        if step >= iters // 2:  # tail averaging
            r_avg = r_avg + r
            n_avg += 1
        r_prev = r
    r = r_avg / float(max(n_avg, 1))
    # exact feasibility: globally rescale by worst overload, then re-cap NICs
    ld, _ = fused(r, torch.zeros(E, dtype=_F32, device=dev))
    scale = torch.clamp_min(torch.max(ld / caps_safe), 1.0)
    r = r / scale
    x = torch.minimum(_segment_sum(r, owner_cols), demands)
    return x, r


def _pf_operands(ps: PathSystem, backend: str, dev: torch.device) -> tuple:
    """``_pf_solve``'s operands on ``dev``: ``(fused, owner, owner_cols,
    demands, caps, n_comm)``."""
    S, K = ps.n_slots, ps.n_commodities
    pe_np = np.asarray(ps.path_edges, np.int32)
    owner_np = np.asarray(ps.path_owner)
    slot_tab = None
    if backend == "gather":
        slot_tab, _ = PathSystemBatch._slot_table(pe_np, S)
    fused = make_congestion_fn(torch.as_tensor(pe_np, device=dev), S, backend,
                               slot_tab)
    owner_tab = PathSystemBatch._owner_table(owner_np, K, ps.n_paths)
    return (
        fused,
        torch.as_tensor(owner_np.astype(np.int64), device=dev),
        _columns(owner_tab, dev),
        torch.as_tensor(np.asarray(ps.demands, np.float32), device=dev),
        torch.as_tensor(np.asarray(ps.capacities, np.float32), device=dev),
        K,
    )


def mptcp_throughput(
    ps: PathSystem,
    iters: int = 2000,
    backend: str = "auto",
    warm: "MptcpResult | np.ndarray | None" = None,
    device: "str | torch.device" = "cuda",
) -> MptcpResult:
    """Fluid MPTCP throughput on ``device``.

    ``backend``: ``"auto"`` (``ops.preferred_congestion_backend``: ``dense``
    on CUDA while the incidence fits the card's budget), ``"gather"`` or
    ``"dense"`` (the congestion kernel on CUDA).  ``warm`` seeds the price
    iteration's lagged rates from a predecessor allocation through
    ``ps.row_map`` (set by ``routing.update_path_system``), the MW solver's
    warm-start plumbing (``core.flow._warm_split``).
    """
    dev = resolve(device)
    if ps.n_paths == 0:
        return MptcpResult(np.zeros(0), 0.0, 1.0, 0, np.zeros(0))
    backend = _resolve_backend(backend, ps.n_paths, ps.n_slots, dev)
    r_init = None
    if warm is not None and ps.row_map is not None:
        prev = warm.rates if isinstance(warm, MptcpResult) else warm
        if prev is not None and len(prev):
            r_init = torch.as_tensor(_warm_split(ps, np.asarray(prev)),
                                     device=dev)
    x, r = _pf_solve(*_pf_operands(ps, backend, dev), iters, r_init)
    x = x.cpu().numpy()
    norm = x / np.maximum(ps.demands, 1e-9)
    # Jain's fairness index over per-commodity normalized throughput
    s1, s2 = norm.sum(), (norm**2).sum()  # repro-lint: disable=JF005 host float64
    jain = float((s1 ** 2) / (len(norm) * s2 + 1e-12))
    return MptcpResult(norm, float(norm.mean()), jain, iters,
                       r.cpu().numpy())


# ---- IR audit cases (python -m repro_torch.analysis ir) ------------------- #

def _ir_cases_pf_solve():
    from .flow import _IR_DENSE_EXEMPT, _audit_systems

    def mk(backend):
        def make(dev):
            operands = _pf_operands(_audit_systems()[0], backend, dev)
            return (*operands, 8), {}

        return make

    return [
        AuditCase(label="gather", make=mk("gather"), backend="gather"),
        AuditCase(label="dense", make=mk("dense"), backend="dense",
                  exempt=_IR_DENSE_EXEMPT, budget=False,
                  kernels=("congestion",)),
    ]
