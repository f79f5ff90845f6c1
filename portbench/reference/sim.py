"""A plain flow-level simulator: the benchmark's reference for the sim cells.

The semantics the program states for ``sim.simulate`` with a given arrival
stream (paper §5's time domain), written from their definition in plain
PyTorch, for ``B`` instances at once:

1. Arrivals.  Of ``n[t, b]`` Poisson arrivals, the first ``A`` count; the
   rest are drops.  Arrival ``a`` brings a flow of its commodity's size.
2. ``ksp_lc``: each flow takes the first of its commodity's candidate paths
   (in routing-table order) whose largest relative link load of the
   previous step is least.
3. Placement: live arrivals, in order, take the free flow slots in
   ascending order; an arrival with no free slot is a drop.
4. Rates: max-min water-filling over the flowing paths, the "fast" rule:
   each round computes every link's fair share of its remaining capacity
   among its unfrozen flows, and freezes the flows whose least share along
   the path is within 1e-6 of the smallest binding share; after the rounds
   the unfrozen flows take their least share.
5. Drains: a flow delivers ``min(remaining, rate * dt)``; a flow left with
   at most 1e-6 completes, recording its age in steps (+1 this step).

It runs in float64, or, for the control, in float32 with the link-load
products through TF32 operands (:func:`mw.to_tf32`).

Rounding decides some of the steps' discrete choices: which candidate is
least loaded when two lie within rounding of each other, and whether a
flow's remainder reaches the completion threshold.  Such a choice can go
either way in any precision, and the trajectories part after it.  So the
reference records, per instance, the first step at which a choice was that
close (``horizon``); only the steps before it are compared step for step.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.mw import to_tf32

__all__ = ["simulate_reference"]

RATE_CAP = 1e6
#: Two candidate loads closer than this (relative) can be ordered either
#: way by rounding.
TIE_REL = 1e-4
#: A remainder this close to the completion threshold can fall either side.
DONE_ABS = 1e-4


def _loads_fn(pe, n_slots, dtype, control):
    """``loads(v)[b, s]``: sum of ``v[b, p]`` over the paths through slot
    ``s`` (``pe`` is (B, P, L), padded with ``n_slots``)."""
    B, P, L = pe.shape
    if control:
        inc = torch.zeros((B, P, n_slots + 1), dtype=torch.float32,
                          device=pe.device)
        inc.scatter_(2, pe, 1.0)
        inc = inc[:, :, :n_slots].contiguous()
        return lambda v: torch.bmm(to_tf32(v)[:, None, :], inc)[:, 0]
    idx = pe.reshape(B, P * L)

    def loads(v):
        out = torch.zeros((B, n_slots + 1), dtype=dtype, device=v.device)
        out.scatter_add_(1, idx, v.repeat_interleave(L, dim=1))
        return out[:, :n_slots]

    return loads


def _waterfill(loads, pe, nflow, cap, sval, iters):
    """Per-path rates (B, P) and slot loads (B, S) by the "fast" rule."""
    B, P, L = pe.shape
    inf = torch.tensor(float("inf"), dtype=cap.dtype, device=cap.device)
    present = nflow > 1e-6
    hop_idx = pe.reshape(B, P * L)

    def share_limit(fixed, rate):
        load_fixed = loads(rate * nflow * fixed)
        cnt = loads(nflow * (1.0 - fixed))
        avail = torch.clamp_min(cap - load_fixed, 0.0)
        share = torch.where(cnt > 1e-6, avail / torch.clamp_min(cnt, 1e-9), inf)
        pad = torch.cat([share, inf.expand(B, 1)], dim=1)
        limit = torch.gather(pad, 1, hop_idx).reshape(B, P, L).amin(dim=2)
        limit = torch.clamp_max(limit, RATE_CAP)
        binding = (cnt > 1e-6) & sval & torch.isfinite(cap)
        return share, limit, binding

    fixed = torch.zeros_like(nflow)
    rate = torch.zeros_like(nflow)
    for _ in range(iters):
        share, limit, binding = share_limit(fixed, rate)
        unfixed = present & (fixed < 0.5)
        theta = torch.clamp_max(torch.where(binding, share, inf).amin(dim=1),
                                RATE_CAP)
        newly = unfixed & (limit <= theta[:, None] * (1.0 + 1e-6))
        rate = torch.where(newly, limit, rate)
        fixed = torch.where(newly, 1.0, fixed)
    _, limit, _ = share_limit(fixed, rate)
    rate = torch.where(fixed > 0.5, rate, limit)
    rate = torch.where(present, rate, 0.0)
    return rate, loads(rate * nflow)


def simulate_reference(routes, arrivals, size: float, cfg: dict,
                       control: bool = False, stale: bool = False,
                       device="cpu") -> dict:
    """Simulate ``B = len(routes)`` instances over the arrival stream
    ``(n (T, B), comm (T, B, A))`` with every flow of ``size``.

    Returns per-step ``throughput`` and ``active`` (T, B), the totals
    ``admitted``, ``drops`` (B,), ``comm_offered`` (B, K), the ``horizon``
    (B,) of comparable steps and ``full`` (B,): whether an instance ever
    had fewer free flow slots than a step's arrivals."""
    dtype = torch.float32 if control else torch.float64
    dev = torch.device(device)
    B = len(routes)
    P = max(r.n_paths for r in routes)
    L = max(r.path_edges.shape[1] for r in routes)
    S = max(r.n_slots for r in routes)
    K = max(len(r.demands) for r in routes)
    pe = np.full((B, P + 1, L), S, dtype=np.int64)
    owner = np.full((B, P + 1), K, dtype=np.int64)
    cap = np.full((B, S), np.inf)
    sval = np.zeros((B, S), dtype=bool)
    counts = np.zeros((B, K), dtype=np.int64)
    for b, r in enumerate(routes):
        pe[b, : r.n_paths, : r.path_edges.shape[1]] = np.where(
            r.path_edges >= r.n_slots, S, r.path_edges)
        owner[b, : r.n_paths] = r.path_owner
        cap[b, : r.n_slots] = 1.0
        sval[b, : r.n_slots] = True
        counts[b, : len(r.demands)] = np.bincount(r.path_owner,
                                                  minlength=len(r.demands))
    D = int(counts.max())
    rows = np.full((B, K, D), P, dtype=np.int64)
    for b, r in enumerate(routes):
        first = np.concatenate([[0], np.cumsum(counts[b, : len(r.demands)])[:-1]])
        for j in range(D):
            ok = counts[b, : len(r.demands)] > j
            rows[b, : len(r.demands)][ok, j] = first[ok] + j
    t = lambda x, dt=None: torch.as_tensor(x, device=dev, dtype=dt)  # noqa: E731
    pe_t = t(pe)
    pe_w = pe_t[:, :P]  # the waterfill's paths (the sentinel row dropped)
    loads = _loads_fn(pe_w, S, dtype, control)
    cap_t, sval_t = t(cap, dtype), t(sval)
    inv = torch.where(sval_t, 1.0 / cap_t, torch.zeros_like(cap_t))
    rows_t, cnt_t, owner_t = t(rows), t(counts), t(owner)
    n_arr, comm_arr = (t(np.asarray(x), torch.int64) for x in arrivals)
    T, _, A = comm_arr.shape
    F = cfg["max_flows"]
    ar_a, ar_d = torch.arange(A, device=dev), torch.arange(D, device=dev)
    bidx = torch.arange(B, device=dev)

    row = torch.full((B, F), P, dtype=torch.int64, device=dev)
    rem = torch.zeros((B, F), dtype=dtype, device=dev)
    age = torch.zeros((B, F), dtype=dtype, device=dev)
    rel_prev = torch.zeros((B, S), dtype=dtype, device=dev)
    rel_old = rel_prev
    fct_sum = torch.zeros(B, dtype=torch.float64, device=dev)
    fct_cnt = torch.zeros(B, dtype=torch.int64, device=dev)
    admitted = torch.zeros(B, dtype=torch.int64, device=dev)
    drops = torch.zeros(B, dtype=torch.int64, device=dev)
    offered = torch.zeros((B, K + 1), dtype=dtype, device=dev)
    horizon = torch.full((B,), T, dtype=torch.int64, device=dev)
    full = torch.zeros(B, dtype=torch.bool, device=dev)
    thr_t, act_t = [], []
    for step in range(T):
        n_p = n_arr[step]
        n_new = torch.clamp_max(n_p, A)
        drops += n_p - n_new
        comm = comm_arr[step]
        crows = rows_t[bidx[:, None], comm]  # (B, A, D)
        ccnt = cnt_t[bidx[:, None], comm]
        live = (ar_a[None, :] < n_new[:, None]) & (ccnt > 0)
        # ksp_lc: least bottleneck utilisation under last step's loads
        seen = rel_old if stale else rel_prev
        relp = torch.cat([seen, seen.new_zeros((B, 1))], dim=1)
        hops = pe_t[bidx[:, None, None], crows]  # (B, A, D, L)
        hop_util = relp[bidx[:, None, None, None], hops]
        util, arg = hop_util.max(dim=3)
        bott = torch.gather(hops, 3, arg[..., None])[..., 0]
        valid = ar_d[None, None, :] < ccnt[:, :, None]
        util = torch.where(valid, util, float("inf"))
        j = torch.argmin(util, dim=2)
        best = torch.gather(util, 2, j[..., None])
        near = valid & (util <= best * (1 + TIE_REL) + 1e-12)
        same = (util == best) & ((best == 0) | (bott == torch.gather(bott, 2, j[..., None])))
        tie = (live & (near & ~same).any(dim=2)).any(dim=1)
        horizon = torch.where(tie & (horizon == T), step, horizon)
        prow = torch.gather(crows, 2, j[..., None])[..., 0]
        # placement: the k-th live arrival takes the k-th free slot
        order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
        live = torch.gather(live, 1, order)
        prow = torch.gather(prow, 1, order)
        free = row == P
        n_free = free.sum(dim=1)
        full |= n_free < A
        target = torch.argsort((~free).to(torch.int8), dim=1, stable=True)[:, :A]
        place = live & (ar_a[None, :] < n_free[:, None])
        cur = torch.gather(row, 1, target)
        row = row.scatter(1, target, torch.where(place, prow, cur))
        cur = torch.gather(rem, 1, target)
        rem = rem.scatter(1, target, torch.where(place, size, cur))
        cur = torch.gather(age, 1, target)
        age = age.scatter(1, target, torch.where(place, 0.0, cur))
        drops += (live & ~place).sum(dim=1)
        admitted += place.sum(dim=1)
        cnew = torch.gather(owner_t, 1, prow)
        offered.scatter_add_(1, cnew, torch.where(place, size, 0.0).to(dtype))
        # rates
        active = row < P
        nflow = torch.zeros((B, P + 1), dtype=dtype, device=dev)
        nflow.scatter_add_(1, row, active.to(dtype))
        rate_p, ld = _waterfill(loads, pe_w, nflow[:, :P], cap_t, sval_t,
                                cfg["wf_iters"])
        rel = (ld * inv).to(dtype)
        # drains and completions
        r_f = torch.gather(torch.cat([rate_p, rate_p.new_zeros((B, 1))], 1), 1, row)
        delivered = torch.minimum(rem, r_f * cfg["dt"]) * active.to(dtype)
        rem = rem - delivered
        age = torch.where(active, age + 1.0, age)
        fin = active & (rem <= 1e-6)
        edge = active & ((rem - 1e-6).abs() <= DONE_ABS) & (rem != 0)
        horizon = torch.where(edge.any(dim=1) & (horizon == T), step, horizon)
        fct_sum += torch.where(fin, age, 0.0).sum(dim=1).double()
        fct_cnt += fin.sum(dim=1)
        thr_t.append(delivered.sum(dim=1))
        act_t.append((active & ~fin).sum(dim=1))
        row = torch.where(fin, P, row)
        rem = torch.where(fin, 0.0, rem)
        age = torch.where(fin, 0.0, age)
        rel_old, rel_prev = rel_prev, rel
    return {"throughput": torch.stack(thr_t).double().cpu().numpy(),
            "active": torch.stack(act_t).cpu().numpy(),
            "admitted": admitted.cpu().numpy(), "drops": drops.cpu().numpy(),
            "comm_offered": offered[:, :K].double().cpu().numpy(),
            "fct_sum": fct_sum.cpu().numpy(), "fct_count": fct_cnt.cpu().numpy(),
            "horizon": horizon.cpu().numpy(), "full": full.cpu().numpy()}
