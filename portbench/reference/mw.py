"""Plain multiplicative-weights max concurrent flow: the benchmark's reference.

The recurrence the program states for its MW solver (paper §4's throughput
by mirror descent on the smoothed maximum link load), written from its
definition in plain PyTorch:

* anneal ``frac[t] = 0.2 * 0.025 ** (t / iters)``, step ``eta[t] = 2 /
  sqrt(1 + t)``;
* slot prices: a softmax of the previous iterate's relative loads at
  temperature ``max(rel) * frac[t]`` (uniform at ``t = 0``);
* loads ``B^T (x d)`` and path costs ``B (w / c)`` of the incidence ``B``;
* the exact alpha ``1 / max(rel)`` of every iterate; the best one is kept;
* ``x <- normalize_per_commodity(x * exp(-eta[t] * g / max(g)))`` with ``g``
  the costs times the path's demand;
* with a target, the solve stops at the end of the first 50-iteration
  window whose best alpha reaches it; the last iterate is evaluated once
  more, and the result's rates are ``best_x * d * min(alpha, 1)``.

``mw_reference`` runs it in float64 (the yardstick) or, for the control, in
float32 with every product through :func:`to_tf32` operands (the tensor
cores' TF32 input rounding).  ``achieved_alpha`` is the concurrent flow a
rate vector really carries on a routing table, computed in float64.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["achieved_alpha", "mw_reference", "shortfall", "to_tf32"]

WINDOW = 50


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, nearest even), as
    the tensor cores read their float32 inputs."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = ((i + 0x0FFF + lsb) >> 13) << 13
    finite = torch.isfinite(x)
    return torch.where(finite, r.view(torch.float32), x)


class _Products:
    """``loads(r) = B^T r`` and ``costs(p) = B p`` of one routing table."""

    def __init__(self, pe, n_slots, dtype, tf32, device):
        self.S = n_slots
        self.pe = torch.as_tensor(pe, dtype=torch.int64, device=device)
        self.P, self.L = self.pe.shape
        self.tf32 = tf32
        self.dtype = dtype
        if tf32:  # the control: a dense {0,1} incidence, TF32 operands
            b = torch.zeros((self.P, n_slots + 1), dtype=torch.float32,
                            device=device)
            b.scatter_(1, self.pe, 1.0)
            self.b = b[:, :n_slots].contiguous()

    def loads(self, r):
        if self.tf32:
            return torch.mv(self.b.T, to_tf32(r))
        out = torch.zeros(self.S + 1, dtype=self.dtype, device=r.device)
        out.index_add_(0, self.pe.reshape(-1),
                       r[:, None].expand(self.P, self.L).reshape(-1))
        return out[: self.S]

    def costs(self, p):
        if self.tf32:
            return torch.mv(self.b, to_tf32(p))
        pad = torch.cat([p, p.new_zeros(1)])
        return pad[self.pe].sum(dim=1)


def _seg_norm(x, owner, n_comm):
    s = torch.zeros(n_comm, dtype=x.dtype, device=x.device)
    s.index_add_(0, owner, x)
    return x / s[owner]


def mw_reference(routes, iters, target_alpha=None, control=False,
                 device="cpu", x_init=None) -> dict:
    """Run the MW recurrence on a reference routing table, from the
    per-path split ``x_init`` (normalised per commodity; uniform when
    ``None``).

    Returns ``alpha``, ``iters`` (iterations run), ``rates`` (numpy) and
    ``best_full`` (the best alpha over all ``iters`` iterations and the
    final evaluation, as if no target stopped the run)."""
    dtype = torch.float32 if control else torch.float64
    dev = torch.device(device)
    P, S = routes.n_paths, routes.n_slots
    owner = torch.as_tensor(np.asarray(routes.path_owner), dtype=torch.int64,
                            device=dev)
    K = int(len(routes.demands))
    dem = torch.as_tensor(np.asarray(routes.demands, np.float64),
                          dtype=dtype, device=dev)[owner]
    inv = torch.ones(S, dtype=dtype, device=dev)  # unit capacities
    prod = _Products(routes.path_edges, S, dtype, control, dev)
    t = torch.arange(max(iters, 1), dtype=torch.float64)
    frac = (0.2 * (0.005 / 0.2) ** (t / iters)).to(dtype).tolist()
    eta = (2.0 / torch.sqrt(1.0 + t)).to(dtype).tolist()
    x0 = (torch.ones(P, dtype=dtype, device=dev) if x_init is None else
          torch.as_tensor(np.asarray(x_init, np.float64), dtype=dtype,
                          device=dev))
    x = _seg_norm(x0, owner, K)
    rel_prev = torch.zeros(S, dtype=dtype, device=dev)
    best, best_x = 0.0, x
    stopped = None
    for it in range(iters):
        tau = max(float(rel_prev.max()), 1e-12) * frac[it]
        w = torch.softmax(rel_prev / tau, dim=0)
        loads = prod.loads(x * dem)
        costs = prod.costs(w * inv)
        rel = loads * inv
        alpha = 1.0 / max(float(rel.max()), 1e-12)
        if alpha > best:
            best, best_x = alpha, x
        g = costs * dem
        g = g / max(float(g.max()), 1e-12)
        x = _seg_norm(x * torch.exp(-eta[it] * g), owner, K)
        rel_prev = rel
        if (stopped is None and target_alpha is not None
                and (it + 1) % WINDOW == 0 and best >= target_alpha):
            stopped = (it + 1, best, best_x, x)
    final = 1.0 / max(float((prod.loads(x * dem) * inv).max()), 1e-12)
    best_full = max(best, final)
    if stopped is None:
        done, b, bx, xl = iters, best, best_x, x
    else:
        done, b, bx, xl = stopped
    last = 1.0 / max(float((prod.loads(xl * dem) * inv).max()), 1e-12)
    if last > b:
        b, bx = last, xl
    rates = (bx * dem * min(b, 1.0)).double().cpu().numpy()
    return {"alpha": b, "iters": done, "rates": rates, "best_full": best_full}


def achieved_alpha(routes, rates) -> float:
    """The concurrent flow fraction that ``rates`` carry on ``routes``: the
    least share of its demand a commodity ships, over the largest relative
    link load (unit capacities), in float64."""
    r = np.asarray(rates, dtype=np.float64)
    if r.shape != (routes.n_paths,) or not np.all(np.isfinite(r)):
        return float("nan")
    loads = np.bincount(routes.path_edges.reshape(-1),
                        weights=np.repeat(r, routes.path_edges.shape[1]),
                        minlength=routes.n_slots + 1)[: routes.n_slots]
    shipped = np.bincount(routes.path_owner, weights=r,
                          minlength=len(routes.demands))
    share = float((shipped / np.asarray(routes.demands, np.float64)).min())
    top = float(loads.max())
    return share / top if top > 0 else float("nan")


def shortfall(alpha: float, ref_alpha: float, target=None) -> float:
    """How far a solve's alpha falls short of the reference's, relative,
    both capped at ``target`` when given (a solve that stops there has
    answered).  An alpha above the reference's is no shortfall: its rates
    carry it (``achieved_alpha``)."""
    cap = float("inf") if target is None else target
    a, r = min(alpha, cap), min(ref_alpha, cap)
    if not (np.isfinite(a) and np.isfinite(r)) or r <= 0:
        return float("inf")
    return max(0.0, r - a) / r
