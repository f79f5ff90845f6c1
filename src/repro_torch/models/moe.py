"""Mixture-of-experts FFN: top-k routing with sort-based capacity dispatch.

The port of ``repro/models/moe.py``:

1. router logits -> softmax -> top-k (gates, expert ids) per token;
2. stable-sort each batch row's (token, choice) pairs by expert id, find
   each pair's position within its expert group (``searchsorted``), drop
   pairs beyond ``capacity``;
3. gather tokens into a dense (B, E, C, D) buffer (one padding slot absorbs
   the dropped pairs), run all experts as one batched product;
4. combine: un-sort the kept pairs' weighted outputs to (B, S, k, D) and
   add each token's k contributions in choice order.

The reference's combine is a scatter-add; here it is a gather and a sum in
a fixed order, because ``index_add_`` / ``scatter_add_`` are atomics on
CUDA.  Top-k is a stable descending sort, so equal probabilities go to the
lower expert id first, as ``jax.lax.top_k`` does.  Dropped pairs pass
through the residual only.  Shared experts (qwen2-moe) are a dense gated MLP
on every token with a sigmoid gate.  Decode (S = 1) runs all experts densely
and gate-combines (drop-free).  Aux loss: Switch-style E * sum_e f_e p_e.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import normal, params_of

__all__ = ["MoE", "moe_apply", "top_k"]


class MoE(nn.Module):
    """Router (D x E), stacked expert weights ``we1``/``we3`` (E x D x F) and
    ``we2`` (E x F x D), and with shared experts their gated MLP."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, e = cfg.d_model, cfg.n_experts
        f = cfg.moe_d_ff or cfg.d_ff
        s_in, s_ff = d**-0.5, f**-0.5
        self.router = normal(gen, (d, e), s_in, dtype, device)
        self.we1 = normal(gen, (e, d, f), s_in, dtype, device)
        self.we3 = normal(gen, (e, d, f), s_in, dtype, device)
        self.we2 = normal(gen, (e, f, d), s_ff, dtype, device)
        if cfg.n_shared_experts:
            fs = f * cfg.n_shared_experts
            self.shared_w1 = normal(gen, (d, fs), s_in, dtype, device)
            self.shared_w3 = normal(gen, (d, fs), s_in, dtype, device)
            self.shared_w2 = normal(gen, (fs, d), fs**-0.5, dtype, device)
            self.shared_gate = normal(gen, (d, 1), s_in, dtype, device)

    def forward(self, x, cfg):
        return moe_apply(params_of(self), x, cfg)


def top_k(probs: torch.Tensor, k: int):
    """The k largest entries of the last dim, largest first, ties to the
    lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _shared(p, x, y):
    hs = (F.silu(x @ p["shared_w1"]) * (x @ p["shared_w3"])) @ p["shared_w2"]
    sg = torch.sigmoid(x @ p["shared_gate"])
    return y + hs * sg.to(hs.dtype)


def moe_apply(p, x: torch.Tensor, cfg):
    """x (B, S, D) -> (out (B, S, D), aux_loss 0-d float32).  Capacity is
    per sequence (grouped by batch row), as in the reference."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k

    logits = (x @ p["router"]).float()  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, k)  # (B, S, k)
    if cfg.norm_topk_prob:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # one-hot of the choices by comparison: exact counts, and unlike
    # bincount / F.one_hot no host sync on CUDA
    onehot = (experts[..., None]
              == torch.arange(e, device=x.device)).to(gates.dtype)  # (B,S,k,E)
    me = torch.mean(probs, dim=(0, 1))  # (E,)
    ce = onehot.sum(dim=(0, 1, 2)) / (b * s * k)
    aux = e * torch.sum(me * ce)

    if s == 1:
        h1 = torch.einsum("bsd,edf->bsef", x, p["we1"])
        h3 = torch.einsum("bsd,edf->bsef", x, p["we3"])
        hh = F.silu(h1) * h3
        out_e = torch.einsum("bsef,efd->bsed", hh, p["we2"])  # (B,1,E,D)
        weights = torch.einsum("bske,bsk->bse", onehot, gates)
        y = torch.einsum("bsed,bse->bsd", out_e, weights.to(out_e.dtype))
        if cfg.n_shared_experts:
            y = _shared(p, x, y)
        return y.to(x.dtype), aux

    # Python's round (half to even), as the reference computes it
    capacity = int(max(1, round(s * k / e * cfg.capacity_factor)))
    capacity = min(capacity, s)

    n = s * k
    dev = x.device
    flat_expert = experts.reshape(b, n)
    flat_token = torch.arange(s, device=dev).repeat_interleave(k)
    flat_token = flat_token[None].expand(b, n)
    flat_gate = gates.reshape(b, n)
    order = torch.argsort(flat_expert, dim=1, stable=True)
    se = torch.gather(flat_expert, 1, order)
    st = torch.gather(flat_token, 1, order)
    sg = torch.gather(flat_gate, 1, order)
    # position within the expert group, per batch row
    group_start = torch.searchsorted(
        se, torch.arange(e, device=dev)[None].expand(b, e).contiguous())
    pos_in_group = (torch.arange(n, device=dev)[None]
                    - torch.gather(group_start, 1, se))
    keep = pos_in_group < capacity
    slot = torch.where(keep, se * capacity + pos_in_group, e * capacity)

    # dispatch into (B, E*C + 1, D); every dropped pair writes zeros to the
    # padding slot, every kept pair its own slot.  The in-place scatter_
    # writes into a buffer made here, which autograd has saved for nothing,
    # so its backward is sound: a gather of the gradient at the same slots
    # (the padding slot's gradient reaches only zeros).
    gathered = torch.gather(x, 1, st[..., None].expand(b, n, d))
    buf = x.new_zeros((b, e * capacity + 1, d))
    buf.scatter_(1, slot[..., None].expand(b, n, d),
                 torch.where(keep[..., None], gathered, 0))
    he = buf[:, : e * capacity].reshape(b, e, capacity, d)

    h1 = torch.einsum("becd,edf->becf", he, p["we1"])
    h3 = torch.einsum("becd,edf->becf", he, p["we3"])
    hh = F.silu(h1) * h3
    out_e = torch.einsum("becf,efd->becd", hh, p["we2"])  # (B, E, C, D)

    # combine: each pair's weighted expert output, back in (token, choice)
    # order, summed over the k choices left to right
    out_flat = torch.cat(
        [out_e.reshape(b, e * capacity, d), out_e.new_zeros((b, 1, d))], 1)
    contrib = torch.gather(out_flat, 1, slot[..., None].expand(b, n, d))
    contrib = contrib * (sg * keep)[..., None].to(out_e.dtype)
    inv = torch.empty_like(order)
    inv.scatter_(1, order, torch.arange(n, device=dev)[None].expand(b, n))
    contrib = torch.gather(contrib, 1, inv[..., None].expand(b, n, d))
    contrib = contrib.reshape(b, s, k, d)
    y = contrib[:, :, 0]
    for j in range(1, k):
        y = y + contrib[:, :, j]

    if cfg.n_shared_experts:
        y = _shared(p, x, y)
    return y.to(x.dtype), aux
