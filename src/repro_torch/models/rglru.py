"""RG-LRU recurrent block (Griffin / RecurrentGemma).  [arXiv:2402.19427]

The port of ``repro/models/rglru.py``.  Two input branches (D -> Dr): a
GeLU gate branch (tanh approximation, as ``jax.nn.gelu``), and a recurrent
branch through a width-4 causal conv with a carried buffer and then the
Real-Gated LRU:

    r_t = sigmoid(y_t W_a),  i_t = sigmoid(y_t W_x)
    log a_t = -c * r_t * softplus(Lambda)          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * y_t)

The recurrence over time is ``associative_scan``: the odd/even recursion of
``jax.lax.associative_scan`` written with tensor slices, so it forms the
same products in the same order (multiplies and adds only).  Decode state is
(h in float32, conv buffer).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import const, normal, params_of

__all__ = ["RGLRU", "associative_scan", "rglru_apply", "rglru_empty_state"]

_C = 8.0
_CONV_W = 4


class RGLRU(nn.Module):
    """One recurrent block's weights (lru width Dr = d_model)."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d = dr = cfg.d_model
        s = d**-0.5
        self.lru_in = normal(gen, (d, dr), s, dtype, device)
        self.lru_gate_in = normal(gen, (d, dr), s, dtype, device)
        self.conv_w = normal(gen, (_CONV_W, dr), 0.1, dtype, device)
        self.conv_b = const((dr,), 0.0, dtype, device)
        self.lru_gate_a = normal(gen, (dr, dr), dr**-0.5, dtype, device)
        self.lru_gate_x = normal(gen, (dr, dr), dr**-0.5, dtype, device)
        self.lru_lambda = const((dr,), 2.0, dtype, device)  # softplus ~ 2.1
        self.lru_out = normal(gen, (dr, d), dr**-0.5, dtype, device)

    def forward(self, x, state):
        return rglru_apply(params_of(self), x, state)


def rglru_empty_state(cfg, batch: int, dtype, device) -> dict:
    dr = cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, dr), dtype=dtype,
                            device=device),
    }


def _causal_conv(y, w, b, buf):
    """Depthwise causal conv, width 4.  y (B, S, Dr); buf (B, 3, Dr)."""
    ext = torch.cat([buf, y], dim=1)  # (B, S+3, Dr)
    s = y.shape[1]
    out = 0
    for i in range(_CONV_W):
        out = out + ext[:, i:i + s, :] * w[i]
    out = out + b
    return out.to(y.dtype), ext[:, -(_CONV_W - 1):, :]


def _combine(lhs, rhs):
    a1, x1 = lhs
    a2, x2 = rhs
    return a1 * a2, a2 * x1 + x2


def _interleave(even, odd, dim: int = 1):
    """Even entries at 0, 2, ...; odd at 1, 3, ... along ``dim``."""
    n = even.shape[dim] + odd.shape[dim]
    shape = list(even.shape)
    shape[dim] = n
    out = even.new_empty(shape)
    idx = [slice(None)] * even.dim()
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = even
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = odd
    return out


def associative_scan(elems, dim: int = 1):
    """Inclusive scan of (a, x) pairs under ``_combine`` along ``dim``:
    ``jax.lax.associative_scan``'s recursion (pair adjacent elements, scan
    the pairs, fill in the even positions)."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems

    def sl(t, start, stop=None, step=1):
        return t[(slice(None),) * dim + (slice(start, stop, step),)]

    reduced = _combine([sl(e, 0, -1, 2) for e in elems],
                       [sl(e, 1, None, 2) for e in elems])
    odd = associative_scan(reduced, dim)
    if n % 2 == 0:
        even = _combine([sl(e, 0, -1) for e in odd],
                        [sl(e, 2, None, 2) for e in elems])
    else:
        even = _combine(odd, [sl(e, 2, None, 2) for e in elems])
    even = [torch.cat([sl(e, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def rglru_apply(p, x, state: dict):
    """x (B, S, D) -> (out (B, S, D), new_state)."""
    gate = F.gelu(x @ p["lru_gate_in"], approximate="tanh")
    y = x @ p["lru_in"]
    y, conv_buf = _causal_conv(y, p["conv_w"], p["conv_b"], state["conv"])
    r = torch.sigmoid(y @ p["lru_gate_a"]).float()
    i = torch.sigmoid(y @ p["lru_gate_x"]).float()
    log_a = -_C * r * F.softplus(p["lru_lambda"].float())
    a = torch.exp(log_a)
    gated = i * y.float()
    mult = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    bx = mult * gated
    # segment (A, X) represents h_out = A h_in + X
    A, X = associative_scan([a, bx], dim=1)
    h_seq_f = A * state["h"][:, None, :] + X
    h_fin = h_seq_f[:, -1, :]
    out = (gate * h_seq_f.to(x.dtype)) @ p["lru_out"]
    return out, {"h": h_fin, "conv": conv_buf}
