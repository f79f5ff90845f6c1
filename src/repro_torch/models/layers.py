"""Shared layers: RMSNorm, RoPE, gated MLP, embeddings, cross-entropy.

The port of ``repro/models/layers.py``.  The math is plain functions on
tensors; ``p`` is a mapping from the reference's leaf names to tensors (a
module's own parameters, see ``params_of``).  ``normal`` draws a weight on
its device from a ``torch.Generator`` at the reference's scale; with no
generator it leaves the storage empty for weights that are loaded next
(``convert.lm_params_from_numpy``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "MLP",
    "const",
    "embed_init",
    "mlp",
    "normal",
    "params_of",
    "rmsnorm",
    "rope",
    "softmax_cross_entropy",
]


def normal(gen, shape, scale: float, dtype, device) -> nn.Parameter:
    """A trainable weight of ``shape`` drawn N(0, scale^2) in float32 on
    ``device`` from ``gen`` and cast to ``dtype``; empty storage when ``gen``
    is None.  Serving runs under ``torch.inference_mode()`` and records no
    graph (``models.prefill``, ``models.decode_step``)."""
    if gen is None:
        t = torch.empty(shape, dtype=dtype, device=device)
    else:
        t = (torch.randn(shape, generator=gen, device=device,
                         dtype=torch.float32) * scale).to(dtype)
    return nn.Parameter(t)


def const(shape, value: float, dtype, device) -> nn.Parameter:
    """A trainable weight of ``shape`` filled with ``value`` (zeros, ones,
    -6.0, ...)."""
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


def params_of(module: nn.Module) -> dict:
    """A module's own parameters by the reference's leaf names."""
    return dict(module.named_parameters(recurse=False))


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding, NeoX convention (rotate the two halves).
    x: (..., S, H, hd); positions: (S,) or broadcastable to x's sequence
    dim.  The angles are float32 whatever x's dtype, as in the reference."""
    hd = x.shape[-1]
    half = hd // 2
    # log(theta) in float32 on the device (a host tensor copied over would
    # wait for the stream at every layer)
    log_theta = torch.log(torch.full((), theta, dtype=torch.float32,
                                     device=x.device))
    freq = torch.exp(
        -log_theta
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions.float()[..., None] * freq  # (..., S, half)
    ang = ang[..., None, :]  # broadcast over the head dim
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _act(h: torch.Tensor, act: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU)."""
    h = x @ p["w1"]
    g = x @ p["w3"]
    return (_act(h, act) * g) @ p["w2"]


class MLP(nn.Module):
    """The gated MLP's weights (``w1``, ``w3``: D x F; ``w2``: F x D)."""

    def __init__(self, d_model: int, d_ff: int, gen, dtype, device):
        super().__init__()
        s_in, s_ff = d_model**-0.5, d_ff**-0.5
        self.w1 = normal(gen, (d_model, d_ff), s_in, dtype, device)
        self.w3 = normal(gen, (d_model, d_ff), s_in, dtype, device)
        self.w2 = normal(gen, (d_ff, d_model), s_ff, dtype, device)

    def forward(self, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
        return mlp(params_of(self), x, act)


def embed_init(gen, vocab: int, d_model: int, dtype, device) -> nn.Parameter:
    return normal(gen, (vocab, d_model), d_model**-0.5, dtype, device)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE in f32; ``labels < 0`` positions are masked out."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse**2
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

