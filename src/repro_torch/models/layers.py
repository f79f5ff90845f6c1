"""Shared layers: RMSNorm, RoPE, gated MLP, embeddings, cross-entropy.

The port of ``repro/models/layers.py``.  The math is plain functions on
tensors; ``p`` is a mapping from the reference's leaf names to tensors (a
module's own parameters, see ``params_of``).  ``normal`` draws a weight on
its device from a ``torch.Generator`` at the reference's scale; with no
generator it leaves the storage empty for weights that are loaded next
(``convert.lm_params_from_numpy``).

Under a mesh the tensors are DTensors and ``shd`` (a
``runtime.sharding.Sharder``) places the activations, as the reference's
``shd.act`` calls do.  ``softmax_cross_entropy`` on vocab-sharded logits
reduces over the vocabulary as a max and a sum of shard partials, so no
rank gathers the whole logits (DTensor's ``logsumexp`` would).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..runtime.sharding import local_span

__all__ = [
    "MLP",
    "const",
    "embed",
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


def mlp(p, x: torch.Tensor, act: str = "silu", shd=None) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU)."""
    h = x @ p["w1"]
    g = x @ p["w3"]
    if shd is not None:
        h = shd.act(h, "btf")
        g = shd.act(g, "btf")
    return (_act(h, act) * g) @ p["w2"]


class MLP(nn.Module):
    """The gated MLP's weights (``w1``, ``w3``: D x F; ``w2``: F x D)."""

    def __init__(self, d_model: int, d_ff: int, gen, dtype, device):
        super().__init__()
        s_in, s_ff = d_model**-0.5, d_ff**-0.5
        self.w1 = normal(gen, (d_model, d_ff), s_in, dtype, device)
        self.w3 = normal(gen, (d_model, d_ff), s_in, dtype, device)
        self.w2 = normal(gen, (d_ff, d_model), s_ff, dtype, device)

    def forward(self, x: torch.Tensor, act: str = "silu",
                shd=None) -> torch.Tensor:
        return mlp(params_of(self), x, act, shd)


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a mesh (DTensor operands) the table's
    vocabulary rows stay sharded where the tokens are replicated: each rank
    looks up the tokens its rows hold (zeros for the others) and the rows
    sum over those mesh dims.  (DTensor's own rule for a vocab-sharded
    table fails on a 2-d index.)  Elsewhere the table is gathered."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    tok_pl = tokens.placements if isinstance(tokens, DTensor) else (
        [Replicate()] * mesh.ndim)
    split = [isinstance(p, Shard) and p.dim == 0 and isinstance(t, Replicate)
             for p, t in zip(table.placements, tok_pl)]
    tab_pl = [Shard(0) if s else Replicate() for s in split]
    out_pl = [Partial() if s else (Shard(0) if isinstance(t, Shard)
                                   else Replicate())
              for s, t in zip(split, tok_pl)]
    grad_pl = [Partial() if isinstance(o, Shard) else p
               for o, p in zip(out_pl, tab_pl)]
    tab = table.redistribute(mesh, tab_pl)
    lo, n = local_span(tab.shape[0], mesh, tab_pl, 0)
    tab_l = tab.to_local(grad_placements=grad_pl)
    tok_l = tokens.to_local() if isinstance(tokens, DTensor) else tokens
    if n == table.shape[0]:
        out = F.embedding(tok_l, tab_l)
    else:
        idx = tok_l.long() - lo
        own = (idx >= 0) & (idx < n)
        out = F.embedding(idx.clamp(0, n - 1), tab_l) * own[..., None].to(
            tab_l.dtype)
    return DTensor.from_local(out, mesh, out_pl, run_check=False)


def embed_init(gen, vocab: int, d_model: int, dtype, device) -> nn.Parameter:
    return normal(gen, (vocab, d_model), d_model**-0.5, dtype, device)


def _vocab_sharded(logits) -> bool:
    """Whether the logits' vocabulary is split over ranks (a Shard on a
    mesh dim of one rank splits nothing)."""
    return isinstance(logits, DTensor) and any(
        isinstance(p, Shard) and p.dim == logits.ndim - 1 and n > 1
        for p, n in zip(logits.placements, logits.device_mesh.shape))


def _label_logit(logits: DTensor, labels) -> DTensor:
    """``logits[..., labels]`` over vocab-sharded logits: each rank picks
    the labels its vocabulary shard holds (zero for the others) and the
    picks sum over the vocabulary's mesh dims.  (DTensor's own rule for
    ``gather`` fails on a 2-d index.)"""
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim == last for p in logits.placements]
    lab_pl = [Replicate() if v else p
              for v, p in zip(vocab, logits.placements)]
    lab = (labels.redistribute(mesh, lab_pl) if isinstance(labels, DTensor)
           else DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False).redistribute(mesh, lab_pl))
    lo, n = local_span(logits.shape[last], mesh, logits.placements, last)
    lg = logits.to_local()
    idx = torch.clamp(lab.to_local(), min=0).long() - lo
    own = (idx >= 0) & (idx < n)
    ll = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
    out_pl = [Partial() if v else p for v, p in zip(vocab, lab_pl)]
    return DTensor.from_local(ll * own.to(ll.dtype), mesh, out_pl,
                              run_check=False)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 0.0) -> torch.Tensor:
    """Mean next-token CE in f32; ``labels < 0`` positions are masked out."""
    logits = logits.float()
    if _vocab_sharded(logits):
        m = logits.detach().amax(dim=-1, keepdim=True)
        lse = m[..., 0] + torch.log(torch.sum(torch.exp(logits - m), dim=-1))
        ll = _label_logit(logits, labels)
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          torch.clamp(labels, min=0).long()[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse**2
    mask = (labels >= 0).float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

