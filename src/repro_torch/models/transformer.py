"""Unified LM over all architecture families.

The port of ``repro/models/transformer.py``.  ``LM(cfg)`` is an
``nn.Module`` with one block per layer in absolute order (dense / MoE
attention blocks, RWKV-6 layers, or the hybrid's RG-LRU and local-attention
blocks), and the reference's public functions sit over it:

    init_params(cfg, seed, dtype, device)          -> LM
    init_cache(cfg, batch, max_len, dtype, device) -> caches
    prefill(model, batch, max_len, chunk)          -> (last_logits, caches)
    decode_step(model, caches, token, pos)         -> (logits, caches)
    loss_fn(model, batch)                          -> (loss, metrics)

``loss_fn`` is differentiable: the train step (``launch.steps``) takes its
gradient by autograd, with each block under the activation checkpointing
``cfg.remat`` selects (``_remat``).  ``prefill`` and ``decode_step`` serve,
under ``torch.inference_mode()``, so they record no graph on the trainable
weights.

The hybrid with ``n_layers`` L at period P runs L // P periods of (rec, rec,
attn) and then an (L mod P)-layer recurrent tail, as the reference's scans
do.  Dense blocks use ``cfg.window``; the hybrid's attention uses
``cfg.local_window``.  Caches are a list with one entry per layer: the ring
buffer {"k", "v", "abs_pos"} of an attention layer (written in place), the
recurrent state of an RWKV or RG-LRU layer.  Activations run in the
weights' dtype.

Under a mesh every function takes ``shd`` (a ``runtime.sharding.Sharder``;
None runs unsharded): the weights, the batch and the caches are DTensors
(placed by ``launch.steps``), ``shd`` reaches every block, and the
embedded input ("btd"), the training logits ("btv") and the decode logits
("bv") take the reference's signatures.  Prefill places the caches it
makes by ``runtime.sharding.cache_shardings``.

Batches: {"tokens": (B,S)} for LMs; VLM adds {"inputs_embeds": (B,P,D)}
prefix (frontend stub output); audio uses {"inputs_embeds": (B,S,D),
"labels": (B,S)} exclusively.  Labels < 0 are masked from the loss.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve
from ..runtime.sharding import act, cache_shardings
from .attention import Attention, make_kv_cache
from .layers import (
    MLP,
    const,
    embed,
    embed_init,
    normal,
    rmsnorm,
    softmax_cross_entropy,
)
from .moe import MoE
from .rglru import RGLRU, rglru_empty_state
from .rwkv6 import RWKV, rwkv_empty_state

__all__ = ["LM", "decode_step", "init_cache", "init_params", "layer_kinds",
           "loss_fn", "prefill"]

MOE_AUX_COEF = 0.01


def layer_kinds(cfg) -> list[str]:
    """Each layer's block kind in absolute order: ``attn``, ``rwkv`` or
    ``rec``."""
    if cfg.family in ("dense", "moe"):
        return ["attn"] * cfg.n_layers
    if cfg.family == "rwkv6":
        return ["rwkv"] * cfg.n_layers
    if cfg.family == "rglru_hybrid":
        period = cfg.attn_period or 3
        n_periods = cfg.n_layers // period
        tail = cfg.n_layers - n_periods * period
        return ["rec", "rec", "attn"] * n_periods + ["rec"] * tail
    raise ValueError(cfg.family)


#: The products ``remat="dots"`` keeps: matrix products with no batch dim
#: (``x @ W`` folds the batch into the rows of one ``mm``), as JAX's
#: ``checkpoint_dots_with_no_batch_dims`` keeps its ``dot_general``s without
#: batch dims; batched einsums (attention, experts) are recomputed.
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(fn, remat: str):
    """``fn`` (one block) under the activation checkpointing ``remat``
    selects, as the reference's ``_remat`` wraps each scanned layer:
    ``none`` keeps every activation autograd saves; ``full`` keeps only the
    block's inputs and recomputes the block in the backward; ``dots`` keeps
    the outputs of the products in ``_SAVED_DOTS`` and recomputes the rest.
    Without autograd (serving, ``torch.no_grad``) ``fn`` runs as it is."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn
    if remat == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if remat == "dots":
        return functools.partial(
            checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         _save_dots))
    raise ValueError(f"remat must be none, full or dots, not {remat!r}")


def _window(cfg) -> int | None:
    """The attention window: local in the hybrid, ``cfg.window`` else."""
    return cfg.local_window if cfg.family == "rglru_hybrid" else cfg.window


def _norm(x, scale, cfg, shd):
    """The pre-norm of a sublayer.  Under a mesh its output, the projections'
    input, is held to "btd" in both passes, and so is each sublayer's output
    before the residual add (where the row-parallel partial sums reduce):
    DTensor would otherwise leave the gradients sharded over d_model or the
    sequence, which the products' backward cannot fold into rows.  The
    reference leaves both to GSPMD."""
    return act(shd, rmsnorm(x, scale, cfg.norm_eps), "btd")


class DenseBlock(nn.Module):
    """Pre-norm attention + (MLP | MoE) block."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln1 = const((cfg.d_model,), 0.0, dtype, device)
        self.ln2 = const((cfg.d_model,), 0.0, dtype, device)
        self.attn = Attention(cfg, gen, dtype, device)
        if cfg.family == "moe":
            self.moe = MoE(cfg, gen, dtype, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, dtype, device)
        self.window = _window(cfg)

    def forward(self, x, positions, cfg, cache, chunk: int = 1024, shd=None):
        h, cache = self.attn(_norm(x, self.ln1, cfg, shd), positions,
                             cfg, cache, self.window, chunk, shd)
        x = x + act(shd, h, "btd")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "moe":
            h2, aux = self.moe(_norm(x, self.ln2, cfg, shd), cfg, shd)
        else:
            h2 = self.mlp(_norm(x, self.ln2, cfg, shd), "silu", shd)
        return x + act(shd, h2, "btd"), cache, aux


class RecBlock(nn.Module):
    """Pre-norm RG-LRU + GeGLU block of the hybrid."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln1 = const((cfg.d_model,), 0.0, dtype, device)
        self.ln2 = const((cfg.d_model,), 0.0, dtype, device)
        self.rec = RGLRU(cfg, gen, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, dtype, device)

    def forward(self, x, state, cfg, shd=None):
        h, state = self.rec(_norm(x, self.ln1, cfg, shd), state, shd)
        x = x + act(shd, h, "btd")
        h2 = self.mlp(_norm(x, self.ln2, cfg, shd), "gelu", shd)
        return x + act(shd, h2, "btd"), state


class LM(nn.Module):
    """The language model of ``cfg``: embedding (padded vocab), one block
    per layer, final norm, and an LM head unless the embeddings are tied.

    Weights are drawn on ``device`` from ``torch.Generator(device)`` seeded
    with ``seed``, at the reference's scales, with its zero / constant
    initialisations and its ``head_pad`` zeroing; ``seed=None`` leaves them
    unset, for weights loaded next (``convert.lm_params_from_numpy``).  The
    generator differs from ``jax.random``, so the draws differ from the
    reference's."""

    def __init__(self, cfg, seed: int | None = 0, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        dev = resolve(device)
        gen = None
        if seed is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
        self.cfg = cfg
        self.kinds = layer_kinds(cfg)
        d, vpad = cfg.d_model, cfg.vocab_padded
        self.embed = embed_init(gen, vpad, d, dtype, dev)
        blocks = []
        for kind in self.kinds:
            if kind == "attn":
                blocks.append(DenseBlock(cfg, gen, dtype, dev))
            elif kind == "rwkv":
                blocks.append(RWKV(cfg, gen, dtype, dev))
            else:
                blocks.append(RecBlock(cfg, gen, dtype, dev))
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = const((d,), 0.0, dtype, dev)
        if not cfg.tie_embeddings:
            self.lm_head = normal(gen, (d, vpad), d**-0.5, dtype, dev)

    @property
    def dtype(self) -> torch.dtype:
        return self.embed.dtype

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def trunk(self, x, positions, caches, chunk: int = 1024, shd=None):
        """x (B, S, D) embedded input -> (y, caches, aux).  ``caches`` holds
        one entry per layer; an attention layer's None means no cache
        (training mode)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new = []
        for kind, block, cache in zip(self.kinds, self.blocks, caches):
            run = _remat(block, cfg.remat)
            if kind == "attn":
                x, cache, a = run(x, positions, cfg, cache, chunk, shd)
                aux = aux + a
            else:
                x, cache = run(x, cache, cfg, shd)
            # the residual stream between blocks, in both passes
            x = act(shd, x, "btd")
            new.append(cache)
        return x, new, aux

    def logits(self, y):
        head = self.lm_head if hasattr(self, "lm_head") else self.embed.T
        return y @ head


def init_params(cfg, seed: int = 0, dtype=torch.float32,
                device="cuda") -> LM:
    """``LM(cfg)`` with its weights drawn on ``device`` (see ``LM``)."""
    return LM(cfg, seed=seed, dtype=dtype, device=device)


def _state(kind, cfg, batch, max_len, dtype, device):
    if kind == "attn":
        return make_kv_cache(cfg, batch, max_len, _window(cfg), dtype, device)
    if kind == "rwkv":
        return rwkv_empty_state(cfg, batch, dtype, device)
    return rglru_empty_state(cfg, batch, dtype, device)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda") -> list:
    """Decode caches sized for ``max_len`` absolute positions, one entry per
    layer."""
    dev = resolve(device)
    return [_state(kind, cfg, batch, max_len, dtype, dev)
            for kind in layer_kinds(cfg)]


def _train_caches(model, batch_size):
    """Training mode: zero recurrent states (part of the math), no KV."""
    cfg = model.cfg
    return [None if kind == "attn" else
            _state(kind, cfg, batch_size, 0, model.dtype, model.device)
            for kind in model.kinds]


def _embed_input(model, batch):
    """Returns (x (B,S,D), labels (B,S))."""
    dtype = model.dtype
    if "inputs_embeds" in batch and "tokens" in batch:  # VLM: prefix + text
        prefix = batch["inputs_embeds"].to(dtype)
        tok = batch["tokens"]
        x = torch.cat([prefix, embed(tok, model.embed).to(dtype)], 1)
        pad = torch.full(prefix.shape[:2], -1, dtype=torch.int32,
                         device=prefix.device)
        labels = torch.cat([pad, tok.to(torch.int32)], dim=1)
    elif "inputs_embeds" in batch:  # audio: frames in, codec tokens out
        x = batch["inputs_embeds"].to(dtype)
        labels = batch["labels"].to(torch.int32)
    else:
        tok = batch["tokens"]
        x = embed(tok, model.embed).to(dtype)
        labels = tok.to(torch.int32)
    return x, labels


def loss_fn(model: LM, batch: dict, shd=None):
    """Mean next-token CE plus the MoE aux term; autograd through it gives
    the gradient of every weight."""
    x, labels = _embed_input(model, batch)
    x = act(shd, x, "btd")
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    y, _, aux = model.trunk(x, positions, _train_caches(model, b), shd=shd)
    y = _norm(y, model.final_norm, model.cfg, shd)
    logits = act(shd, model.logits(y), "btv")
    loss = softmax_cross_entropy(logits[:, :-1], labels[:, 1:])
    total = loss + MOE_AUX_COEF * aux
    return total, {"ce": loss, "aux": aux}


def _serving(shd):
    """``inference_mode`` unsharded; ``no_grad`` under a mesh, where views
    of DTensor parameters fail inside ``inference_mode`` ("Cannot set
    version_counter for inference tensor")."""
    return torch.inference_mode() if shd is None else torch.no_grad()


def prefill(model: LM, batch: dict, max_len: int | None = None,
            chunk: int = 1024, shd=None):
    """Process the prompt, return (last-token logits, populated caches)."""
    with _serving(shd):
        return _prefill(model, batch, max_len, chunk, shd)


def _prefill(model, batch, max_len, chunk, shd):
    x, _ = _embed_input(model, batch)
    x = act(shd, x, "btd")
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    caches = init_cache(model.cfg, b, max_len or s, model.dtype, model.device)
    if shd is not None:
        caches = [{k: sh[k].distribute(c[k]) for k in c} for c, sh in zip(
            caches, cache_shardings(caches, shd.mesh, b))]
    y, caches, _ = model.trunk(x, positions, caches, chunk, shd)
    y = rmsnorm(y[:, -1:], model.final_norm, model.cfg.norm_eps)
    return model.logits(y)[:, 0], caches


def decode_step(model: LM, caches: list, token: torch.Tensor, pos: int,
                shd=None):
    """One decode step.  token (B,) int; pos the absolute position.  The
    attention layers' ring buffers in ``caches`` are written in place; the
    recurrent layers' states come back as new tensors in the returned
    list."""
    with _serving(shd):
        return _decode_step(model, caches, token, pos, shd)


def _decode_step(model, caches, token, pos, shd):
    x = embed(token, model.embed)[:, None, :].to(model.dtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    y, caches, _ = model.trunk(x, positions, caches, chunk=2048, shd=shd)
    y = rmsnorm(y, model.final_norm, model.cfg.norm_eps)
    return act(shd, model.logits(y)[:, 0], "bv"), caches
