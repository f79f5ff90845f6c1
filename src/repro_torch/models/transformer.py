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

Batches: {"tokens": (B,S)} for LMs; VLM adds {"inputs_embeds": (B,P,D)}
prefix (frontend stub output); audio uses {"inputs_embeds": (B,S,D),
"labels": (B,S)} exclusively.  Labels < 0 are masked from the loss.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..device import resolve
from .attention import Attention, make_kv_cache
from .layers import MLP, const, embed_init, normal, rmsnorm, softmax_cross_entropy
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

    def forward(self, x, positions, cfg, cache, chunk: int = 1024):
        h, cache = self.attn(rmsnorm(x, self.ln1, cfg.norm_eps), positions,
                             cfg, cache, self.window, chunk)
        x = x + h
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family == "moe":
            h2, aux = self.moe(rmsnorm(x, self.ln2, cfg.norm_eps), cfg)
        else:
            h2 = self.mlp(rmsnorm(x, self.ln2, cfg.norm_eps), "silu")
        return x + h2, cache, aux


class RecBlock(nn.Module):
    """Pre-norm RG-LRU + GeGLU block of the hybrid."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        self.ln1 = const((cfg.d_model,), 0.0, dtype, device)
        self.ln2 = const((cfg.d_model,), 0.0, dtype, device)
        self.rec = RGLRU(cfg, gen, dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, gen, dtype, device)

    def forward(self, x, state, cfg):
        h, state = self.rec(rmsnorm(x, self.ln1, cfg.norm_eps), state)
        x = x + h
        h2 = self.mlp(rmsnorm(x, self.ln2, cfg.norm_eps), "gelu")
        return x + h2, state


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

    def trunk(self, x, positions, caches, chunk: int = 1024):
        """x (B, S, D) embedded input -> (y, caches, aux).  ``caches`` holds
        one entry per layer; an attention layer's None means no cache
        (training mode)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new = []
        for kind, block, cache in zip(self.kinds, self.blocks, caches):
            run = _remat(block, cfg.remat)
            if kind == "attn":
                x, cache, a = run(x, positions, cfg, cache, chunk)
                aux = aux + a
            else:
                x, cache = run(x, cache, cfg)
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
        x = torch.cat([prefix, F.embedding(tok, model.embed).to(dtype)], 1)
        pad = torch.full(prefix.shape[:2], -1, dtype=torch.int32,
                         device=prefix.device)
        labels = torch.cat([pad, tok.to(torch.int32)], dim=1)
    elif "inputs_embeds" in batch:  # audio: frames in, codec tokens out
        x = batch["inputs_embeds"].to(dtype)
        labels = batch["labels"].to(torch.int32)
    else:
        tok = batch["tokens"]
        x = F.embedding(tok, model.embed).to(dtype)
        labels = tok.to(torch.int32)
    return x, labels


def loss_fn(model: LM, batch: dict):
    """Mean next-token CE plus the MoE aux term; autograd through it gives
    the gradient of every weight."""
    x, labels = _embed_input(model, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    y, _, aux = model.trunk(x, positions, _train_caches(model, b))
    y = rmsnorm(y, model.final_norm, model.cfg.norm_eps)
    loss = softmax_cross_entropy(model.logits(y)[:, :-1], labels[:, 1:])
    total = loss + MOE_AUX_COEF * aux
    return total, {"ce": loss, "aux": aux}


@torch.inference_mode()
def prefill(model: LM, batch: dict, max_len: int | None = None,
            chunk: int = 1024):
    """Process the prompt, return (last-token logits, populated caches)."""
    x, _ = _embed_input(model, batch)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    caches = init_cache(model.cfg, b, max_len or s, model.dtype, model.device)
    y, caches, _ = model.trunk(x, positions, caches, chunk)
    y = rmsnorm(y[:, -1:], model.final_norm, model.cfg.norm_eps)
    return model.logits(y)[:, 0], caches


@torch.inference_mode()
def decode_step(model: LM, caches: list, token: torch.Tensor, pos: int):
    """One decode step.  token (B,) int; pos the absolute position.  The
    attention layers' ring buffers in ``caches`` are written in place; the
    recurrent layers' states come back as new tensors in the returned
    list."""
    x = F.embedding(token, model.embed)[:, None, :].to(model.dtype)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    y, caches, _ = model.trunk(x, positions, caches, chunk=2048)
    y = rmsnorm(y, model.final_norm, model.cfg.norm_eps)
    return model.logits(y)[:, 0], caches
