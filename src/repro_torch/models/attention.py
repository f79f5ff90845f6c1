"""Attention: chunked online-softmax causal GQA with sliding/local windows
and a ring-buffer KV cache for decode.

The port of ``repro/models/attention.py``.  ``chunked_attention`` is the
reference's scan over KV chunks, kept as a Python loop over the same chunks
with the same running (max, sum, accumulator) updates: this slice ports the
function, it does not swap in a library attention.  Decode attends over the
whole cache in one einsum with position masking.

Conventions: q (B, Sq, H, hd); k/v (B, Sk, KVH, hd); GQA groups G = H / KVH.
All masks derive from absolute positions, so sliding windows and ring-buffer
caches need no ordering assumptions.  The reference takes the float32
accumulator of its products (``preferred_element_type``) and casts P to the
value dtype before PV; here the operands of the score and PV products are
upcast to float32, which gives that result in bf16 runs too.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import normal, params_of, rope

__all__ = ["Attention", "attn_apply", "chunked_attention", "decode_attention",
           "make_kv_cache"]

NEG_INF = -1e30


def chunked_attention(q, k, v, q_positions, k_positions,
                      window: int | None = None,
                      chunk: int = 1024) -> torch.Tensor:
    """Causal (optionally windowed) attention as an online-softmax pass over
    KV chunks.  q_positions (Sq,), k_positions (Sk,) absolute; -1 marks an
    invalid key."""
    b, sq, h, hd = q.shape
    _, sk, kvh, _ = k.shape
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).float()
    scale = hd**-0.5

    chunk = min(chunk, sk)
    pad = (-sk) % chunk
    if pad:
        k = torch.cat([k, k.new_zeros((b, pad, kvh, hd))], dim=1)
        v = torch.cat([v, v.new_zeros((b, pad, kvh, hd))], dim=1)
        k_positions = torch.cat(
            [k_positions, k_positions.new_full((pad,), -1)])
    nchunks = k.shape[1] // chunk

    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    qp = q_positions[:, None]
    for c in range(nchunks):
        kci = k[:, c * chunk:(c + 1) * chunk]
        vci = v[:, c * chunk:(c + 1) * chunk]
        pci = k_positions[c * chunk:(c + 1) * chunk][None, :]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg, kci.float()) * scale
        ok = (pci <= qp) & (pci >= 0)
        if window is not None:
            ok &= pci > (qp - window)
        s = torch.where(ok[None, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        # PV with P in the value dtype, accumulated in float32
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(vci.dtype).float(), vci.float())
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, abs_pos, pos,
                     window: int | None = None) -> torch.Tensor:
    """Single-token attention over the whole cache as one einsum.
    q (B, 1, H, hd); caches (B, S, KVH, hd); abs_pos (S,) the absolute
    position per slot, -1 invalid; pos the current position (an int or a
    0-d tensor)."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    g = h // kvh
    qg = q.reshape(b, kvh, g, hd).float()
    scale = hd**-0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    ok = (abs_pos <= pos) & (abs_pos >= 0)
    if window is not None:
        ok &= abs_pos > (pos - window)
    s = torch.where(ok[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# --------------------------------------------------------------------------- #
# full attention sublayer (projections + rope + cache handling)
# --------------------------------------------------------------------------- #


class Attention(nn.Module):
    """The sublayer's weights: ``wq`` (D x (H + head_pad) hd), ``wk``/``wv``
    (D x KVH hd), ``wo``, and with ``qkv_bias`` the three biases (zeros).
    Padded q-heads start dead: zero ``wq`` columns and zero ``wo`` rows."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        hq = cfg.n_heads + cfg.head_pad
        s = d**-0.5
        self.wq = normal(gen, (d, hq * hd), s, dtype, device)
        self.wk = normal(gen, (d, cfg.n_kv_heads * hd), s, dtype, device)
        self.wv = normal(gen, (d, cfg.n_kv_heads * hd), s, dtype, device)
        self.wo = normal(gen, (hq * hd, d), (cfg.n_heads * hd) ** -0.5,
                         dtype, device)
        if cfg.head_pad and gen is not None:
            self.wq.data[:, cfg.n_heads * hd:] = 0
            self.wo.data[cfg.n_heads * hd:, :] = 0
        if cfg.qkv_bias:
            z = lambda n: nn.Parameter(  # noqa: E731
                torch.zeros((n,), dtype=dtype, device=device))
            self.wq_b = z(hq * hd)
            self.wk_b = z(cfg.n_kv_heads * hd)
            self.wv_b = z(cfg.n_kv_heads * hd)

    def forward(self, x, positions, cfg, cache=None, window=None,
                chunk: int = 1024):
        return attn_apply(params_of(self), x, positions, cfg, cache, window,
                          chunk)


def attn_apply(p, x, positions, cfg, cache: dict | None = None,
               window: int | None = None, chunk: int = 1024):
    """x (B, S, D); positions (S,) absolute.  Returns (out (B, S, D), cache).

    ``cache`` is the layer's ring buffer {"k", "v", "abs_pos"}, written in
    place: decode writes one slot; prefill (positions 0..S-1) writes the
    prefix when S <= slots, the slot-aligned tail when S % slots == 0, and
    otherwise scatters the last ``slots`` positions to their ring slots."""
    b, s, d = x.shape
    hd = cfg.hd
    hq = cfg.n_heads + cfg.head_pad
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["wq_b"]
        k = k + p["wk_b"]
        v = v + p["wv_b"]
    q = q.reshape(b, s, hq, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is None:
        out = chunked_attention(q, k, v, positions, positions, window, chunk)
    elif s == 1:
        # the slot stays a device tensor: no host sync per layer
        slot_count = cache["k"].shape[1]
        slot = positions[:1].long() % slot_count
        cache["k"][:, slot] = k
        cache["v"][:, slot] = v
        cache["abs_pos"][slot] = positions[:1].to(torch.int32)
        out = decode_attention(q, cache["k"], cache["v"], cache["abs_pos"],
                               positions[0], window)
    else:
        out = chunked_attention(q, k, v, positions, positions, window, chunk)
        slot_count = cache["k"].shape[1]
        pos32 = positions.to(torch.int32)
        if s <= slot_count:
            cache["k"][:, :s] = k
            cache["v"][:, :s] = v
            cache["abs_pos"][:s] = pos32
        elif s % slot_count == 0:
            cache["k"].copy_(k[:, -slot_count:])
            cache["v"].copy_(v[:, -slot_count:])
            cache["abs_pos"].copy_(pos32[-slot_count:])
        else:
            idx = (positions[-slot_count:] % slot_count).long()
            cache["k"][:, idx] = k[:, -slot_count:]
            cache["v"][:, idx] = v[:, -slot_count:]
            cache["abs_pos"][idx] = pos32[-slot_count:]

    out = out.reshape(b, s, hq * hd)
    return out @ p["wo"], cache


def make_kv_cache(cfg, batch: int, max_len: int, window: int | None, dtype,
                  device) -> dict:
    """Empty ring-buffer cache of one attention layer."""
    slots = min(max_len, window) if window else max_len
    shape = (batch, slots, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "abs_pos": torch.full((slots,), -1, dtype=torch.int32, device=device),
    }
