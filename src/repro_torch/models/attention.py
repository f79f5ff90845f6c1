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

Under a mesh (``shd``, a ``runtime.sharding.Sharder``) the projections are
DTensor products and q/k/v take the reference's signatures: heads over
``model`` when the head count divides it ("bthd"/"btkd"), else context
parallelism over the sequence ("bS.."/"bt..").  The attention itself runs
on each rank's shards (``Sharder.local``): DTensor cannot split a sharded
head dim into GQA groups that do not divide the axis, and the online
softmax's loop would otherwise be sharded op by op.  A rank whose q heads
read kv heads that are replicated picks them out itself.  Cache writes and
decode attention run on the local shards of the cache's own sharding
(``runtime.sharding.cache_shardings``): each rank writes the ring slots it
holds, and over slot-sharded caches the softmax's max and sums are reduced
across the slot shards.
"""

from __future__ import annotations

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..runtime.sharding import local_span
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
                chunk: int = 1024, shd=None):
        return attn_apply(params_of(self), x, positions, cfg, cache, window,
                          chunk, shd)


def _split_heads(t, h: int, hd: int, shd):
    """(B, S, h * hd) -> (B, S, h, hd).  A DTensor view cannot split a
    feature dim sharded over an axis that ``h`` does not divide, so such a
    dim is gathered first."""
    if shd is not None and not shd.divisible(h):
        t = shd.act(t, "bt.")
    return t.reshape(t.shape[0], t.shape[1], h, hd)


def _local_kv(k, v, hq: int, kvh: int, h0: int, hq_local: int):
    """The kv heads a rank's q heads ``h0 .. h0 + hq_local - 1`` read, from
    local k/v holding all ``kvh`` heads or the shard aligned with q's."""
    if hq_local == hq or k.shape[2] < kvh:
        return k, v
    g = hq // kvh
    if hq_local % g == 0:
        heads = slice(h0 // g, (h0 + hq_local) // g)
        return k[:, :, heads], v[:, :, heads]
    idx = torch.arange(h0, h0 + hq_local, device=k.device) // g
    return k[:, :, idx], v[:, :, idx]


def _attend(q, k, v, positions, window, chunk, shd):
    """``chunked_attention`` over the sequence, on each rank's shards:
    its q heads (or its q positions under context parallelism) against all
    keys of the kv heads they read."""
    hq, kvh, s = q.shape[2], k.shape[2], q.shape[1]

    def fn(ql, kl, vl, pos):
        assert kl.shape[1] == s, "keys must not be sharded over the sequence"
        c = shd.coord("model")
        h0 = c * ql.shape[2] if ql.shape[2] < hq else 0
        kl, vl = _local_kv(kl, vl, hq, kvh, h0, ql.shape[2])
        n = ql.shape[1]
        qpos = pos[c * n:(c + 1) * n] if n < s else pos
        return chunked_attention(ql, kl, vl, qpos, pos, window, chunk)

    sigs = (("bthd", "btkd", "btkd") if shd.divisible(hq)
            else ("bS..", "bt..", "bt.."))
    return shd.local(fn, [q, k, v, positions], [*sigs, None], sigs[0])


def _offset(buf, dim: int) -> int:
    """This rank's first index along ``dim`` of a DTensor's shard."""
    return local_span(buf.shape[dim], buf.device_mesh, buf.placements, dim)[0]


@torch.no_grad()
def _owned_write(buf, vals, positions, dim: int) -> None:
    """Write ``vals`` (its ``dim`` running over ``positions``) into the ring
    buffer ``buf`` (a DTensor, ``dim`` its slots): the last ``slots``
    positions, each at slot ``position % slots``, and each rank only the
    slots of its shard.  The written positions are consecutive (prefill's
    0..S-1, or decode's one), so each local slot's source is found by
    arithmetic and written by a masked ``where``: static shapes, no host
    sync."""
    mesh = buf.device_mesh
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p
            for p in buf.placements]
    vl = vals.redistribute(mesh, want).to_local() if isinstance(
        vals, DTensor) else vals
    bl = buf.to_local()
    slots, n, lo = buf.shape[dim], bl.shape[dim], _offset(buf, dim)
    keep = min(vals.shape[dim], slots)
    tail = vl.narrow(dim, vl.shape[dim] - keep, keep)
    # index into the tail of the position each local slot takes
    t = (lo + torch.arange(n, device=bl.device)
         - positions[-keep].long()) % slots
    shape = [1] * bl.dim()
    shape[dim] = n
    src = tail.index_select(dim, t.clamp(max=keep - 1))
    bl.copy_(torch.where((t < keep).reshape(shape), src.to(bl.dtype), bl))


def _decode_sharded(q, cache, pos, window, shd):
    """Decode attention on the cache's shards.  q is brought to the cache's
    batch and head sharding; where the cache's slots are sharded, each rank
    attends over its slots and the max, the softmax's sum and the weighted
    values are reduced over the slot shards."""
    mesh = shd.mesh
    kc, vc, ap = cache["k"], cache["v"], cache["abs_pos"]
    split = [i for i, p in enumerate(kc.placements)
             if isinstance(p, Shard) and p.dim == 1]
    qpl = [Replicate() if i in split else p
           for i, p in enumerate(kc.placements)]
    ql = q.redistribute(mesh, qpl).to_local()
    kl, vl = kc.to_local(), vc.to_local()
    lo, n = _offset(kc, 1), kl.shape[1]
    apl = ap.full_tensor() if isinstance(ap, DTensor) else ap
    apl = apl[lo:lo + n]
    if not split:
        out = decode_attention(ql, kl, vl, apl, pos, window)
    else:
        groups = [mesh.get_group(i) for i in split]
        b, _, h, hd = ql.shape
        kvh = kl.shape[2]
        qg = ql.reshape(b, kvh, h // kvh, hd).float()
        sc = torch.einsum("bkgd,bskd->bkgs", qg, kl.float()) * hd**-0.5
        ok = (apl <= pos) & (apl >= 0)
        if window is not None:
            ok &= apl > (pos - window)
        sc = torch.where(ok[None, None, None, :], sc, NEG_INF)
        m = torch.amax(sc, dim=-1)
        for g in groups:
            m = funcol.all_reduce(m, "max", g)
        p = torch.exp(sc - m[..., None])
        den = torch.sum(p, dim=-1)
        acc = torch.einsum("bkgs,bskd->bkgd", p.to(vl.dtype).float(),
                           vl.float())
        for g in groups:
            den = funcol.all_reduce(den, "sum", g)
            acc = funcol.all_reduce(acc, "sum", g)
        out = (acc / den[..., None]).reshape(b, 1, h, hd).to(ql.dtype)
    return DTensor.from_local(out, mesh, qpl, run_check=False)


def _attn_sharded(q, k, v, positions, cache, window, chunk, shd):
    """The attention core and cache writes under a mesh."""
    s = q.shape[1]
    if cache is None:
        return _attend(q, k, v, positions, window, chunk, shd), None
    if s > 1:
        out = _attend(q, k, v, positions, window, chunk, shd)
    for name, val in (("k", k), ("v", v)):
        _owned_write(cache[name], val, positions, 1)
    _owned_write(cache["abs_pos"], positions.to(torch.int32), positions, 0)
    if s == 1:
        out = _decode_sharded(q, cache, positions[0], window, shd)
    return out, cache


def attn_apply(p, x, positions, cfg, cache: dict | None = None,
               window: int | None = None, chunk: int = 1024, shd=None):
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
    q = _split_heads(q, hq, hd, shd)
    k = _split_heads(k, cfg.n_kv_heads, hd, shd)
    v = _split_heads(v, cfg.n_kv_heads, hd, shd)
    if shd is not None:
        if shd.divisible(hq):
            # tensor parallelism over heads (kv sharding fitted automatically)
            q = shd.act(q, "bthd")
            k = shd.act(k, "btkd")
            v = shd.act(v, "btkd")
        elif s > 1:
            # head count does not divide the model axis: context parallelism
            q = shd.act(q, "bS..")
            k = shd.act(k, "bt..")
            v = shd.act(v, "bt..")
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if shd is not None:
        out, cache = _attn_sharded(q, k, v, positions, cache, window, chunk,
                                   shd)
    elif cache is None:
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
    if shd is not None and not shd.divisible(hq):
        # gather the sequence (context parallelism) before the output
        # projection, and keep the heads' features whole in its backward:
        # DTensor cannot fold a batch and a sequence sharded over two mesh
        # dims into the rows of one product, nor split a feature dim
        # sharded over an axis the head count does not divide
        out = shd.act(out, "bt.")
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
