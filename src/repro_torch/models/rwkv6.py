"""RWKV-6 "Finch" block: time mixing with data-dependent decay + squared-ReLU
channel mixing.  [arXiv:2404.05892]

The port of ``repro/models/rwkv6.py``.  State per layer: the token-shift
vectors of both mixers and the (H, hd, hd) wkv matrix state, which stays in
float32 in every dtype.  The time recurrence

    out_t[j] = sum_i r_t[i] (S[i,j] + u[i] k_t[i] v_t[j])
    S       <- diag(w_t) S + k_t v_t^T

runs chunked (``_wkv_chunked``: T = 16 tokens a step, centred exponents,
the +-80 clip) with every projection and the decay LoRA computed for the
whole sequence first.  Decode is the same function at S = 1.

Under a mesh the family is ``dp_only`` (the reference's §Perf R2): the
batch is sharded over every axis and the parameters are FSDP-sharded only,
with no ``act`` calls, as in the reference.  Every op of a layer then works
within a batch row, so the whole layer runs on each rank's rows with its
weights gathered (``Sharder.local``): the chunked WKV (cumsums, a masked
``where``, the chunk loop), the group norm and the low-rank projections'
reshapes, which DTensor would otherwise shard along the free dims it
picks and then fail to reshape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import const, normal, params_of, rmsnorm

__all__ = ["RWKV", "rwkv_empty_state", "rwkv_layer_apply", "wkv_sequential"]

_MAA_RANK = 32
_DECAY_RANK = 64


class RWKV(nn.Module):
    """One RWKV-6 layer's weights under the reference's leaf names."""

    def __init__(self, cfg, gen, dtype, device):
        super().__init__()
        d = cfg.d_model
        h, hd = cfg.n_heads, cfg.hd
        assert h * hd == d, "rwkv requires n_heads * head_dim == d_model"
        f = cfg.d_ff
        s = d**-0.5

        def n(shape, sc=s):
            return normal(gen, shape, sc, dtype, device)

        def c(shape, value):
            return const(shape, value, dtype, device)

        self.ln1 = c((d,), 0.0)
        self.ln2 = c((d,), 0.0)
        self.maa_x = c((d,), 0.0)
        self.maa_base = c((5, d), 0.0)  # w, k, v, r, g
        self.maa_w1 = n((d, 5 * _MAA_RANK), 1e-2)
        self.maa_w2 = n((5, _MAA_RANK, d), 1e-2)
        self.decay_base = c((d,), -6.0)
        self.decay_w1 = n((d, _DECAY_RANK), 1e-2)
        self.decay_w2 = n((_DECAY_RANK, d), 1e-2)
        self.faaaa = c((h, hd), 0.0)  # per-head bonus u
        self.rwkv_wr = n((d, d))
        self.rwkv_wk = n((d, d))
        self.rwkv_wv = n((d, d))
        self.rwkv_wg = n((d, d))
        self.rwkv_wo = n((d, d))
        self.lnx_scale = c((d,), 1.0)
        self.lnx_bias = c((d,), 0.0)
        self.cm_maa_k = c((d,), 0.0)
        self.cm_maa_r = c((d,), 0.0)
        self.cm_wk = n((d, f))
        self.cm_wv = n((f, d), f**-0.5)
        self.cm_wr = n((d, d))

    def forward(self, x, state, cfg, shd=None):
        return rwkv_layer_apply(params_of(self), x, state, cfg, shd)


def rwkv_empty_state(cfg, batch: int, dtype, device) -> dict:
    h, hd = cfg.n_heads, cfg.hd
    return {
        "shift_tm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "shift_cm": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((batch, h, hd, hd), dtype=torch.float32,
                           device=device),
    }


def _token_shift(x, prev):
    """sx_t = x_{t-1} - x_t with the carried previous token."""
    shifted = torch.cat([prev[:, None, :], x[:, :-1, :]], dim=1)
    return shifted - x


def _group_norm(x, h: int, scale, bias, eps: float = 64e-5):
    b, s, d = x.shape
    xg = x.reshape(b, s, h, d // h).float()
    mu = xg.mean(-1, keepdim=True)
    var = xg.var(-1, keepdim=True, correction=0)  # population variance
    xg = (xg - mu) * torch.rsqrt(var + eps)
    return (xg.reshape(b, s, d) * scale + bias).to(x.dtype)


_CHUNK = 16  # intra-chunk parallel span
_EXP_CLAMP = 80.0  # guard clip on the centred exponents


def wkv_sequential(r, k, v, logw, u, S0):
    """Token-by-token WKV oracle (tests only: S sequential steps)."""
    S = S0
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, lw_t = r[:, t], k[:, t], v[:, t], logw[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]
        outs.append(torch.einsum("bhi,bhij->bhj", r_t, S + u[..., None] * kv))
        S = torch.exp(lw_t)[..., None] * S + kv
    return torch.stack(outs, dim=1), S


def _wkv_chunked(r, k, v, logw, u, S0):
    """Chunked-parallel WKV recurrence, T = 16 tokens a step:

      out_t = (r_t * e^{cum0_t}) S_0                       (cross-chunk)
            + sum_{tau<t} <r_t e^{cum0_t}, k_tau e^{-cum_tau}> v_tau  (intra)
            + <r_t * u, k_t> v_t                           (current token)
      S'    = e^{cum_T} * S_0 + sum_tau (k_tau e^{cum_T - cum_tau}) v_tau^T

    cum is the inclusive cumsum of log-decay (<= 0), cum0 the exclusive one;
    both factors of the intra term are centred at half the chunk-total decay
    and clipped to +-80, as in the reference.

    r/k/v/logw (B, S, H, hd) float32; u (H, hd); S0 (B, H, hd, hd).
    Returns (out (B, S, H, hd), S_final)."""
    b, s, h, hd = r.shape
    t = min(_CHUNK, s)
    pad = (-s) % t
    if pad:
        z = lambda x: F.pad(x, (0, 0, 0, 0, 0, pad))  # noqa: E731
        r, k, v, logw = z(r), z(k), z(v), z(logw)
    nc = r.shape[1] // t

    def to_chunks(x):  # (B, S, H, hd) -> (nc, B, H, T, hd)
        return x.reshape(b, nc, t, h, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc = map(to_chunks, (r, k, v, logw))
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=r.device),
                      diagonal=-1)  # strict lower
    S = S0
    outs = []
    for i in range(nc):
        rt, kt, vt, lw = rc[i], kc[i], vc[i], wc[i]  # (B, H, T, hd)
        cum = torch.cumsum(lw, dim=2)  # inclusive
        cum0 = cum - lw  # exclusive
        c = cum[:, :, -1:, :] * 0.5  # centre: half the chunk-total decay
        r_dec = rt * torch.exp(cum0)
        r_ctr = rt * torch.exp(torch.clamp(cum0 - c, -_EXP_CLAMP, _EXP_CLAMP))
        k_ctr = kt * torch.exp(torch.clamp(c - cum, -_EXP_CLAMP, _EXP_CLAMP))
        # where (not a multiply): masked entries may hold inf products
        A = torch.where(mask, torch.einsum("bhti,bhsi->bhts", r_ctr, k_ctr),
                        0.0)
        diag = torch.einsum("bhti,bhti->bht", rt * u[None, :, None, :], kt)
        out = (
            torch.einsum("bhts,bhsj->bhtj", A, vt)
            + diag[..., None] * vt
            + torch.einsum("bhti,bhij->bhtj", r_dec, S)
        )
        k_end = kt * torch.exp(cum[:, :, -1:, :] - cum)
        S = torch.exp(cum[:, :, -1, :])[..., None] * S + torch.einsum(
            "bhti,bhtj->bhij", k_end, vt)
        outs.append(out)
    # (nc, B, H, T, hd) -> (B, S, H, hd)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, nc * t, h, hd)
    return out[:, :s], S


def _time_mix(p, x, state, cfg):
    b, s, d = x.shape
    h, hd = cfg.n_heads, cfg.hd
    sx = _token_shift(x, state["shift_tm"])
    xxx = x + sx * p["maa_x"]
    # 5-way data-dependent interpolation deltas
    r5 = torch.tanh(xxx @ p["maa_w1"]).reshape(b, s, 5, _MAA_RANK)
    deltas = torch.einsum("bsfr,frd->bsfd", r5, p["maa_w2"])  # (B,S,5,D)
    mix = p["maa_base"][None, None] + deltas
    xw, xk, xv, xr, xg = [x + sx * mix[:, :, i] for i in range(5)]

    r = (xr @ p["rwkv_wr"]).reshape(b, s, h, hd)
    k = (xk @ p["rwkv_wk"]).reshape(b, s, h, hd)
    v = (xv @ p["rwkv_wv"]).reshape(b, s, h, hd)
    g = F.silu(xg @ p["rwkv_wg"])
    # data-dependent decay w = exp(-exp(dd)) in (0, 1); log w = -exp(dd)
    dd = p["decay_base"] + torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    logw = -torch.exp(dd.float()).reshape(b, s, h, hd)
    u = p["faaaa"].float()

    out, S_fin = _wkv_chunked(r.float(), k.float(), v.float(), logw, u,
                              state["wkv"])
    out = out.reshape(b, s, d)
    out = _group_norm(out, h, p["lnx_scale"], p["lnx_bias"])
    out = (out * g).to(x.dtype) @ p["rwkv_wo"]
    return out, {"shift_tm": x[:, -1, :], "wkv": S_fin}


def _channel_mix(p, x, state):
    sx = _token_shift(x, state["shift_cm"])
    xk = x + sx * p["cm_maa_k"]
    xr = x + sx * p["cm_maa_r"]
    kk = torch.square(torch.relu(xk @ p["cm_wk"]))
    out = torch.sigmoid(xr @ p["cm_wr"]) * (kk @ p["cm_wv"])
    return out, {"shift_cm": x[:, -1, :]}


def _layer(p, x, state, cfg):
    h1, st_tm = _time_mix(p, rmsnorm(x, p["ln1"], cfg.norm_eps), state, cfg)
    x = x + h1
    h2, st_cm = _channel_mix(p, rmsnorm(x, p["ln2"], cfg.norm_eps), state)
    x = x + h2
    return x, {**st_tm, **st_cm}


#: The state's leaves and their signatures (batch rows first).
_STATE_SIGS = {"shift_tm": "b.", "shift_cm": "b.", "wkv": "b..."}


def rwkv_layer_apply(p, x, state, cfg, shd=None):
    """One full RWKV-6 layer.  x (B, S, D).  Returns (y, new_state).

    Under a mesh (``dp_only``: the batch over every axis) the layer runs on
    each rank's batch rows with its weights gathered (``Sharder.local``):
    FSDP, whose weight gradients reduce over the batch's ranks."""
    if shd is None:
        return _layer(p, x, state, cfg)
    names, keys = list(p), list(_STATE_SIGS)

    def fn(xl, *rest):
        y, st = _layer(dict(zip(names, rest[:len(names)])), xl,
                       dict(zip(keys, rest[len(names):])), cfg)
        return (y, *(st[k] for k in keys))

    y, *st = shd.local(
        fn, [x, *p.values(), *(state[k] for k in keys)],
        ["btd", *("." * t.dim() for t in p.values()),
         *_STATE_SIGS.values()],
        ("btd", *_STATE_SIGS.values()))
    return y, dict(zip(keys, st))
