"""The port's model modules (``repro_torch.models``) against the reference's,
module by module, on the CPU in float32.

Every input and weight is drawn with numpy from a fixed seed and handed to
both sides; the reference's zero- and constant-initialised leaves (norm
scales, biases, interpolation bases, the RWKV bonus) are given random values
too, so every term is exercised.  Tolerances (float32; the two sides run the
same formulas, summing in orders that may differ):

- rmsnorm, rope, mlp, cross-entropy: rtol 1e-5, atol 1e-6;
- attention (chunked, decode, the sublayer with its cache writes): rtol
  1e-5, atol 1e-5; the caches' positions exactly;
- MoE (both paths): rtol 1e-5, atol 1e-5; the aux loss rtol 1e-6.  Ties in
  top-k are impossible with continuous random inputs (probability 0); the
  port also breaks them toward the lower expert id like ``jax.lax.top_k``,
  checked on tie-heavy input;
- ``_wkv_chunked``: the largest difference from the reference within 1e-5
  of the output's largest magnitude (the reference's own test measures its
  gap to ``wkv_sequential`` this way, at 1e-4: the centred exponents reach
  e^{+-40} in the strong-decay regimes, where float32 ``exp`` rounding is
  amplified), the states within rtol 1e-5, atol 1e-5; and within the
  reference's 1e-4 of ``wkv_sequential`` in every decay regime; the RWKV
  layer rtol 1e-5, atol 1e-5;
- RG-LRU: the port's ``associative_scan`` is the reference's odd/even
  recursion written with slices, so on the CPU it equals an eager
  ``jax.lax.associative_scan`` bit for bit, and a jitted one (where XLA may
  fuse a multiply-add) within rtol 1e-6, atol 1e-6; the whole block
  (matmuls around it) rtol 1e-5, atol 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get as ref_get
from repro.models import attention as ra
from repro.models import layers as rl
from repro.models import moe as rm
from repro.models import rglru as rg
from repro.models import rwkv6 as rr
from repro_torch.configs import get
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import moe as tm
from repro_torch.models import rglru as tg
from repro_torch.models import rwkv6 as tr
from repro_torch.models.attention import Attention
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.rwkv6 import RWKV

KEY = jax.random.PRNGKey(0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _perturbed(tree, rng, scale=0.05):
    """The reference's init as numpy, every leaf plus noise."""
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + _f32(rng, *np.shape(a), scale=scale), tree)


def _t(tree):
    return jax.tree_util.tree_map(torch.tensor, tree)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def _module_names_match(module, tree):
    names = {n for n, _ in module.named_parameters()}
    flat = {".".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert names == flat


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #


def test_rmsnorm():
    rng = _rng(1)
    x, s = _f32(rng, 3, 5, 64), _f32(rng, 64, scale=0.3)
    _close(tl.rmsnorm(torch.tensor(x), torch.tensor(s), 1e-6),
           rl.rmsnorm(jnp.asarray(x), jnp.asarray(s), 1e-6),
           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    rng = _rng(2)
    x = _f32(rng, 2, 37, 4, 16)
    pos = np.arange(5, 42, dtype=np.int32)
    _close(tl.rope(torch.tensor(x), torch.tensor(pos), theta),
           rl.rope(jnp.asarray(x), jnp.asarray(pos), theta),
           rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    rng = _rng(3)
    p = _perturbed(rl.mlp_init(KEY, 64, 128), rng)
    x = _f32(rng, 2, 9, 64)
    module = tl.MLP(64, 128, None, torch.float32, "cpu")
    _module_names_match(module, p)
    _close(tl.mlp(_t(p), torch.tensor(x), act),
           rl.mlp(_j(p), jnp.asarray(x), act), rtol=1e-5, atol=1e-6)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    _close(tl._act(x, "gelu"), want, rtol=1e-6, atol=1e-6)
    assert not np.allclose(torch.nn.functional.gelu(x).numpy(), want,
                           rtol=1e-6, atol=1e-6)


def test_softmax_cross_entropy_with_masked_labels():
    rng = _rng(4)
    logits = _f32(rng, 3, 11, 50, scale=3.0)
    labels = rng.integers(0, 50, (3, 11)).astype(np.int32)
    labels[0, :4] = -1
    labels[2, 7] = -1
    for z in (0.0, 1e-4):
        _close(tl.softmax_cross_entropy(torch.tensor(logits),
                                        torch.tensor(labels), z),
               rl.softmax_cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(labels), z),
               rtol=1e-5, atol=1e-6)
    none = np.full_like(labels, -1)
    assert float(tl.softmax_cross_entropy(torch.tensor(logits),
                                          torch.tensor(none))) == 0.0


# --------------------------------------------------------------------------- #
# attention
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("sq,sk,chunk,window,holes", [
    (37, 37, 8, None, False),   # several chunks, padding 3
    (37, 37, 8, 10, False),     # a sliding window across chunk edges
    (20, 29, 16, 6, True),      # invalid keys (-1) and a window
    (5, 5, 1024, None, False),  # one chunk, clipped to Sk
])
def test_chunked_attention(sq, sk, chunk, window, holes):
    rng = _rng(5)
    h, kvh, hd = 4, 2, 16
    q = _f32(rng, 2, sq, h, hd)
    k, v = _f32(rng, 2, sk, kvh, hd), _f32(rng, 2, sk, kvh, hd)
    qpos = np.arange(sk - sq, sk, dtype=np.int32)
    kpos = np.arange(sk, dtype=np.int32)
    if holes:
        kpos[[0, 3, 11]] = -1
    got = ta.chunked_attention(torch.tensor(q), torch.tensor(k),
                               torch.tensor(v), torch.tensor(qpos),
                               torch.tensor(kpos), window, chunk)
    want = ra.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(qpos),
                                jnp.asarray(kpos), window, chunk)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 7])
def test_decode_attention(window):
    rng = _rng(6)
    q = _f32(rng, 3, 1, 4, 16)
    kc, vc = _f32(rng, 3, 12, 1, 16), _f32(rng, 3, 12, 1, 16)
    ap = np.array([12, 13, 2, 3, 4, 5, 6, 7, 8, -1, 10, 11], np.int32)
    pos = 13
    _close(ta.decode_attention(torch.tensor(q), torch.tensor(kc),
                               torch.tensor(vc), torch.tensor(ap), pos,
                               window),
           ra.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(ap),
                               jnp.int32(pos), window))


def _attn_cfg():
    # qkv biases, GQA 4:2 and a padded q-head (head_pad) at reduced width
    return dataclasses.replace(ref_get("qwen2.5-32b").reduced(), head_pad=2)


def _port_cfg(ref_cfg):
    base = get(ref_cfg.name.removesuffix("-smoke")).reduced()
    fields = {f.name: getattr(ref_cfg, f.name)
              for f in dataclasses.fields(ref_cfg)}
    return dataclasses.replace(base, **fields)


@pytest.mark.parametrize("s,max_len,window", [
    (12, 40, None),   # s < slots: prefix write
    (16, 40, 16),     # s == slots
    (32, 48, 16),     # s % slots == 0: the slot-aligned tail
    (24, 40, 16),     # general scatter into the ring
])
def test_attention_sublayer_cache_branches_and_decode(s, max_len, window):
    rng = _rng(7)
    rcfg = _attn_cfg()
    cfg = _port_cfg(rcfg)
    p = _perturbed(ra.attn_init(KEY, rcfg), rng)
    module = Attention(cfg, None, torch.float32, "cpu")
    _module_names_match(module, p)
    pt, pj = _t(p), _j(p)
    x = _f32(rng, 2, s + 10, rcfg.d_model)
    pos = np.arange(s, dtype=np.int32)

    rc = ra.make_kv_cache(rcfg, 2, max_len, window, jnp.float32)
    tc = ta.make_kv_cache(cfg, 2, max_len, window, torch.float32, "cpu")
    ref_apply = jax.jit(ra.attn_apply, static_argnums=(3, 5))
    want, rc = ref_apply(pj, jnp.asarray(x[:, :s]), jnp.asarray(pos),
                             rcfg, rc, window)
    got, tc = ta.attn_apply(pt, torch.tensor(x[:, :s]), torch.tensor(pos),
                            cfg, tc, window)
    _close(got, want)
    _close(tc["k"], rc["k"])
    _close(tc["v"], rc["v"])
    np.testing.assert_array_equal(tc["abs_pos"].numpy(), rc["abs_pos"])
    # decode 10 tokens: past the ring's wrap when windowed
    for i in range(10):
        t = s + i
        xi = x[:, t:t + 1]
        want, rc = ref_apply(pj, jnp.asarray(xi), jnp.int32([t]), rcfg,
                             rc, window)
        got, tc = ta.attn_apply(pt, torch.tensor(xi),
                                torch.tensor([t], dtype=torch.int32), cfg,
                                tc, window)
        _close(got, want)
        _close(tc["k"], rc["k"])
        np.testing.assert_array_equal(tc["abs_pos"].numpy(), rc["abs_pos"])


def test_head_pad_rows_start_dead():
    cfg = dataclasses.replace(get("qwen2.5-32b").reduced(), head_pad=2)
    gen = torch.Generator().manual_seed(0)
    m = Attention(cfg, gen, torch.float32, "cpu")
    live = cfg.n_heads * cfg.hd
    assert torch.all(m.wq[:, live:] == 0) and torch.all(m.wo[live:] == 0)
    assert torch.all(m.wq[:, :live] != 0)
    assert torch.all(m.wq_b == 0)


# --------------------------------------------------------------------------- #
# MoE
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,changes,s", [
    ("mixtral-8x22b", {}, 32),                          # top-2, normalized
    ("mixtral-8x22b", {"capacity_factor": 0.5}, 32),    # drops
    ("qwen2-moe-a2.7b", {}, 24),                        # shared experts
    ("qwen2-moe-a2.7b", {"capacity_factor": 0.75}, 13),  # drops + shared
    ("qwen2-moe-a2.7b", {}, 1),                         # the decode path
    ("mixtral-8x22b", {}, 1),
])
def test_moe_apply(arch, changes, s):
    rng = _rng(8)
    rcfg = dataclasses.replace(ref_get(arch).reduced(), **changes)
    cfg = _port_cfg(rcfg)
    assert cfg.norm_topk_prob == (arch == "mixtral-8x22b")
    p = _perturbed(rm.moe_init(KEY, rcfg), rng)
    module = MoE(cfg, None, torch.float32, "cpu")
    _module_names_match(module, p)
    x = _f32(rng, 3, s, rcfg.d_model)
    got, aux = tm.moe_apply(_t(p), torch.tensor(x), cfg)
    want, waux = jax.jit(rm.moe_apply, static_argnums=2)(
        _j(p), jnp.asarray(x), rcfg)
    _close(got, want)
    _close(aux, waux, rtol=1e-6, atol=0)
    if changes.get("capacity_factor", 1.25) < 1 and s > 1:
        # some pairs really were dropped: the drop-free run differs
        free, _ = tm.moe_apply(_t(p), torch.tensor(x),
                               dataclasses.replace(cfg, capacity_factor=100.0))
        assert not torch.allclose(free, got)


def test_top_k_breaks_ties_toward_the_lower_index():
    rng = _rng(9)
    probs = rng.integers(0, 4, (50, 8)).astype(np.float32) / 4
    vals, idx = tm.top_k(torch.tensor(probs), 3)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))


# --------------------------------------------------------------------------- #
# RWKV-6
# --------------------------------------------------------------------------- #


def _wkv_inputs(rng, b, s, h, hd, lo, hi):
    r, k, v = (_f32(rng, b, s, h, hd) for _ in range(3))
    u = _f32(rng, h, hd)
    S0 = _f32(rng, b, h, hd, hd, scale=0.1)
    logw = -rng.uniform(lo, hi, (b, s, h, hd)).astype(np.float32)
    return r, k, v, logw, u, S0


@pytest.mark.parametrize("lo,hi", [(0.001, 0.5), (0.5, 3.0), (2.0, 6.0),
                                   (5.0, 10.0)])
def test_wkv_chunked(lo, hi):
    args = _wkv_inputs(_rng(10), 2, 45, 3, 8, lo, hi)
    o1, s1 = tr._wkv_chunked(*map(torch.tensor, args))
    o2, s2 = jax.jit(rr._wkv_chunked)(*map(jnp.asarray, args))
    o2 = np.asarray(o2)
    assert np.abs(o1.numpy() - o2).max() <= 1e-5 * np.abs(o2).max()
    _close(s1, s2)
    o3, s3 = tr.wkv_sequential(*map(torch.tensor, args))
    rel = float((o1 - o3).abs().max() / (o3.abs().max() + 1e-9))
    assert rel < 1e-4, (lo, hi, rel)
    _close(s1, s3, rtol=1e-4, atol=1e-4)


def test_wkv_sequential_matches_reference():
    args = _wkv_inputs(_rng(11), 2, 9, 2, 4, 0.1, 2.0)
    o1, s1 = tr.wkv_sequential(*map(torch.tensor, args))
    o2, s2 = rr.wkv_sequential(*map(jnp.asarray, args))
    _close(o1, o2)
    _close(s1, s2)


@pytest.mark.parametrize("s", [1, 21])
def test_rwkv_layer_with_carried_state(s):
    rng = _rng(12)
    rcfg = ref_get("rwkv6-1.6b").reduced()
    cfg = get("rwkv6-1.6b").reduced()
    p = _perturbed(rr.rwkv_init(KEY, rcfg), rng)
    p["decay_base"] = p["decay_base"] + 4.0  # decays well inside (0, 1)
    module = RWKV(cfg, None, torch.float32, "cpu")
    _module_names_match(module, p)
    state = {
        "shift_tm": _f32(rng, 2, rcfg.d_model),
        "shift_cm": _f32(rng, 2, rcfg.d_model),
        "wkv": _f32(rng, 2, rcfg.n_heads, rcfg.hd, rcfg.hd, scale=0.3),
    }
    x = _f32(rng, 2, s, rcfg.d_model)
    got, gst = tr.rwkv_layer_apply(_t(p), torch.tensor(x), _t(state), cfg)
    want, wst = jax.jit(rr.rwkv_layer_apply, static_argnums=3)(
        _j(p), jnp.asarray(x), _j(state), rcfg)
    _close(got, want)
    assert set(gst) == set(wst)
    for k in wst:
        _close(gst[k], wst[k])


def test_group_norm_uses_the_population_variance():
    rng = _rng(13)
    x = _f32(rng, 2, 3, 32)
    sc, bi = _f32(rng, 32), _f32(rng, 32)
    _close(tr._group_norm(torch.tensor(x), 4, torch.tensor(sc),
                          torch.tensor(bi)),
           rr._group_norm(jnp.asarray(x), 4, jnp.asarray(sc),
                          jnp.asarray(bi)))


# --------------------------------------------------------------------------- #
# RG-LRU
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("s", [1, 2, 7, 37])
def test_associative_scan_is_the_reference_recursion(s):
    rng = _rng(14)
    a = rng.uniform(0.2, 0.999, (2, s, 16)).astype(np.float32)
    bx = _f32(rng, 2, s, 16)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    A, X = tg.associative_scan([torch.tensor(a), torch.tensor(bx)], dim=1)
    wA, wX = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(bx)), axis=1)
    np.testing.assert_array_equal(A.numpy(), np.asarray(wA))
    np.testing.assert_array_equal(X.numpy(), np.asarray(wX))
    # under jit XLA may contract a multiply and an add into one FMA
    jA, jX = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(jnp.asarray(a), jnp.asarray(bx))
    _close(A, jA, rtol=1e-6, atol=1e-6)
    _close(X, jX, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("s", [1, 3, 29])
def test_rglru_apply_with_carried_state(s):
    rng = _rng(15)
    rcfg = ref_get("recurrentgemma-2b").reduced()
    cfg = get("recurrentgemma-2b").reduced()
    p = _perturbed(rg.rglru_init(KEY, rcfg), rng)
    module = RGLRU(cfg, None, torch.float32, "cpu")
    _module_names_match(module, p)
    state = {"h": _f32(rng, 2, rcfg.d_model),
             "conv": _f32(rng, 2, 3, rcfg.d_model)}
    x = _f32(rng, 2, s, rcfg.d_model)
    got, gst = tg.rglru_apply(_t(p), torch.tensor(x), _t(state))
    want, wst = jax.jit(rg.rglru_apply)(_j(p), jnp.asarray(x), _j(state))
    _close(got, want)
    _close(gst["h"], wst["h"])
    _close(gst["conv"], wst["conv"])
