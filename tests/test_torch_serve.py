"""The port's serving path (``repro_torch.models`` + ``launch.serve``) against
the reference, for all ten architectures at ``reduced()`` in float32.

Both sides serve the same weights: the reference's ``init_params`` output,
converted by ``convert.lm_params_from_numpy``, and the same numpy-drawn
tokens (the port draws its own weights, prompts and stub embeddings from
``torch.Generator``, so parity holds through the converter and given
inputs).  Per architecture: the prefill logits and every cache tensor after
a 28-token prefill (windowed caches of 16 slots wrap there), then 6 greedy
decode steps (positions 28-33: past the second wrap), each side feeding its
own argmax token: logits within rtol 1e-4, atol 2e-5, caches within rtol
1e-4, atol 5e-5 (the RWKV wkv state is a sum over the whole prompt),
positions exactly, the greedy tokens equal.  ``loss_fn``'s forward (loss,
CE, MoE aux) within rtol 1e-4, in each batch form (tokens; the VLM prefix;
audio embeddings with labels).  Those bounds are ten times inside the
reference's own decode-against-prefill test (rtol 1e-3, atol 1e-4), which
the port passes on its own here with the same bound.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.models import decode_step as ref_decode
from repro.models import init_params as ref_init
from repro.models import loss_fn as ref_loss
from repro.models import prefill as ref_prefill
from repro_torch import configs
from repro_torch.convert import _PERIOD_PARTS, _lm_leaves, lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import (
    LM,
    decode_step,
    init_cache,
    init_params,
    layer_kinds,
    loss_fn,
    prefill,
)
from repro_torch.models.frontends import (
    encodec_stub_embeddings,
    vit_stub_embeddings,
)

ALL_ARCHS = ref_configs.names()
KEY = jax.random.PRNGKey(0)
LOGIT_TOL = dict(rtol=1e-4, atol=2e-5)
CACHE_TOL = dict(rtol=1e-4, atol=5e-5)
PROMPT, STEPS = 28, 6


def _cfgs(arch):
    return ref_configs.get(arch).reduced(), configs.get(arch).reduced()


def _models(arch):
    rcfg, cfg = _cfgs(arch)
    params = ref_init(rcfg, KEY, jnp.float32)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return rcfg, cfg, params, lm_params_from_numpy(cfg, tree, device="cpu")


def _close(got, want, tol):
    if isinstance(got, torch.Tensor):  # loss_fn's outputs carry a graph
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def _greedy(logits, vocab):
    return np.argmax(np.asarray(logits)[:, :vocab], axis=-1)


def lm_cache_from_numpy(cfg, caches) -> list:
    """The reference's decode caches (stacked per family; the hybrid's
    ``(periods, tail)`` pair) as the port's per-layer list on the CPU."""

    def unstack(sub: dict) -> list:
        n = np.shape(next(iter(sub.values())))[0]
        return [{k: torch.tensor(np.asarray(v[i])) for k, v in sub.items()}
                for i in range(n)]

    if cfg.family != "rglru_hybrid":
        return unstack(caches)
    period_c, tail_c = caches
    parts = [unstack(period_c[p]) for p in _PERIOD_PARTS]
    layers = [c for trio in zip(*parts) for c in trio]
    return layers + (unstack(tail_c) if tail_c is not None else [])


def _same_caches(cfg, got, want_tree):
    want = lm_cache_from_numpy(cfg, want_tree)
    assert len(got) == len(want) == cfg.n_layers
    for layer, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w), layer
        for k in w:
            assert g[k].dtype == w[k].dtype, (layer, k)
            if k == "abs_pos":
                np.testing.assert_array_equal(g[k].numpy(), w[k].numpy())
            else:
                _close(g[k], w[k], CACHE_TOL)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_prefill_caches_and_greedy_decode_match_reference(arch):
    rcfg, cfg, params, model = _models(arch)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    max_len = PROMPT + STEPS
    jit_prefill = jax.jit(lambda p, t: ref_prefill(
        p, {"tokens": t}, rcfg, max_len=max_len, dtype=jnp.float32))
    jit_decode = jax.jit(lambda p, c, t, pos: ref_decode(
        p, c, t, pos, rcfg, dtype=jnp.float32))

    want, rc = jit_prefill(params, jnp.asarray(toks))
    got, tc = prefill(model, {"tokens": torch.tensor(toks)}, max_len=max_len)
    assert got.shape == (2, cfg.vocab_padded)
    _close(got, want, LOGIT_TOL)
    _same_caches(cfg, tc, rc)
    for i in range(STEPS):
        wt, gt = _greedy(want, cfg.vocab_size), _greedy(got, cfg.vocab_size)
        np.testing.assert_array_equal(gt, wt)
        want, rc = jit_decode(params, rc, jnp.asarray(wt, jnp.int32),
                              jnp.int32(PROMPT + i))
        got, tc = decode_step(model, tc, torch.tensor(gt), PROMPT + i)
        _close(got, want, LOGIT_TOL)
    _same_caches(cfg, tc, rc)


def _batch(cfg, rng, b=2, s=24):
    """The arch's batch form as numpy: tokens; VLM prefix + tokens; audio
    embeddings + labels (with masked labels)."""
    if cfg.frontend == "vit":
        return {"inputs_embeds": (rng.standard_normal((b, 8, cfg.d_model))
                                  * 0.02).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, s - 8))}
    if cfg.frontend == "encodec":
        labels = rng.integers(0, cfg.vocab_size, (b, s))
        labels[0, :3] = -1
        return {"inputs_embeds": (rng.standard_normal((b, s, cfg.d_model))
                                  * 0.02).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s))}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_fn_forward_matches_reference(arch):
    rcfg, cfg, params, model = _models(arch)
    batch = _batch(cfg, np.random.default_rng(2))
    want, wm = jax.jit(lambda p, b: ref_loss(p, b, rcfg, dtype=jnp.float32))(
        params, jax.tree_util.tree_map(jnp.asarray, batch))
    got, gm = loss_fn(model, {k: torch.tensor(v) for k, v in batch.items()})
    assert got.shape == () and torch.isfinite(got)
    _close(got, want, dict(rtol=1e-4, atol=0))
    _close(gm["ce"], wm["ce"], dict(rtol=1e-4, atol=0))
    _close(gm["aux"], wm["aux"], dict(rtol=1e-4, atol=1e-7))
    if cfg.family == "moe":
        assert float(gm["aux"]) > 0


@pytest.mark.parametrize("arch", ["internvl2-1b", "musicgen-medium"])
def test_prefill_of_the_frontend_batch_forms(arch):
    rcfg, cfg, params, model = _models(arch)
    batch = _batch(cfg, np.random.default_rng(3))
    want, rc = ref_prefill(params, jax.tree_util.tree_map(jnp.asarray, batch),
                           rcfg, max_len=30, dtype=jnp.float32)
    got, tc = prefill(model, {k: torch.tensor(v) for k, v in batch.items()},
                      max_len=30)
    _close(got, want, LOGIT_TOL)
    _same_caches(cfg, tc, rc)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_decode_matches_prefill_on_the_port(arch):
    """Teacher forcing: decode with the cache == a fresh prefill (the
    reference's own test and bound, drop-free MoE capacity)."""
    cfg = configs.get(arch).reduced()
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=100.0)
    model = init_params(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 36), generator=gen)
    sp = 32
    _, cache = prefill(model, {"tokens": toks[:, :sp]}, max_len=36)
    for i in range(3):
        want, _ = prefill(model, {"tokens": toks[:, :sp + i + 1]}, max_len=36)
        got, cache = decode_step(model, cache, toks[:, sp + i], sp + i)
        _close(got, want, dict(rtol=1e-3, atol=1e-4))


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "mixtral-8x22b",
                                  "recurrentgemma-2b"])
def test_serve_main_on_the_cpu(arch):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        toks = serve.main(["--arch", arch, "--reduced", "--batch", "3",
                           "--prompt-len", "20", "--max-new", "5",
                           "--device", "cpu"])
    cfg = configs.get(arch).reduced()
    assert toks.shape == (3, 5)
    assert bool(torch.all((toks >= 0) & (toks < cfg.vocab_size)))
    lines = out.getvalue().splitlines()
    assert lines[0] == f"arch={cfg.name} batch=3 prompt=20"
    assert lines[1].startswith("prefill: ") and "ms/token" in lines[1]
    assert lines[2] == f"sample token ids: {toks[0].tolist()}"
    # the same run through generate() with the same prompts and weights
    model = init_params(cfg, seed=0, device="cpu")
    prompts = torch.randint(0, cfg.vocab_size, (3, 20),
                            generator=torch.Generator().manual_seed(0))
    again = serve.generate(model, prompts, 5)
    assert torch.equal(again.tokens, toks)
    assert again.prefill_ms > 0 and again.decode_ms_per_token > 0


def test_generate_masks_the_padded_vocab():
    cfg = configs.get("rwkv6-1.6b").reduced()
    cfg = dataclasses.replace(cfg, vocab_size=300)  # padded to 512
    model = init_params(cfg, seed=0, device="cpu")
    with torch.no_grad():
        model.lm_head[:, 300:] = 100.0  # padded ids would win the argmax
    prompts = torch.randint(0, 300, (2, 8),
                            generator=torch.Generator().manual_seed(0))
    toks = serve.generate(model, prompts, 4).tokens
    assert bool(torch.all(toks < 300))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_equal_the_reference(arch):
    for reduce in (False, True):
        ref, got = ref_configs.get(arch), configs.get(arch)
        if reduce:
            ref, got = ref.reduced(), got.reduced()
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        for attr in ("hd", "vocab_padded", "is_subquadratic"):
            assert getattr(got, attr) == getattr(ref, attr), attr
        assert got.param_count() == ref.param_count()
        assert got.active_param_count() == ref.active_param_count()


def test_registry_names():
    assert configs.names() == ref_configs.names()
    assert len(configs.names()) == 10


@pytest.mark.parametrize("arch", ["qwen2.5-32b", "rwkv6-1.6b",
                                  "recurrentgemma-2b", "qwen2-moe-a2.7b"])
def test_init_params_matches_the_reference_layout(arch):
    """The port draws its own weights: same leaves and shapes as the
    reference, the same constants, the same scales (the sample standard
    deviations of every leaf of 4096 or more entries within 10 % of the
    reference's: about 6 standard errors)."""
    rcfg, cfg = _cfgs(arch)
    model = init_params(cfg, seed=0, device="cpu")
    ref = jax.tree_util.tree_map(np.asarray, ref_init(rcfg, KEY, jnp.float32))
    leaves = _lm_leaves(cfg, ref)
    params = dict(model.named_parameters())
    assert set(params) == set(leaves)
    for name, p in params.items():
        want = leaves[name]
        assert tuple(p.shape) == want.shape, name
        if np.all(want == want.flat[0]):
            assert torch.all(p == float(want.flat[0])), name
        elif want.size >= 4096 and not name.endswith(("wq", "wo")):
            assert abs(float(p.std()) / float(want.std()) - 1) < 0.1, name
    assert sum(p.numel() for p in params.values()) == sum(
        a.size for a in jax.tree_util.tree_leaves(ref))
    assert layer_kinds(cfg) == [k for k in model.kinds]


def test_hybrid_layer_order_at_full_depth():
    cfg = configs.get("recurrentgemma-2b")
    kinds = layer_kinds(cfg)
    assert len(kinds) == 26
    assert kinds[:24] == ["rec", "rec", "attn"] * 8
    assert kinds[24:] == ["rec", "rec"]


def test_lm_params_from_numpy_refuses_bad_trees():
    rcfg, cfg = _cfgs("minitron-8b")
    tree = jax.tree_util.tree_map(np.asarray, ref_init(rcfg, KEY, jnp.float32))
    bad = dict(tree, extra=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="unknown leaves"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    bad = dict(tree)
    del bad["final_norm"]
    with pytest.raises(ValueError, match="missing leaves"):
        lm_params_from_numpy(cfg, bad, device="cpu")
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["layers"]["mlp"]["w1"] = bad["layers"]["mlp"]["w1"][:, :, :5]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(cfg, bad, device="cpu")


def test_stub_frontends_shapes():
    gen = torch.Generator().manual_seed(0)
    v = vit_stub_embeddings(gen, 2, 64, 8, torch.float32, "cpu")
    e = encodec_stub_embeddings(gen, 2, 5, 64, torch.float32, "cpu")
    assert v.shape == (2, 8, 64) and e.shape == (2, 5, 64)
    assert 0.01 < float(v.std()) < 0.03


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    cfg = configs.get("rwkv6-1.6b").reduced()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--reduced"])
