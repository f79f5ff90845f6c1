"""The port's training path (``loss_fn``'s backward, ``launch.steps``,
``launch.train``) against the reference, for the ten architectures at
``reduced()`` in float32 on the CPU.

Both sides train the same weights (the reference's ``init_params`` output
through ``convert.lm_params_from_numpy``) on the same numpy-drawn batch, in
each batch form (tokens; the VLM prefix; audio embeddings with masked
labels); the port's results come back in the reference's layout through
``convert.lm_params_to_numpy`` / ``opt_state_to_numpy``.  Bounds, each set
from the largest gap measured over the ten archs (in brackets):

- the loss: rtol 1e-6 [2.2e-7];
- every gradient leaf, ``mu`` and ``nu`` (``mu`` is 0.1 of the clipped
  gradient, ``nu`` 0.05 of its square): the largest difference within
  ``REL`` of the leaf's largest magnitude; ``REL`` is 2e-5 [5.8e-6] and
  2e-4 for RWKV-6 [6.5e-5, its ``maa_base``: the decay's exp(exp()) chain
  through the chunked recurrence amplifies the last-bit differences of
  XLA's ``exp``];
- the global gradient norm: rtol 2e-5 [9.2e-6], 2e-4 for RWKV-6 [6.9e-5];
- the parameters after one AdamW step at lr 1e-3: atol 3e-4 [1.7e-4].
  The first step moves a weight by lr g / (|g| + eps), so an absolute
  gradient gap d at a weight whose gradient is as small as d / 0.1 moves it
  by up to 0.1 lr;
- with int8 error feedback: the error memory within one quantum (the
  block's scale) of the reference's, where a rounding of the same value
  flips between the two; there the weight may move by lr more.

The single-batch step is held against the reference's composition of it
(``make_train_step``'s ``value_and_grad`` of ``loss_fn``, then
``adamw_update``, each jitted), which shares its gradients with the
gradient test; the ``microbatches=2`` and int8 cases run the reference's
jitted ``make_train_step`` itself.  ``remat`` ``none`` / ``full`` /
``dots`` give bit-identical gradients on the CPU (the recomputed forward
repeats the same operations).
"""

import contextlib
import dataclasses
import functools
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.configs as ref_configs
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import init_params as ref_init
from repro.models import loss_fn as ref_loss
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.compression import ef_init as ref_ef_init
from repro_torch import configs
from repro_torch.convert import (
    _lm_tree,
    lm_params_from_numpy,
    lm_params_to_numpy,
    opt_state_to_numpy,
    reference_decay,
)
from repro_torch.launch import train
from repro_torch.launch.serve import generate
from repro_torch.launch.steps import (
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.models import init_params, loss_fn, prefill
from repro_torch.models.transformer import _save_dots
from repro_torch.optim import adamw_init, compress, ef_init

ALL_ARCHS = ref_configs.names()
#: The reference's jitted make_train_step with microbatches (audio, as the
#: reference's own test; MoE; RWKV-6) and with int8 compression (the VLM, as
#: the reference's own test; the hybrid; RWKV-6).
MICROBATCH_ARCHS = ("musicgen-medium", "qwen2-moe-a2.7b", "rwkv6-1.6b")
INT8_ARCHS = ("internvl2-1b", "recurrentgemma-2b", "rwkv6-1.6b")
KEY = jax.random.PRNGKey(0)
LR = 1e-3
LOSS_RTOL = 1e-6
PARAM_ATOL = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rel(arch: str) -> float:
    return 2e-4 if arch.startswith("rwkv6") else 2e-5


def _cfgs(arch):
    return ref_configs.get(arch).reduced(), configs.get(arch).reduced()


def _models(arch, edit=None):
    """The reference's weights (``edit`` may change the numpy tree) on both
    sides: (rcfg, cfg, jax params, port model)."""
    rcfg, cfg = _cfgs(arch)
    tree = jax.tree_util.tree_map(np.asarray, ref_init(rcfg, KEY, jnp.float32))
    if edit is not None:
        edit(tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return rcfg, cfg, params, lm_params_from_numpy(cfg, tree, device="cpu")


def _batch(cfg, seed: int = 3, b: int = 4, s: int = 16) -> dict:
    """The arch's batch form as numpy: tokens; VLM prefix + tokens; audio
    embeddings + labels (some masked)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "vit":
        return {"inputs_embeds": (rng.standard_normal((b, 4, cfg.d_model))
                                  * 0.02).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, s - 4))
                .astype(np.int32)}
    if cfg.frontend == "encodec":
        labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
        labels[0, :3] = -1
        return {"inputs_embeds": (rng.standard_normal((b, s, cfg.d_model))
                                  * 0.02).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _t(batch: dict) -> dict:
    return {k: torch.tensor(v) for k, v in batch.items()}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _leaves(tree) -> list:
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, tree))[0]
    return [(jax.tree_util.keystr(p), v) for p, v in flat]


def _same_tree(got, want, rel: float, what: str):
    """Every leaf of ``got`` within ``rel`` of the matching ``want`` leaf's
    largest magnitude (the same leaves, in the same order)."""
    g, w = _leaves(got), _leaves(want)
    assert [k for k, _ in g] == [k for k, _ in w], what
    for (k, a), (_, b) in zip(g, w):
        assert a.shape == b.shape, (what, k)
        gap = float(np.max(np.abs(a - b), initial=0.0))
        assert gap <= rel * float(np.max(np.abs(b), initial=0.0)) + 1e-30, (
            f"{what} {k}: {gap:.3g} > {rel} of {float(np.abs(b).max()):.3g}")


def _port_grads(model, batch: dict) -> tuple:
    loss, _ = loss_fn(model, batch)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()],
                                allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(names, grads))


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(arch: str):
    """The reference's loss and gradients at the test batch (numpy), once
    per arch and worker."""
    rcfg, cfg, params, _ = _models(arch)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss(p, b, rcfg, dtype=jnp.float32), has_aux=True))(
            params, _j(_batch(cfg)))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_loss_and_gradients_match_reference(arch):
    _, cfg, _, model = _models(arch)
    want, wgrads = _ref_value_and_grad(arch)
    loss, grads = _port_grads(model, _t(_batch(cfg)))
    np.testing.assert_allclose(float(loss), want, rtol=LOSS_RTOL)
    got = _lm_tree(cfg, {n: g.numpy() for n, g in grads.items()})
    _same_tree(got, wgrads, _rel(arch), f"{arch} gradient")
    assert all(p.requires_grad for p in model.parameters())


def _ref_step(rcfg, params, batch, microbatches=1, compression=False):
    step = jax.jit(ref_make_train_step(
        rcfg, None, microbatches=microbatches, lr=LR,
        grad_compression=compression, dtype=jnp.float32))
    if compression:
        return step(params, ref_adamw_init(params), _j(batch),
                    ref_ef_init(params))
    return step(params, ref_adamw_init(params), _j(batch))


def _port_step(cfg, model, batch, microbatches=1, compression=False):
    step = make_train_step(cfg, microbatches=microbatches, lr=LR,
                           grad_compression=compression, dtype=torch.float32)
    opt = adamw_init(model)
    if compression:
        return step(model, opt, _t(batch), ef_init(model))
    return step(model, opt, _t(batch))


def _check_step(arch, cfg, model, opt, metrics, wp, wopt, wmetrics):
    np.testing.assert_allclose(float(metrics["loss"]), float(wmetrics["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(wmetrics["grad_norm"]),
                               rtol=_rel(arch))
    got = opt_state_to_numpy(model, opt)
    assert int(got["step"]) == int(wopt.step) == 1
    _same_tree(got["mu"], wopt.mu, _rel(arch), f"{arch} mu")
    _same_tree(got["nu"], wopt.nu, 2 * _rel(arch), f"{arch} nu")
    return lm_params_to_numpy(model)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step (AdamW with clipping and weight decay)
    from the same weights and batch, against the reference's gradients and
    its ``adamw_update``."""
    _, cfg, params, model = _models(arch)
    want, wgrads = _ref_value_and_grad(arch)
    wp, wopt, stats = jax.jit(ref_adamw_update)(
        jax.tree_util.tree_map(jnp.asarray, wgrads), ref_adamw_init(params),
        params, LR)
    _, opt, m = _port_step(cfg, model, _batch(cfg))
    got = _check_step(arch, cfg, model, opt, m, wp, wopt,
                      {"loss": want, **stats})
    for (k, a), (_, b) in zip(_leaves(got), _leaves(wp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", MICROBATCH_ARCHS)
def test_train_step_with_microbatches_matches_reference(arch):
    """``microbatches=2``: float32 gradients accumulated in order and
    divided by the count, as the reference's scan does."""
    rcfg, cfg, params, model = _models(arch)
    batch = _batch(cfg, seed=4)
    wp, wopt, wm = _ref_step(rcfg, params, batch, microbatches=2)
    _, opt, m = _port_step(cfg, model, batch, microbatches=2)
    got = _check_step(arch, cfg, model, opt, m, wp, wopt, wm)
    for (k, a), (_, b) in zip(_leaves(got), _leaves(wp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_train_step_with_int8_compression_matches_reference(arch):
    """``grad_compression=True``: the error memory within one quantum of
    the reference's (a rounding of the same value may flip where the two
    gradients differ in the last bits), and the weights within the
    uncompressed bound except where a rounding flipped (then lr more)."""
    rcfg, cfg, params, model = _models(arch)
    batch = _batch(cfg, seed=5)
    wp, wopt, wm, werr = _ref_step(rcfg, params, batch, compression=True)
    # the quantum of each element: its block's scale of the (zero-memory)
    # corrected gradient, from the same weights before the step
    _, grads = _port_grads(_models(arch)[3], _t(batch))
    _, opt, m, err = _port_step(cfg, model, batch, compression=True)
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["grad_norm"]), float(wm["grad_norm"]),
                               rtol=_rel(arch))
    quantum = {}
    for n, g in grads.items():
        _, scale = compress(g)
        quantum[n] = (scale.repeat_interleave(256)[:g.numel()]
                      .reshape(g.shape).numpy())
    quantum = _leaves(_lm_tree(cfg, quantum))
    flips = 0
    for (k, q), (_, e), (_, we), (_, p), (_, wpk) in zip(
            quantum, _leaves(_lm_tree(cfg, {n: t.numpy()
                                            for n, t in err.items()})),
            _leaves(werr), _leaves(lm_params_to_numpy(model)), _leaves(wp)):
        gap = np.abs(e - we)
        assert np.all(gap <= q * (1 + 1e-5) + 1e-7), k
        flipped = gap > q / 2
        flips += int(flipped.sum())
        allowed = np.where(flipped, LR + PARAM_ATOL, PARAM_ATOL)
        assert np.all(np.abs(p - wpk) <= allowed), k
    n = sum(p.numel() for p in model.parameters())
    assert flips <= n // 1000, f"{flips} of {n} roundings flipped"


def test_adamw_decays_stacked_norm_leaves_as_the_reference():
    """The reference decays a leaf of rank >= 2, and its per-layer norm
    weights are stacked (L, d): so they are decayed, and only the top-level
    ``final_norm`` is not.  With non-zero norms the port's update, made
    through ``convert.reference_decay``, equals the reference's; a decay
    rule on the port's own 1-D tensors would not."""
    rng = np.random.default_rng(7)

    def norms(tree):
        for k in ("ln1", "ln2"):
            tree["layers"][k] = rng.standard_normal(
                tree["layers"][k].shape).astype(np.float32)
        tree["final_norm"] = rng.standard_normal(
            tree["final_norm"].shape).astype(np.float32)

    rcfg, cfg, params, model = _models("minitron-8b", norms)
    decay = reference_decay(model)
    assert decay["blocks.0.ln1"] and decay["embed"] and decay["lm_head"]
    assert not decay["final_norm"]
    assert model.blocks[0].ln1.dim() == 1  # the port's own rank is 1
    batch = _batch(cfg, seed=6)
    wp, wopt, wm = _ref_step(rcfg, params, batch)
    _, opt, m = _port_step(cfg, model, batch)
    got = _check_step("minitron-8b", cfg, model, opt, m, wp, wopt, wm)
    for (k, a), (_, b) in zip(_leaves(got), _leaves(wp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL, err_msg=k)
    # The norm leaves' own gradients are far from 0, so their step is held
    # to atol 2e-8 (largest gap measured 3.7e-9), and the decay term
    # lr * wd * p (1.2e-7 at the least, 6e-5 typically) shows: with the
    # port's own rank (no decay) nearly every entry would miss.
    np.testing.assert_allclose(got["final_norm"], wp["final_norm"], rtol=0,
                               atol=2e-8)
    for k in ("ln1", "ln2"):
        p0 = np.asarray(params["layers"][k])
        np.testing.assert_allclose(got["layers"][k], wp["layers"][k], rtol=0,
                                   atol=2e-8)
        undecayed = got["layers"][k] + LR * 0.1 * p0
        assert np.mean(np.abs(undecayed - np.asarray(wp["layers"][k]))
                       > 2e-8) > 0.99


@pytest.mark.parametrize("arch", ["minitron-8b", "qwen2-moe-a2.7b",
                                  "rwkv6-1.6b", "recurrentgemma-2b"])
def test_remat_policies_give_the_same_gradients(arch):
    cfg = configs.get(arch).reduced()
    batch = _t(_batch(cfg, seed=8))
    base = init_params(cfg, seed=0, device="cpu")
    grads, saved = {}, {}
    for remat in ("none", "full", "dots"):
        model = init_params(dataclasses.replace(cfg, remat=remat), seed=0,
                            device="cpu")
        model.load_state_dict(base.state_dict())
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss, _ = loss_fn(model, batch)
        saved[remat] = sum(nbytes)
        grads[remat] = torch.autograd.grad(loss, list(model.parameters()),
                                           allow_unused=True,
                                           materialize_grads=True)
    for remat in ("full", "dots"):
        for a, b in zip(grads[remat], grads["none"]):
            assert torch.equal(a, b), remat
        # autograd's own saves shrink to what the checkpoint holds
        assert saved[remat] < saved["none"] / 2, (remat, saved)


def test_remat_dots_keeps_the_products_without_a_batch_dim():
    """The ``dots`` policy keeps ``mm`` / ``addmm`` outputs (``x @ W``
    folds the batch into rows) and recomputes the rest, batched products
    (``bmm``: attention, experts) included, as JAX's
    ``checkpoint_dots_with_no_batch_dims``."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    for op in (aten.mm.default, aten.addmm.default):
        assert _save_dots(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default):
        assert _save_dots(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def test_remat_rejects_an_unknown_policy():
    cfg = dataclasses.replace(configs.get("minitron-8b").reduced(),
                              remat="some")
    model = init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        loss_fn(model, _t(_batch(cfg)))


def test_train_step_microbatch_equivalence_on_the_port():
    """The reference's test and bounds, on the port: gradient accumulation
    matches the single-batch step."""
    cfg = configs.get("musicgen-medium").reduced()
    rng = np.random.default_rng(2)
    batch = _t({"inputs_embeds": rng.standard_normal(
        (4, 12, cfg.d_model)).astype(np.float32),
        "labels": rng.integers(0, cfg.vocab_size, (4, 12))})
    outs = []
    for mb in (1, 2):
        model = init_params(cfg, seed=0, device="cpu")
        step = make_train_step(cfg, microbatches=mb, lr=1e-3,
                               dtype=torch.float32)
        _, _, m = step(model, adamw_init(model), batch)
        outs.append((model, float(m["loss"])))
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-4)
    for a, b in zip(outs[0][0].parameters(), outs[1][0].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-3, atol=2e-4)


def test_train_step_with_int8_compression_converges():
    """The reference's test, on the port: memorising one batch."""
    cfg = configs.get("internvl2-1b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    opt, err = adamw_init(model), ef_init(model)
    step = make_train_step(cfg, lr=1e-3, grad_compression=True,
                           dtype=torch.float32)
    batch = _t(_batch(cfg, seed=1, b=2, s=24))
    losses = []
    for _ in range(8):
        _, opt, m, err = step(model, opt, batch, err)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def _snapshot(model, opt, err=None) -> list:
    return [t.detach().clone() for t in (
        *model.parameters(), opt.step, *opt.mu.values(), *opt.nu.values(),
        *(err or {}).values())]


def test_non_finite_loss_applies_no_update():
    """A step whose loss is not finite leaves the parameters, mu, nu, step
    and the error memory bit for bit as they were."""
    cfg = configs.get("musicgen-medium").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    opt, err = adamw_init(model), ef_init(model)
    step = make_train_step(cfg, lr=1e-3, grad_compression=True,
                           dtype=torch.float32)
    good = _t(_batch(cfg, seed=1))
    _, opt, m, err = step(model, opt, good, err)
    assert np.isfinite(float(m["loss"]))
    before = _snapshot(model, opt, err)
    bad = dict(good, inputs_embeds=good["inputs_embeds"].clone())
    bad["inputs_embeds"][1, 2, 0] = float("nan")
    _, opt2, m, err2 = step(model, opt, bad, err)
    assert not np.isfinite(float(m["loss"]))
    assert opt2 is opt and err2 is err
    after = _snapshot(model, opt, err)
    assert len(before) == len(after)
    assert all(torch.equal(a, b) for a, b in zip(before, after))
    assert int(opt.step) == 1


def test_steps_refuse_a_mesh_and_a_mismatched_model():
    cfg = configs.get("rwkv6-1.6b").reduced()
    for make in (make_train_step, make_prefill_step, make_decode_step):
        with pytest.raises(NotImplementedError, match="mesh"):
            make(cfg, mesh=object())
    model = init_params(cfg, seed=0, device="cpu")
    step = make_train_step(cfg, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="dtype|weights"):
        step(model, adamw_init(model), _t(_batch(cfg)))
    other = dataclasses.replace(cfg, remat="full")
    with pytest.raises(ValueError, match="config"):
        make_train_step(other, dtype=torch.float32)(
            model, adamw_init(model), _t(_batch(cfg)))


def test_serving_wrappers_and_inference_mode():
    """Serving records no graph on the trainable weights: prefill,
    decode_step and generate run under ``torch.inference_mode()``."""
    cfg = configs.get("recurrentgemma-2b").reduced()
    model = init_params(cfg, seed=0, dtype=torch.float32, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(0))
    pre = make_prefill_step(cfg, dtype=torch.float32)
    dec = make_decode_step(cfg, dtype=torch.float32)
    logits, cache = pre(model, {"tokens": toks})
    want, _ = prefill(model, {"tokens": toks})
    assert torch.equal(logits, want)
    assert logits.grad_fn is None and not logits.requires_grad
    assert logits.is_inference()
    tok = torch.argmax(logits[:, :cfg.vocab_size], -1)
    nxt, cache = dec(model, cache, tok, 10)
    assert nxt.is_inference() and nxt.grad_fn is None
    assert all(t.is_inference() for c in cache for t in c.values())
    out = generate(model, toks, 3)
    assert out.tokens.is_inference()
    assert torch.equal(out.tokens[:, 0], tok)


@pytest.mark.parametrize("arch,extra", [
    ("qwen2.5-32b", []),
    ("recurrentgemma-2b", ["--microbatches", "2"]),
    ("internvl2-1b", ["--grad-compression", "int8", "--fabric", "fattree"]),
])
def test_train_main_on_the_cpu(arch, extra, tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rep = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                          "--steps", "12", "--global-batch", "4",
                          "--seq-len", "32", "--checkpoint-dir",
                          str(tmp_path), "--checkpoint-every", "5", *extra])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("fabric: ")
    assert f"arch: {configs.get(arch).reduced().name}" in lines[1]
    assert lines[-1].startswith("done: 12 steps")
    assert rep.steps_done == 12 and len(rep.losses) == 12
    assert rep.losses[-1] < rep.losses[0]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000005", "step_00000010"]


def test_train_main_refuses_a_production_mesh_and_a_missing_card(tmp_path):
    args = ["--arch", "rwkv6-1.6b", "--reduced", "--steps", "1",
            "--checkpoint-dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="mesh"):
        train.main([*args, "--device", "cpu", "--production-mesh"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train.main(args)
