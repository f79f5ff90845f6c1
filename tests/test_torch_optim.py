"""The port's optimizer package (``repro_torch.optim``) against the
reference's ``repro.optim``, on the CPU in float32.

Inputs are drawn with numpy from fixed seeds and handed to both sides.
Bounds:

- ``compress`` / ``decompress`` / ``ef_roundtrip``: equal exactly (the int8
  blocks, the scales, the dequantized values and the error memory):
  ``torch.round`` and ``jnp.round`` both round half to even, and the two
  sides divide and multiply the same float32 values;
- ``warmup_cosine`` / ``constant``: rtol 1e-6 (``cos`` of the same float32
  argument);
- ``adamw_update`` on the same trees over 4 steps: parameters, ``mu``,
  ``nu`` and the gradient norm within rtol 1e-6, atol 1e-7 (the bias
  corrections are float32 ``pow``, which XLA evaluates with its own
  approximation, and the sums run in other orders; the largest gap measured
  is an eighth of that bound);
- the reference's own optimizer tests mirrored on the port with their
  bounds.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.optim.adamw import adamw_update as ref_adamw_update
from repro.optim.adamw import global_norm as ref_global_norm
from repro.optim.compression import compress as ref_compress
from repro.optim.compression import decompress as ref_decompress
from repro.optim.compression import ef_roundtrip as ref_ef_roundtrip
from repro.optim.schedules import constant as ref_constant
from repro.optim.schedules import warmup_cosine as ref_warmup_cosine
from repro_torch.optim import (
    OptState,
    adamw_init,
    adamw_update,
    compress,
    constant,
    decompress,
    ef_init,
    ef_roundtrip,
    global_norm,
    warmup_cosine,
)

ADAM_TOL = dict(rtol=1e-6, atol=1e-7)


def _draw(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), **tol)


@pytest.mark.parametrize("n,scale", [(1, 1.0), (255, 3.0), (256, 1e-3),
                                     (257, 10.0), (3000, 1e4)])
def test_compress_and_decompress_equal_the_reference(n, scale):
    g = _draw(n, (n,), scale)
    g[::7] = 0.0  # zeros and exact ties at the block's absmax
    g[1::11] = g[0]
    q, s = compress(torch.tensor(g))
    wq, ws = ref_compress(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        decompress(q, s, (n,)).numpy(),
        np.asarray(ref_decompress(wq, ws, (n,))))


def test_compress_rounds_half_to_even():
    # a block whose scale is exactly 1 (absmax 127): x / 1 = x exactly
    g = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                 dtype=np.float32)
    q, s = compress(torch.tensor(g))
    assert float(s[0]) == 1.0
    np.testing.assert_array_equal(q[0, :8].numpy(),
                                  [127, 0, 2, 2, 0, -2, -2, 4])
    np.testing.assert_array_equal(q.numpy(), np.asarray(ref_compress(g)[0]))


def test_ef_roundtrip_equals_the_reference_over_steps():
    shapes = {"w": (33, 17), "b": (300,), "s": ()}
    grads = {k: _draw(i, v, 0.1) for i, (k, v) in enumerate(shapes.items())}
    err = ef_init({k: torch.tensor(v) for k, v in grads.items()})
    werr = jax.tree_util.tree_map(lambda g: jnp.zeros_like(g), grads)
    for step in range(5):
        g = {k: _draw(10 * step + i, v, 0.1)
             for i, (k, v) in enumerate(shapes.items())}
        out, err = ef_roundtrip({k: torch.tensor(v) for k, v in g.items()},
                                err)
        wout, werr = ref_ef_roundtrip(jax.tree_util.tree_map(jnp.asarray, g),
                                      werr)
        for k in shapes:
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(wout[k]))
            np.testing.assert_array_equal(err[k].numpy(), np.asarray(werr[k]))


def test_error_feedback_accumulates_lost_mass():
    """The reference's test, on the port."""
    g = {"w": torch.tensor(np.linspace(-1, 1, 300, dtype=np.float32))}
    err = ef_init(g)
    total_in, total_out = 0.0, 0.0
    for _ in range(50):
        out, err = ef_roundtrip(g, err)
        total_in += float(torch.sum(g["w"]))
        total_out += float(torch.sum(out["w"]))
    assert total_out == pytest.approx(total_in, rel=1e-3, abs=1e-2)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 17), (2, 1000), (3, 2000)])
def test_compression_roundtrip_error_bounded(seed, n):
    """The reference's property test, on fixed draws."""
    g = torch.tensor(np.random.default_rng(seed).standard_normal(n)
                     .astype(np.float32)) * 10
    q, s = compress(g)
    deq = decompress(q, s, g.shape)
    assert float(torch.max(torch.abs(deq - g))) <= (
        float(g.abs().max()) + 1e-9) / 127.0 + 1e-6


def test_schedules_equal_the_reference():
    for step in list(range(0, 120, 7)) + [10, 100, 150]:
        for args in ((1.0, 10, 100), (3e-4, 0, 50, 0.0), (2e-3, 25, 25)):
            _close(warmup_cosine(step, *args), ref_warmup_cosine(step, *args),
                   rtol=1e-6, atol=0)
        _close(constant(step, 3e-4), ref_constant(step, 3e-4), rtol=0, atol=0)
    t = torch.tensor(5, dtype=torch.int32)
    assert warmup_cosine(t, 1.0, 10, 100).dtype == torch.float32
    assert constant(t, 1e-3).shape == ()


def test_warmup_cosine_shape():
    """The reference's test, on the port."""
    lrs = [float(warmup_cosine(s, 1.0, 10, 100)) for s in range(101)]
    assert lrs[0] == 0.0
    assert lrs[10] == pytest.approx(1.0, rel=1e-6)
    assert lrs[100] == pytest.approx(0.1, rel=1e-3)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))


_SHAPES = {"embed": (64, 8), "ln": (8,), "w": (8, 16), "v": (3, 8, 8),
           "s": ()}


@pytest.mark.parametrize("clip,wd,lr", [(1.0, 0.1, 1e-3), (None, 0.0, 5e-2),
                                        (0.05, 0.3, 1e-2)])
def test_adamw_update_equals_the_reference_over_steps(clip, wd, lr):
    params = {k: _draw(i, v) for i, (k, v) in enumerate(_SHAPES.items())}
    wp = jax.tree_util.tree_map(jnp.asarray, params)
    wopt = ref_adamw_init(wp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    opt = adamw_init(tp)
    assert opt.step.dtype == torch.int32 and int(opt.step) == 0
    for step in range(4):
        g = {k: _draw(100 + 10 * step + i, v, 0.5)
             for i, (k, v) in enumerate(_SHAPES.items())}
        wp, wopt, wstats = ref_adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), wopt, wp, lr,
            weight_decay=wd, clip_norm=clip)
        tp, opt, stats = adamw_update(
            {k: torch.tensor(v) for k, v in g.items()}, opt, tp, lr,
            weight_decay=wd, clip_norm=clip)
        _close(stats["grad_norm"], wstats["grad_norm"], **ADAM_TOL)
        for k in _SHAPES:
            _close(tp[k], wp[k], **ADAM_TOL)
            _close(opt.mu[k], wopt.mu[k], **ADAM_TOL)
            _close(opt.nu[k], wopt.nu[k], **ADAM_TOL)
        assert int(opt.step) == int(wopt.step) == step + 1


def test_adamw_decay_mapping_overrides_rank():
    """``decay`` names the decayed leaves; by default rank >= 2 decides, as
    in the reference (a zero gradient isolates the decay term)."""
    p = {"ln": torch.ones(4), "w": torch.ones(2, 2)}
    g = {"ln": torch.zeros(4), "w": torch.zeros(2, 2)}
    adamw_update(g, adamw_init(p), p, 0.5, weight_decay=0.1)
    assert torch.all(p["ln"] == 1.0) and torch.all(p["w"] == 0.95)
    p = {"ln": torch.ones(4), "w": torch.ones(2, 2)}
    adamw_update(g, adamw_init(p), p, 0.5, weight_decay=0.1,
                 decay={"ln": True, "w": False})
    assert torch.all(p["ln"] == 0.95) and torch.all(p["w"] == 1.0)


def test_adamw_missing_gradient_counts_as_zero():
    p = {"a": torch.ones(3), "b": torch.ones(2, 2)}
    opt = adamw_init(p)
    adamw_update({"a": torch.ones(3)}, opt, p, 0.1, weight_decay=0.0)
    assert torch.all(p["b"] == 1.0) and torch.all(opt.mu["b"] == 0.0)
    assert not torch.all(p["a"] == 1.0)


def test_adamw_updates_in_place_and_leaves_nothing_half_done():
    p = {"a": torch.ones(3), "b": torch.ones(2, 2)}
    ids = {k: id(v) for k, v in p.items()}
    opt = adamw_init(p)
    before = {k: v.clone() for k, v in p.items()}
    adamw_update({"a": torch.ones(3), "b": torch.ones(2, 2)}, opt, p, 0.1)
    assert {k: id(v) for k, v in p.items()} == ids  # the same tensors
    assert int(opt.step) == 1
    # a gradient of the wrong shape fails before anything is written
    mu = {k: v.clone() for k, v in opt.mu.items()}
    now = {k: v.clone() for k, v in p.items()}
    with pytest.raises(ValueError, match="shape"):
        adamw_update({"a": torch.ones(3), "b": torch.ones(5)}, opt, p, 0.1)
    assert int(opt.step) == 1
    for k in p:
        assert torch.equal(p[k], now[k]) and torch.equal(opt.mu[k], mu[k])
        assert not torch.equal(p[k], before[k])


def test_adamw_minimizes_quadratic():
    """The reference's test, on the port."""
    w = {"a": torch.tensor([5.0, -3.0], requires_grad=True),
         "b": torch.tensor([[2.0]], requires_grad=True)}
    opt = adamw_init(w)
    for _ in range(300):
        loss = torch.sum(w["a"] ** 2) + torch.sum(w["b"] ** 2)
        g = dict(zip(w, torch.autograd.grad(loss, list(w.values()))))
        adamw_update(g, opt, w, lr=5e-2, weight_decay=0.0)
    with torch.no_grad():
        assert float(torch.sum(w["a"] ** 2) + torch.sum(w["b"] ** 2)) < 1e-3


def test_grad_clipping_bounds_update():
    """The reference's test, on the port, and its global norm."""
    w = {"a": torch.ones(4)}
    _, _, stats = adamw_update({"a": torch.full((4,), 1e6)}, adamw_init(w), w,
                               lr=1e-3, clip_norm=1.0)
    assert float(stats["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    tree = {k: _draw(i, v) for i, (k, v) in enumerate(_SHAPES.items())}
    _close(global_norm({k: torch.tensor(v) for k, v in tree.items()}),
           ref_global_norm(tree), rtol=1e-6, atol=0)
    bf = global_norm([torch.ones(4, dtype=torch.bfloat16)])
    assert bf.dtype == torch.float32 and float(bf) == 2.0


def test_opt_state_holds_float32_moments_by_name():
    p = {"x": torch.ones(3, dtype=torch.bfloat16), "y": torch.ones(2)}
    opt = adamw_init(p)
    assert isinstance(opt, OptState)
    assert set(opt.mu) == set(opt.nu) == {"x", "y"}
    assert all(t.dtype == torch.float32 for t in opt.mu.values())
    adamw_update({"x": torch.ones(3, dtype=torch.bfloat16),
                  "y": torch.ones(2)}, opt, p, 1e-2)
    assert p["x"].dtype == torch.bfloat16
