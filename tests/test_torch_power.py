"""The port's matmul wrapper and spectral lambda_2 against the reference.

On CPU tensors ``kernels.power.matmul`` is its plain torch version; it is
held against the reference's Pallas kernel in interpret mode and its
``ref.matmul_ref`` on ``tests/test_kernels.py``'s shapes, with that file's
bounds: rtol 1e-5 / atol 1e-5 for float32 and float64 (both sides sum the
same products in different orders; without x64 the reference runs float64
inputs in float32), 2e-2 for bf16 inputs upcast to float32.

``ops.power_iteration_lambda2`` is the reference's loop step for step.
Torch cannot draw the reference's ``jax.random.normal`` start block, so the
test draws it with JAX and hands it to the port as ``v0``.  The two then
agree within rtol 1e-5 (the largest gap measured on these graphs is 2.0e-6,
from float32 rounding in QR and the products), and at 400 iterations both
sit within rtol 1e-3 of the exact lambda_2 (``test_kernels.py``'s bound).
The CUDA kernel itself is held against ``matmul_ref`` on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as R
from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro.kernels.power import matmul_pallas
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels.power import check_matmul_dtype, matmul, matmul_ref

# tests/test_kernels.py's (m, k, n) sweep: unaligned, degenerate and
# tile-straddling shapes
SHAPES = [(8, 8, 8), (16, 16, 16), (17, 5, 23), (1, 64, 1), (33, 40, 29),
          (64, 64, 64), (70, 1, 70)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_matmul_against_pallas_and_ref(shape, dtype):
    m, k, n = shape
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    a = rng.standard_normal((m, k)).astype(dtype)
    b = rng.standard_normal((k, n)).astype(dtype)
    got = matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.from_numpy(a).dtype
    want_pallas = np.asarray(matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                           bm=16, bn=16, bk=16, interpret=True))
    want_ref = np.asarray(ref.matmul_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ops.matmul(torch.from_numpy(a),
                                          torch.from_numpy(b)).numpy(),
                               got.numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("half", [torch.bfloat16, torch.float16])
def test_matmul_half_inputs_upcast(half):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((24, 56)).astype(np.float32))
    a_h, b_h = a.to(half), b.to(half)
    got = matmul(a_h, b_h)
    assert got.dtype == torch.float32
    jdt = jnp.bfloat16 if half == torch.bfloat16 else jnp.float16
    want = matmul_pallas(jnp.asarray(a.numpy(), dtype=jdt),
                         jnp.asarray(b.numpy(), dtype=jdt),
                         bm=16, bn=16, bk=16, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    # the upcast product is the float32 product of the rounded operands
    np.testing.assert_allclose(got.numpy(),
                               (a_h.float() @ b_h.float()).numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.int64,
                                   torch.bool])
def test_matmul_rejects_integer_operands(dtype):
    a = torch.ones((8, 8), dtype=dtype)
    f = torch.ones((8, 8))
    for x, y in ((a, f), (f, a)):
        with pytest.raises(ValueError, match="floating point"):
            matmul(x, y)
        with pytest.raises(ValueError, match="floating point"):
            matmul_ref(x, y)
        with pytest.raises(ValueError, match="floating point"):
            check_matmul_dtype(x, y)
    # the reference rejects them too, before its zero-pad
    with pytest.raises(ValueError, match="floating point"):
        matmul_pallas(jnp.ones((8, 8), jnp.int16), jnp.ones((8, 8)),
                      bm=8, bn=8, bk=8, interpret=True)


def test_matmul_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        matmul(torch.ones((3, 4)), torch.ones((5, 2)))


def test_matmul_non_contiguous_operands():
    """Transposed views and the column-major Q of ``torch.linalg.qr`` give
    the product of their values, whatever their strides."""
    rng = np.random.default_rng(3)
    at = torch.from_numpy(rng.standard_normal((37, 50)).astype(np.float32))
    a = at.T  # (50, 37), strides (1, 50)
    assert not a.is_contiguous()
    q, _ = torch.linalg.qr(
        torch.from_numpy(rng.standard_normal((37, 8)).astype(np.float32)))
    assert not q.is_contiguous()
    got = matmul(a, q)
    want = ref.matmul_ref(jnp.asarray(a.contiguous().numpy()),
                          jnp.asarray(q.contiguous().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_matmul_mixed_precision_promotes():
    a = torch.ones((4, 3), dtype=torch.float32)
    b = torch.ones((3, 2), dtype=torch.float64)
    out = matmul(a, b)
    assert out.dtype == torch.float64
    assert torch.equal(out, torch.full((4, 2), 3.0, dtype=torch.float64))


def test_matmul_on_cpu_launches_no_kernel():
    kernels.reset_launch_counts()
    matmul(torch.ones((4, 4)), torch.ones((4, 4)))
    assert kernels.launch_counts()["matmul"] == 0


def _v0(n, block=8, seed=0):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, block),
                                        jnp.float32))


def _exact_lambda2(top):
    a = top.adjacency().astype(np.float64)
    return float(np.sort(np.linalg.eigvalsh(np.diag(a.sum(1)) - a))[1])


@pytest.mark.parametrize("n,k,r", [(40, 8, 5), (200, 12, 8)])
@pytest.mark.parametrize("iters", [10, 400])
def test_power_iteration_matches_reference(n, k, r, iters):
    top = R.jellyfish(n, k, r, seed=9)
    adj = top.adjacency()
    v0 = _v0(n)
    want = float(ref_ops.power_iteration_lambda2(adj, iters=iters,
                                                 backend="ref"))
    got = ops.power_iteration_lambda2(adj, iters=iters, v0=v0, device="cpu")
    assert got == pytest.approx(want, rel=1e-5)
    if iters == 400:
        exact = _exact_lambda2(top)
        assert got == pytest.approx(exact, rel=1e-3)
        assert want == pytest.approx(exact, rel=1e-3)


def test_power_iteration_matches_pallas_body():
    """Ten iterations through the reference's Pallas kernel (interpret
    mode), so the kernel body itself is held, not only its jnp oracle."""
    top = R.jellyfish(40, 8, 5, seed=9)
    adj = top.adjacency()
    want = float(ref_ops.power_iteration_lambda2(adj, iters=10,
                                                 backend="pallas"))
    got = ops.power_iteration_lambda2(adj, iters=10, v0=_v0(40),
                                      device="cpu")
    assert got == pytest.approx(want, rel=1e-5)


def test_power_iteration_seeded_start_and_v0_checks():
    top = R.jellyfish(40, 8, 5, seed=9)
    adj = top.adjacency()
    a = ops.power_iteration_lambda2(adj, iters=400, seed=3, device="cpu")
    b = ops.power_iteration_lambda2(adj, iters=400, seed=3, device="cpu")
    assert a == b  # the torch.Generator start block is reproducible
    assert a == pytest.approx(_exact_lambda2(top), rel=1e-3)
    assert a >= _exact_lambda2(top) * (1 - 1e-5)  # a Rayleigh estimate
    with pytest.raises(ValueError, match="v0 must have shape"):
        ops.power_iteration_lambda2(adj, iters=2, v0=np.zeros((40, 4)),
                                    device="cpu")
