"""The port's kernel wrappers (on CPU tensors: their plain torch versions)
against the reference's Pallas kernels in interpret mode, on the same
numpy-seeded inputs.

Tolerances: min-plus and the admission mask are exact (sums and minimums of
small integers, and comparisons, are exact in float32).  Congestion is held
to rtol 1e-5: both sides accumulate float32 products, in different orders;
its outputs beyond a member's extents are exact zeros.
The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.admission import admission_pallas
from repro.kernels.congestion import congestion_pallas
from repro.kernels.minplus import minplus_pallas
from repro_torch.kernels import ops
from repro_torch.kernels.admission import admission, admission_prune
from repro_torch.kernels.congestion import (
    check_extents,
    congestion,
    vector_width,
)
from repro_torch.kernels.minplus import minplus


def _hops(rng, shape, p_inf=0.25):
    a = rng.integers(0, 9, size=shape).astype(np.float32)
    a[rng.random(shape) < p_inf] = np.inf
    return a


@pytest.mark.parametrize("m,k,n", [(8, 8, 8), (17, 5, 23), (1, 64, 1),
                                   (33, 40, 29), (70, 1, 70)])
def test_minplus_exact_against_pallas(m, k, n):
    rng = np.random.default_rng(m * 100 + k * 10 + n)
    a, b = _hops(rng, (m, k)), _hops(rng, (k, n))
    want = np.asarray(minplus_pallas(jnp.asarray(a), jnp.asarray(b), bm=8,
                                     bn=8, bk=8, interpret=True))
    got = ops.minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_minplus_rejects_integer_operands():
    a = torch.zeros((3, 3), dtype=torch.int16)
    with pytest.raises(ValueError, match="floating point"):
        minplus(a, a)


@pytest.mark.parametrize("m,c,w", [(5, 7, 0), (40, 9, 3), (130, 36, 5)])
def test_admission_exact_against_pallas(m, c, w):
    rng = np.random.default_rng(m + c + w)
    d = _hops(rng, (m, c), 0.1)
    rem = rng.integers(0, 6, m).astype(np.float32)
    # candidates are node ids (>= 0, the neighbour sentinel included);
    # prefixes hold node ids and -1 past the prefix
    cand = rng.integers(0, 30, (m, c)).astype(np.int32)
    pref = rng.integers(-1, 30, (m, w)).astype(np.int32)
    want = np.asarray(admission_pallas(
        jnp.asarray(d), jnp.asarray(rem), jnp.asarray(cand),
        jnp.asarray(pref), bm=8, bc=8, interpret=True))
    got = admission(*(torch.from_numpy(x) for x in (d, rem, cand, pref)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_admission_prune_gathers_like_numpy():
    rng = np.random.default_rng(5)
    tile = np.concatenate([_hops(rng, (6, 20), 0.1),
                           np.full((6, 1), np.inf, np.float32)], axis=1)
    dst_row = rng.integers(0, 6, 50)
    cand = rng.integers(0, 21, (50, 4)).astype(np.int32)
    rem = rng.integers(0, 5, 50).astype(np.float32)
    pref = rng.integers(-1, 21, (50, 3)).astype(np.int32)
    got = admission_prune(tile, dst_row, cand, rem, pref, device="cpu")
    want = tile[dst_row[:, None], cand] <= rem[:, None]
    want &= ~(pref[:, :, None] == cand[:, None, :]).any(axis=1)
    np.testing.assert_array_equal(got, want)


def _incidence(rng, shape, hops=4):
    b = np.zeros(shape, np.float32)
    flat = b.reshape(-1, shape[-1])
    cols = rng.integers(0, shape[-1], (flat.shape[0], hops))
    np.put_along_axis(flat, cols, 1.0, axis=1)
    return b


@pytest.mark.parametrize("shape", [(16, 24), (33, 70), (3, 20, 45)], ids=str)
def test_congestion_against_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    b = _incidence(rng, shape)
    r = rng.random(shape[:-1], np.float32)
    w = rng.random(shape[:-2] + shape[-1:], np.float32)
    wl, wc = congestion_pallas(jnp.asarray(b), jnp.asarray(r), jnp.asarray(w),
                               bp=8, be=8, interpret=True)
    gl, gc = congestion(*(torch.from_numpy(x) for x in (b, r, w)))
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=1e-5)
    np.testing.assert_allclose(gc.numpy(), np.asarray(wc), rtol=1e-5)
    loads = ops.congestion_loads(torch.from_numpy(b), torch.from_numpy(r))
    np.testing.assert_allclose(loads.numpy(), np.asarray(wl), rtol=1e-5)


def _padded_stack(rng, rows, cols, P, S):
    """A (Bt, P, S) stack of 0/1 incidences, member b real in its
    (rows[b], cols[b]) block, with the batched solver's padding: the
    member's sentinel column ``cols[b]`` is hit by every padded row and by
    some real rows, and the padded region holds other stray ones too."""
    b = np.zeros((len(rows), P, S), np.float32)
    for i, (p, s) in enumerate(zip(rows, cols)):
        if p and s:
            b[i, :p, :s] = _incidence(rng, (p, s))
        if s < S:
            b[i, :, s] = 1.0
            b[i, p:, s + 1:] = rng.random((P - p, S - s - 1)) < 0.3
        b[i, p:, :s] = rng.random((P - p, s)) < 0.3
    return b


@pytest.mark.parametrize("rows,cols,P,S", [
    ([40, 25, 0, 33], [48, 30, 17, 45], 40, 48),
    ([7, 1, 20], [9, 3, 21], 20, 21),
], ids=str)
def test_congestion_extents_against_pallas(rows, cols, P, S):
    rng = np.random.default_rng(P * S)
    b = _padded_stack(rng, rows, cols, P, S)
    r = rng.random((len(rows), P), np.float32)
    w = rng.random((len(rows), S), np.float32)
    args = [torch.from_numpy(x) for x in (b, r, w)]
    gl, gc = congestion(*args, extents=(torch.tensor(rows), np.array(cols)))
    for i, (p, s) in enumerate(zip(rows, cols)):
        # exact zeros beyond the extents
        assert not gl[i, s:].any() and not gc[i, p:].any()
        if p == 0:
            assert not gl[i].any()
            continue
        wl, wc = congestion_pallas(jnp.asarray(b[i, :p, :s]),
                                   jnp.asarray(r[i, :p]), jnp.asarray(w[i, :s]),
                                   bp=8, be=8, interpret=True)
        np.testing.assert_allclose(gl[i, :s].numpy(), np.asarray(wl),
                                   rtol=1e-5)
        np.testing.assert_allclose(gc[i, :p].numpy(), np.asarray(wc),
                                   rtol=1e-5)


def test_congestion_rank2_extents_against_pallas():
    rng = np.random.default_rng(11)
    b = _padded_stack(rng, [30], [41], 36, 50)[0]
    r, w = rng.random(36, np.float32), rng.random(50, np.float32)
    gl, gc = congestion(*(torch.from_numpy(x) for x in (b, r, w)),
                        extents=(30, 41))
    wl, wc = congestion_pallas(jnp.asarray(b[:30, :41]), jnp.asarray(r[:30]),
                               jnp.asarray(w[:41]), bp=8, be=8, interpret=True)
    np.testing.assert_allclose(gl[:41].numpy(), np.asarray(wl), rtol=1e-5)
    np.testing.assert_allclose(gc[:30].numpy(), np.asarray(wc), rtol=1e-5)
    assert not gl[41:].any() and not gc[30:].any()
    # the full extent is the call without extents
    full = congestion(*(torch.from_numpy(x) for x in (b, r, w)))
    same = congestion(*(torch.from_numpy(x) for x in (b, r, w)),
                      extents=(36, 50))
    assert all(torch.equal(x, y) for x, y in zip(full, same))


@pytest.mark.parametrize("extents,match", [
    (([5, 2], [4, 3]), r"must be \(3,\) integers"),
    (([5, 2, 1], [4, 3]), r"must be \(3,\) integers"),
    (([6, 2, 1], [4, 3, 0]), r"lie in \[0, 5\]"),
    (([5, 2, 1], [4, 3, 8]), r"lie in \[0, 7\]"),
    (([5, -1, 1], [4, 3, 0]), r"lie in \[0, 5\]"),
    (([5.0, 2.0, 1.0], [4, 3, 0]), "integers"),
    (([5, 2, 1],), "a pair"),
], ids=str)
def test_congestion_rejects_bad_extents(extents, match):
    b = torch.zeros((3, 5, 7))
    r, w = torch.zeros((3, 5)), torch.zeros((3, 7))
    with pytest.raises(ValueError, match=match):
        congestion(b, r, w, extents=extents)
    with pytest.raises(ValueError, match=match):
        check_extents(extents, b.shape)


def test_congestion_rank2_extents_are_ints():
    with pytest.raises(ValueError, match="must be an int"):
        check_extents(([3], [4]), (5, 7))
    rows, cols = check_extents((torch.tensor(3), np.int64(4)), (5, 7))
    assert rows.tolist() == [3] and cols.tolist() == [4]


def test_congestion_vector_width():
    # 16-byte copies when rows are a multiple of 4 floats and B is aligned,
    # then 8-byte, then single floats
    assert vector_width(torch.zeros((3, 12960))) == 4
    assert vector_width(torch.zeros((2, 3, 14))) == 2
    assert vector_width(torch.zeros((3, 13))) == 1
    base = torch.zeros(4 * 64 + 2)
    assert vector_width(base[2:].view(4, 64)) == 2
    assert vector_width(base[1:257].view(4, 64)) == 1


def test_congestion_rejects_mismatched_shapes():
    with pytest.raises(ValueError, match="mismatch"):
        congestion(torch.zeros((4, 5)), torch.zeros(3), torch.zeros(5))


def test_preferred_backend_policy():
    big = (40960, 14336)
    assert ops.preferred_congestion_backend(*big, n_batch=4,
                                            device="cuda") == "dense"
    assert ops.preferred_congestion_backend(*big, n_batch=16,
                                            device="cuda") == "gather"
    assert ops.preferred_congestion_backend(*big, n_batch=4,
                                            device="cpu") == "gather"
    assert ops.preferred_congestion_backend(30, 40, device="cpu") == "dense"
