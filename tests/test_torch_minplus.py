"""The int16 (DPX) form of the port's min-plus product, its launch plan and
split-K, and the APSP driver that uses it, on the CPU.

The plain int16 version (what the wrapper runs on CPU tensors) is held
against the reference's Pallas kernel in interpret mode through
``hops_to_f32`` / ``hops_to_int16``; the launch plan and an emulation of
its K split against the plain versions; and ``apsp_minplus_blocked`` on the
CPU against the reference's driver and the BFS.  Every comparison here is
exact: sums and minimums of small integers are exact in float32 and in
int32, and min does not depend on order.  The CUDA kernels are held
against these plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
from repro.core import hops_to_f32, hops_to_int16
from repro.kernels import ops as ref_ops
from repro.kernels.minplus import minplus_pallas
from repro_torch import kernels
from repro_torch.core.metrics import INT16_INF, apsp_hops_blocked
from repro_torch.kernels import ops
from repro_torch.kernels.minplus import (
    BLOCKS_PER_SM,
    F32_TILE,
    HOPS_INF,
    HOPS_MAX_N,
    HOPS_TILE,
    K_STEP,
    SCRATCH_BUDGET_BYTES,
    copy_width,
    launch_plan,
    minplus,
    minplus_hops,
    minplus_hops_ref,
    minplus_ref,
)

S = HOPS_INF
SENT = int(INT16_INF)


def _random_hops(rng, shape, hi=9, p_inf=0.25):
    a = rng.integers(0, hi, size=shape).astype(np.int16)
    a[rng.random(shape) < p_inf] = SENT
    return a


def _hop_matrix(top) -> np.ndarray:
    """The driver's starting matrix: 0 diagonal, 1 per edge, sentinel."""
    adj = top.adjacency()
    d = np.full(adj.shape, SENT, np.int16)
    d[adj != 0] = 1
    np.fill_diagonal(d, 0)
    return d


def _pallas_hops(a, b, tile=8):
    """The reference's Pallas kernel (interpret mode) on int16 hop matrices
    through hops_to_f32 / hops_to_int16."""
    out = minplus_pallas(jnp.asarray(hops_to_f32(a)),
                         jnp.asarray(hops_to_f32(b)), bm=tile, bn=tile,
                         bk=tile, interpret=True)
    return hops_to_int16(np.asarray(out))


def _path_topology(n):
    return R.Topology.regular(n, 3, 2, [(i, i + 1) for i in range(n - 1)])


def _pairs():
    rng = np.random.default_rng(7)
    yield "random", _random_hops(rng, (37, 50)), _random_hops(rng, (50, 29))
    yield "ragged", _random_hops(rng, (1, 19)), _random_hops(rng, (19, 1))
    islands = R.Topology.regular(
        12, 4, 3, [(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (8, 9), (9, 10)])
    d = _hop_matrix(islands)
    yield "disconnected", d, d
    # a path graph: the true distances (up to 299) squared once more, and
    # its one-hop matrix after seven squarings (distances <= 128) squared
    path = _path_topology(300)
    dist = apsp_hops_blocked(path.adjacency())
    assert int(dist.max(where=dist != SENT, initial=0)) == 299
    yield "path_distances", dist, dist
    d = _hop_matrix(path)
    for _ in range(7):
        d = minplus_hops_ref(torch.from_numpy(d), torch.from_numpy(d)).numpy()
    yield "path_d128", d, d


@pytest.mark.parametrize("case", list(_pairs()), ids=lambda c: c[0])
def test_hops_ref_exact_against_pallas(case):
    _, a, b = case
    want = _pallas_hops(a, b, tile=128 if a.shape[0] >= 128 else 8)
    got = minplus_hops(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    # and equal to the float32 form through the same conversions
    f = minplus(torch.from_numpy(hops_to_f32(a)),
                torch.from_numpy(hops_to_f32(b))).numpy()
    np.testing.assert_array_equal(got.numpy(), hops_to_int16(f))


@pytest.mark.parametrize("a,b,want", [
    (S - 1, 0, S - 1),        # the largest finite result
    (S - 2, 1, S - 1),
    (S - 1, 1, SENT),         # reaches S: reported as the sentinel
    (8000, 8383, SENT),       # 16383 = S
    (8000, 8382, S - 1),
    (16000, 16000, SENT),     # 32000: beyond S, no wrap
    (S - 1, S - 1, SENT),     # 32764: the largest sum of finite entries
    (SENT, 0, SENT),          # the sentinel loads as S
    (SENT, SENT, SENT),       # 2 S = 32766 does not wrap
    (0, SENT, SENT),
    (S, 0, SENT),             # S itself is infinite
    (20000, 0, SENT),         # any entry at or above S is capped to S
    (-5, 3, 3),               # a negative entry loads as 0
    (3, -1, 3),
    (-32768, -32768, 0),      # the most negative int16: no wrap either
])
def test_hops_ref_saturates_at_working_infinity(a, b, want):
    ta = torch.tensor([[a, 5]], dtype=torch.int16)
    tb = torch.tensor([[b], [SENT]], dtype=torch.int16)
    got = minplus_hops(ta, tb)
    assert got.tolist() == [[want]]


def test_hops_ref_min_over_k_with_saturated_candidates():
    # one finite candidate below S among saturated and sentinel ones
    a = torch.tensor([[SENT, S - 1, 16000, 7]], dtype=torch.int16)
    b = torch.tensor([[3], [S - 1], [16000], [S - 8]], dtype=torch.int16)
    assert minplus_hops(a, b).tolist() == [[S - 1]]
    b[3, 0] = S - 7
    assert minplus_hops(a, b).tolist() == [[SENT]]


def test_hops_rejects_float_operands_and_minplus_points_to_hops():
    f = torch.zeros((3, 3))
    with pytest.raises(ValueError, match="int16"):
        minplus_hops(f, f)
    i = torch.zeros((3, 3), dtype=torch.int16)
    with pytest.raises(ValueError, match="minplus_hops"):
        minplus(i, i)
    with pytest.raises(ValueError, match=r"\(M, K\) x \(K, N\)"):
        minplus_hops(i, torch.zeros((2, 3), dtype=torch.int16))


def test_out_receives_the_band():
    rng = np.random.default_rng(3)
    d = torch.from_numpy(_random_hops(rng, (40, 40)))
    nxt = torch.full_like(d, -1)
    for i0 in range(0, 40, 16):
        minplus_hops(d[i0:i0 + 16], d, out=nxt[i0:i0 + 16])
    assert torch.equal(nxt, minplus_hops_ref(d, d))


# --------------------------------------------------------------------------- #
# launch plan and split-K
# --------------------------------------------------------------------------- #


def _check_plan(p, m, n, k, n_sm, hops):
    tm, tn = HOPS_TILE if hops else F32_TILE
    tiles = -(-m // tm) * -(-n // tn)
    kps, splits = p["k_per_split"], p["splits"]
    assert p["tile"] == (tm, tn) and p["blocks"] == tiles * splits
    assert kps % K_STEP == 0 and kps > 0
    # the splits cover K exactly, none empty
    assert kps * (splits - 1) < k <= kps * splits
    if tiles >= BLOCKS_PER_SM * n_sm:
        assert splits == 1
        return p
    # no other split count within the scratch budget gives the busiest SM
    # fewer chunks, and none with as few chunks has fewer splits
    chunks = -(-k // K_STEP)
    elem = 2 if hops else 4
    assert splits == 1 or splits * m * n * elem <= SCRATCH_BUDGET_BYTES

    def cost(per):
        return -(-tiles * -(-chunks // per) // n_sm) * per

    per = kps // K_STEP
    for other in range(1, chunks + 1):
        s_other = -(-chunks // other)
        if s_other > 1 and s_other * m * n * elem > SCRATCH_BUDGET_BYTES:
            continue
        assert cost(other) >= cost(per)
        if cost(other) == cost(per):
            assert s_other >= splits
    return p


@pytest.mark.parametrize("hops", [False, True], ids=["f32", "hops"])
@pytest.mark.parametrize("m,n,k,n_sm", [
    (720, 720, 720, 132), (2048, 8192, 8192, 132), (8192, 8192, 8192, 132),
    (792, 792, 792, 132), (738, 738, 738, 132), (1, 1, 1, 132),
    (65, 130, 33, 132), (7, 5, 300, 132), (721, 1000, 333, 132),
    (128, 256, 17, 4), (300, 300, 100000, 132), (4096, 4096, 64, 132)])
def test_launch_plan_covers_k_and_balances_the_sms(hops, m, n, k, n_sm):
    _check_plan(launch_plan(m, n, k, n_sm, hops=hops), m, n, k, n_sm, hops)


def test_launch_plan_values_at_the_paths_shapes():
    # 720^3: seven K ranges of 112, one block per tile and range: 252
    # float32 blocks (two per SM on most SMs), 126 int16 blocks (one wave)
    for hops, blocks in ((False, 252), (True, 126)):
        p = launch_plan(720, 720, 720, 132, hops=hops)
        assert (p["splits"], p["k_per_split"], p["blocks"]) == (7, 112, blocks)
    # a 2048-row band and the whole 8192^3 squaring fill the card unsplit
    assert launch_plan(2048, 8192, 8192, 132)["blocks"] == 1024
    assert launch_plan(2048, 8192, 8192, 132, hops=True)["blocks"] == 512
    assert launch_plan(8192, 8192, 8192, 132, hops=True)["splits"] == 1


def _split_emulation(a, b, plan, ref):
    kps = plan["k_per_split"]
    parts = [ref(a[:, k0:k0 + kps], b[k0:k0 + kps])
             for k0 in range(0, a.shape[1], kps)]
    assert len(parts) == plan["splits"]
    return torch.stack(parts).amin(0)


@pytest.mark.parametrize("m,k,n", [(720, 720, 720), (65, 33, 130),
                                   (7, 300, 5), (721, 333, 100), (1, 1, 1)])
def test_split_k_emulation_is_bit_exact(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a16, b16 = _random_hops(rng, (m, k)), _random_hops(rng, (k, n))
    a = torch.from_numpy(hops_to_f32(a16))
    b = torch.from_numpy(hops_to_f32(b16))
    p = launch_plan(m, n, k, 132)
    assert torch.equal(_split_emulation(a, b, p, minplus_ref),
                       minplus_ref(a, b))
    a16, b16 = torch.from_numpy(a16), torch.from_numpy(b16)
    p = launch_plan(m, n, k, 132, hops=True)
    assert torch.equal(_split_emulation(a16, b16, p, minplus_hops_ref),
                       minplus_hops_ref(a16, b16))


def test_copy_width_follows_rows_and_alignment():
    i16 = torch.zeros((8, 64), dtype=torch.int16)
    assert copy_width(i16, i16) == 16
    assert copy_width(i16[:, :6].contiguous(), i16) == 4
    assert copy_width(i16[:, :5].contiguous(), i16) == 2
    assert copy_width(i16[1:], i16) == 16          # 128-byte offset
    odd = torch.zeros((8, 6), dtype=torch.int16)
    assert copy_width(odd[1:], odd) == 4           # 12-byte offset
    f = torch.zeros((4, 8))
    assert copy_width(f, f) == 16
    assert copy_width(torch.zeros((3, 3)), f) == 4


# --------------------------------------------------------------------------- #
# the APSP driver
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("top", [
    R.jellyfish(150, 10, 6, seed=2),
    R.Topology.regular(10, 4, 3, [(0, 1), (1, 2), (3, 4), (5, 6), (6, 7)]),
    _path_topology(301),
], ids=["jellyfish", "disconnected", "path301"])
@pytest.mark.parametrize("bm", [64, 2048])
def test_apsp_driver_on_cpu_equals_reference_and_bfs(top, bm, monkeypatch):
    adj = top.adjacency()
    assert ops.apsp_form(adj.shape[0]) == "hops"
    before = kernels.launch_counts()
    got = ops.apsp_minplus_blocked(adj, bm=bm, device="cpu")
    # CPU tensors take the plain versions: no kernel launch is counted
    assert kernels.launch_counts() == before
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, apsp_hops_blocked(adj))
    np.testing.assert_array_equal(got, ref_ops.apsp_minplus_blocked(adj))
    # the float32 form, as the shape rule takes it above HOPS_MAX_N nodes
    monkeypatch.setattr(ops, "HOPS_MAX_N", 0)
    assert ops.apsp_form(adj.shape[0]) == "f32"
    np.testing.assert_array_equal(
        ops.apsp_minplus_blocked(adj, bm=bm, device="cpu"), got)


def test_apsp_form_shape_rule():
    assert HOPS_MAX_N == HOPS_INF == 16383
    assert ops.apsp_form(1) == "hops"
    assert ops.apsp_form(8192) == "hops"
    assert ops.apsp_form(16383) == "hops"
    assert ops.apsp_form(16384) == "f32"
    assert ops.apsp_form(32766) == "f32"
    # past the int16 sentinel no form can hold the distances: refused from
    # the shape, before any matrix is built
    big = np.broadcast_to(np.int8(0), (32767, 32767))
    with pytest.raises(ValueError, match="sentinel"):
        ops.apsp_minplus_blocked(big, device="cpu")


def test_launch_counts_name_the_int16_form():
    counts = kernels.launch_counts()
    assert "minplus_hops" in counts and "minplus" in counts
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["minplus_hops"] == 0
