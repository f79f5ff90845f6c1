"""Fluid MPTCP (paper §5, Fig 8): port against reference, on the CPU.

Tolerance, and why it holds: ``mptcp_throughput``'s per-commodity
normalized throughput and per-path rates agree with the reference's within
2e-6 absolute, cold (1500 iterations) and warm-started after a delta update
(400 iterations), on both backends (port ``gather`` against the reference's
``scatter``, ``dense`` against ``dense``).  The recurrence is the
reference's step for step, with every segment sum in the reference's order;
what differs is the last bit of ``exp`` and of the ``1/sqrt`` step size
(XLA:CPU's own approximations).  Unlike the MW anneal, the price iteration
damps those differences: measured on the two systems below (a CPU run),
the largest gap is 5.96e-7 on ``per_flow`` and 4.77e-7 on the rates, so
the bound sits ~3x above it.

The segment sums themselves are exact: left to right over each
commodity's rows in ascending row order, equal to a sequential loop and to
XLA's scatter-add bit for bit, also when the rows of a commodity are not
contiguous (a delta splice).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as R
import repro_torch.core as T
from repro_torch import convert
from repro_torch.core import mptcp as port_mptcp
from repro_torch.core.flow import PathSystemBatch, _columns

CPU = "cpu"
ATOL = 2e-6
BACKENDS = [("scatter", "gather"), ("dense", "dense")]


def _conv(ps):
    return convert.path_system_from_numpy(dataclasses.asdict(ps))


def _system(seed):
    top = R.jellyfish(60, 10, 7, seed=seed)
    comm = R.random_permutation_traffic(top, seed=seed + 1)
    return top, comm, R.build_path_system(top, comm, k=8)


@pytest.mark.parametrize("ref_be,port_be", BACKENDS)
@pytest.mark.parametrize("seed", [5, 7])
def test_mptcp_cold_matches_reference(seed, ref_be, port_be):
    _, _, rps = _system(seed)
    a = R.mptcp_throughput(rps, iters=1500, backend=ref_be)
    b = T.mptcp_throughput(_conv(rps), iters=1500, backend=port_be,
                           device=CPU)
    np.testing.assert_allclose(b.per_flow, a.per_flow, rtol=0, atol=ATOL)
    np.testing.assert_allclose(b.rates, a.rates, rtol=0, atol=ATOL)
    assert abs(b.mean_throughput - a.mean_throughput) <= ATOL
    assert abs(b.jain_index - a.jain_index) <= 10 * ATOL
    assert b.iters == 1500


@pytest.mark.parametrize("ref_be,port_be", BACKENDS)
def test_mptcp_warm_after_update_matches_reference(ref_be, port_be):
    top, comm, rps = _system(5)
    failed = R.fail_links(top, 0.1, seed=4)
    rd = R.update_path_system(rps, top, failed, comm)
    assert rd.row_map is not None
    a0 = R.mptcp_throughput(rps, iters=400, backend=ref_be)
    b0 = T.mptcp_throughput(_conv(rps), iters=400, backend=port_be,
                            device=CPU)
    a = R.mptcp_throughput(rd, iters=400, backend=ref_be, warm=a0)
    b = T.mptcp_throughput(_conv(rd), iters=400, backend=port_be, warm=b0,
                           device=CPU)
    np.testing.assert_allclose(b.per_flow, a.per_flow, rtol=0, atol=ATOL)
    np.testing.assert_allclose(b.rates, a.rates, rtol=0, atol=ATOL)
    # a raw rate vector warm-starts the same way as a result
    c = T.mptcp_throughput(_conv(rd), iters=400, backend=port_be,
                           warm=b0.rates, device=CPU)
    np.testing.assert_array_equal(c.rates, b.rates)


def test_mptcp_fraction_of_optimal():
    """Fig 8: k=8 routing + MPTCP reaches >= ~86% of optimal throughput
    (the port's copy of the reference's paper-claims test)."""
    top = T.jellyfish(60, 10, 7, seed=5)  # slightly oversubscribed
    comm = T.random_permutation_traffic(top, seed=6)
    opt = T.lp_concurrent_flow(T.build_path_system(top, comm, k=24,
                                                   max_slack=4, device=CPU))
    mp = T.mptcp_throughput(T.build_path_system(top, comm, k=8, device=CPU),
                            iters=1500, device=CPU)
    frac = mp.mean_throughput / max(opt.normalized_throughput(), 1e-9)
    assert frac >= 0.86, f"mptcp/optimal = {frac:.3f}"


def test_mptcp_feasible_and_empty():
    _, _, rps = _system(7)
    ps = _conv(rps)
    res = T.mptcp_throughput(ps, iters=600, device=CPU)
    assert np.all(ps.loads(res.rates) <= ps.capacities * (1 + 1e-5))
    assert np.all((res.per_flow >= 0) & (res.per_flow <= 1 + 1e-6))
    empty = dataclasses.replace(
        ps, path_edges=np.zeros((0, 1), np.int32),
        path_len=np.zeros(0, np.int32), path_owner=np.zeros(0, np.int32),
        demands=np.zeros(0, np.float32), n_commodities=0)
    out = T.mptcp_throughput(empty, device=CPU)
    assert out.mean_throughput == 0.0 and out.iters == 0


@pytest.mark.parametrize("contiguous", [True, False])
def test_segment_sums_are_sequential_left_to_right(contiguous):
    rng = np.random.default_rng(3)
    K, P = 40, 300
    owner = np.sort(rng.integers(0, K, P))
    if not contiguous:  # a spliced system: rows of a commodity scattered
        owner = rng.permutation(owner)
    owner[:K] = np.arange(K)  # every commodity owns a row
    x = (rng.random(P) * 10.0 ** rng.integers(-6, 3, P)).astype(np.float32)
    cols = _columns(PathSystemBatch._owner_table(owner, K, P),
                    torch.device(CPU))
    got = port_mptcp._segment_sum(torch.from_numpy(x), cols).numpy()
    want = np.zeros(K, np.float32)
    for p in range(P):  # left to right, in float32
        want[owner[p]] = np.float32(want[owner[p]] + x[p])
    np.testing.assert_array_equal(got, want)
    xla = np.asarray(jnp.zeros(K, jnp.float32).at[jnp.asarray(owner)].add(
        jnp.asarray(x)))
    np.testing.assert_array_equal(got, xla)
