"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU with CUDA and ``nvcc`` (the kernels are
compiled at first use); without one each test skips with a reason.  This
file imports torch and the port only (no JAX), so it also runs on a machine
that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: min-plus and admission are exact (small-integer sums, minimums
and comparisons in float32); congestion is held to rtol 1e-5 against the
plain product because the two sum in different orders; batch members of
one congestion call equal the single call bit for bit (the kernel's sums
run in an order fixed by position).
"""

import numpy as np
import pytest
import torch

from repro_torch import capacity, kernels
from repro_torch.core import (
    build_path_system,
    jellyfish,
    mw_concurrent_flow,
    mw_concurrent_flow_batch,
    random_permutation_traffic,
)
from repro_torch.core.metrics import apsp_hops_blocked
from repro_torch.core.routing import clear_routing_cache
from repro_torch.kernels import _build, ops
from repro_torch.kernels.admission import admission, admission_ref
from repro_torch.kernels.congestion import congestion, congestion_ref
from repro_torch.kernels.minplus import minplus, minplus_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA: the port's kernels have "
                    "no CPU mode (their plain versions are tested elsewhere)")
    return torch.device("cuda")


def _hops(rng, shape, p_inf=0.2):
    a = rng.integers(0, 9, size=shape).astype(np.float32)
    a[rng.random(shape) < p_inf] = np.inf
    return a


def test_kernels_build(dev):
    _build.build_all()
    for name in _build.SOURCES:
        assert _build._lib_path(name).exists()


@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (65, 33, 130), (128, 128, 128),
                                   (720, 720, 720), (7, 300, 5)])
def test_minplus_kernel_exact(dev, m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    a = torch.from_numpy(_hops(rng, (m, k))).to(dev)
    b = torch.from_numpy(_hops(rng, (k, n))).to(dev)
    before = kernels.minplus.launches
    got = minplus(a, b)
    torch.cuda.synchronize()
    assert kernels.minplus.launches == before + 1
    assert torch.equal(got, minplus_ref(a, b))


@pytest.mark.parametrize("m,c,w", [(1, 1, 0), (300, 37, 5), (4096, 36, 6),
                                   (17, 200, 1)])
def test_admission_kernel_exact(dev, m, c, w):
    rng = np.random.default_rng(m + c + w)
    d = torch.from_numpy(_hops(rng, (m, c), 0.1)).to(dev)
    rem = torch.from_numpy(rng.integers(0, 6, m).astype(np.float32)).to(dev)
    cand = torch.from_numpy(rng.integers(0, 50, (m, c)).astype(np.int32)).to(dev)
    pref = torch.from_numpy(rng.integers(-1, 50, (m, w)).astype(np.int32)).to(dev)
    before = kernels.admission.launches
    got = admission(d, rem, cand, pref)
    torch.cuda.synchronize()
    assert kernels.admission.launches == before + 1
    assert torch.equal(got, admission_ref(d, rem, cand, pref))


def _incidence(rng, bt, p, s, hops=4):
    b = np.zeros((bt, p, s), np.float32)
    for i in range(bt):
        cols = rng.integers(0, s, (p, hops))
        np.put_along_axis(b[i], cols, 1.0, axis=1)
    return b


@pytest.mark.parametrize("bt,p,s", [(1, 1, 1), (3, 100, 37), (2, 1000, 700),
                                    (4, 129, 4100)])
def test_congestion_kernel_matches_plain(dev, bt, p, s):
    rng = np.random.default_rng(bt * p + s)
    b = torch.from_numpy(_incidence(rng, bt, p, s)).to(dev)
    r = torch.from_numpy(rng.random((bt, p), np.float32)).to(dev)
    w = torch.from_numpy(rng.random((bt, s), np.float32) * 1e-3).to(dev)
    before = kernels.launch_counts()
    loads, costs = congestion(b, r, w)
    after = kernels.launch_counts()
    assert after["congestion_batch"] == before["congestion_batch"] + 1
    ref_l, ref_c = congestion_ref(b, r, w)
    torch.testing.assert_close(loads, ref_l, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(costs, ref_c, rtol=1e-5, atol=1e-8)
    # each batch member equals the single call bit for bit, and so does the
    # member zero-padded to a larger envelope
    for i in range(bt):
        l1, c1 = congestion(b[i].contiguous(), r[i].contiguous(),
                            w[i].contiguous())
        assert torch.equal(l1, loads[i]) and torch.equal(c1, costs[i])
        bp = torch.zeros((p + 70, s + 300), device=dev)
        bp[:p, :s] = b[i]
        rp = torch.zeros(p + 70, device=dev)
        rp[:p] = r[i]
        wp = torch.zeros(s + 300, device=dev)
        wp[:s] = w[i]
        lp, cp = congestion(bp, rp, wp)
        assert torch.equal(lp[:s], l1) and torch.equal(cp[:p], c1)


def test_apsp_minplus_blocked_on_card(dev):
    top = jellyfish(300, 12, 8, seed=3)
    before = kernels.minplus.launches
    got = ops.apsp_minplus_blocked(top.adjacency(), bm=128, device=dev)
    assert kernels.minplus.launches > before
    np.testing.assert_array_equal(got, apsp_hops_blocked(top.adjacency()))


def test_build_and_solve_on_card(dev):
    top = jellyfish(60, 10, 6, seed=1)
    comm = random_permutation_traffic(top, seed=2)
    clear_routing_cache()
    cpu_ps = build_path_system(top, comm, k=8, max_slack=3, device="cpu",
                               cache=False)
    # the default admission backend (auto) takes the kernel on the card
    before = kernels.launch_counts()
    gpu_ps = build_path_system(top, comm, k=8, max_slack=3, device=dev,
                               cache=False)
    after = kernels.launch_counts()
    assert after["admission"] > before["admission"]
    assert after["minplus"] > before["minplus"]
    for f in ("path_edges", "path_len", "path_owner", "demands"):
        np.testing.assert_array_equal(getattr(gpu_ps, f), getattr(cpu_ps, f))
    # CT-batch on the card: batched == sequential bit for bit under gather
    seq = mw_concurrent_flow(gpu_ps, iters=120, backend="gather", device=dev)
    bat = mw_concurrent_flow_batch([gpu_ps, gpu_ps, gpu_ps], iters=120,
                                   backend="gather", device=dev)
    assert all(r.alpha == seq.alpha for r in bat)
    assert np.array_equal(bat[1].rates, seq.rates)
    # the dense kernel path agrees with gather to the anneal's drift
    before = kernels.congestion.batch_launches
    den = mw_concurrent_flow_batch([gpu_ps], iters=120, backend="dense",
                                   device=dev)
    assert kernels.congestion.batch_launches > before
    assert abs(den[0].alpha - seq.alpha) <= 1e-2 * seq.alpha


def test_capacity_probe_on_card(dev):
    top = capacity.jellyfish_same_equipment(45, 6, 54, seed=0)
    assert capacity.supports_full_capacity(top, method="mw", iters=300,
                                           device=dev) == \
        capacity.supports_full_capacity(top, method="mw", iters=300,
                                        mw_backend="gather", device=dev)
