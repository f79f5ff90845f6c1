"""The port's CUDA kernels against their plain torch versions, on the card,
and the serving path on the card against the CPU.

Every test here needs an NVIDIA GPU with CUDA and ``nvcc`` (the kernels are
compiled at first use); without one each test skips with a reason.  This
file imports torch and the port only (no JAX), so it also runs on a machine
that has no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: min-plus (both forms) and admission are exact (small-integer
sums, minimums and comparisons in float32 and int16, split-K included:
min does not depend on order); congestion and matmul are held to rtol 1e-5
against the plain product because the two sum in different orders; batch
members of one congestion call, with or without extents, equal the single
call on their unpadded incidence bit for bit (the kernel's sums run in an
order fixed by position), and so does a batched dense MW solve.  The fan-in
loads kernel equals its plain version bit for bit (the same additions in the
same order), and a simulation on it stays within 2e-6 of the CPU's, as the
card's MPTCP and waterfill runs do.  lambda_2 on the card
agrees with the CPU run from the same start block within rtol 1e-4, and a
delta update on the card equals a rebuild exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch import capacity, kernels
from repro_torch.core import (
    build_path_system,
    expand_to,
    extend_server_permutation,
    fail_links,
    jellyfish,
    mw_concurrent_flow,
    mw_concurrent_flow_batch,
    permutation_commodities,
    random_permutation_traffic,
    random_server_permutation,
    update_path_system,
)
from repro_torch.core.metrics import apsp_hops_blocked
from repro_torch.core.routing import clear_routing_cache
from repro_torch.kernels import _build, ops
from repro_torch.kernels.admission import admission, admission_ref
from repro_torch.kernels.congestion import congestion, congestion_ref
from repro_torch.kernels.fanin import _ir_operands, fan_in_loads, fan_in_table
from repro_torch.kernels.minplus import (
    INT16_INF,
    minplus,
    minplus_hops,
    minplus_hops_ref,
    minplus_ref,
    pair_rate,
)
from repro_torch.kernels.power import matmul, matmul_ref

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


_MINPLUS_SHAPES = [(1, 1, 1), (65, 33, 130), (128, 128, 128), (720, 720, 720),
                   (7, 300, 5), (721, 333, 1000), (738, 738, 738),
                   (2048, 8192, 8192)]


@pytest.mark.parametrize("m,k,n", _MINPLUS_SHAPES)
def test_minplus_kernel_exact(dev, m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    a = torch.from_numpy(_hops(rng, (m, k))).to(dev)
    b = torch.from_numpy(_hops(rng, (k, n))).to(dev)
    before = kernels.minplus.launches
    got = minplus(a, b)
    torch.cuda.synchronize()
    assert kernels.minplus.launches == before + 1
    assert torch.equal(got, minplus_ref(a, b))


def _int16(a):
    return torch.where(torch.isfinite(a), a, float(INT16_INF)).to(torch.int16)


@pytest.mark.parametrize("m,k,n", _MINPLUS_SHAPES + [(5, 6, 7), (4, 16, 10)])
def test_minplus_hops_kernel_exact(dev, m, k, n):
    rng = np.random.default_rng(m * 1000 + k)
    a = _int16(torch.from_numpy(_hops(rng, (m, k))).to(dev))
    b = _int16(torch.from_numpy(_hops(rng, (k, n))).to(dev))
    # entries up to just below the working infinity 16383
    a[0, 0], b[0, 0] = 16382, 1
    before = kernels.launch_counts()
    got = minplus_hops(a, b)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["minplus_hops"] == before["minplus_hops"] + 1
    assert after["minplus"] == before["minplus"]
    assert got.dtype == torch.int16
    assert torch.equal(got, minplus_hops_ref(a, b))
    # into a row band of a larger matrix (the APSP driver's call)
    big = torch.full((m + 3, n), -1, dtype=torch.int16, device=dev)
    minplus_hops(a, b, out=big[3:])
    assert torch.equal(big[3:], got) and bool((big[:3] == -1).all())
    # negative entries load as 0 in both versions (no 16-bit wrap)
    a[a == 3] = -3
    b[b == 5] = -32768
    assert torch.equal(minplus_hops(a, b), minplus_hops_ref(a, b))


def test_pair_rates_measured(dev):
    for form in ("dpx", "f32"):
        rate = pair_rate(form, device=dev, blocks_per_sm=2, iters=64)
        assert np.isfinite(rate) and rate > 0


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


@pytest.mark.parametrize("bt,p,s,ext", [
    (1, 1, 1, None), (3, 100, 37, None), (2, 1000, 700, None),
    (4, 129, 4100, None),
    # a filler member (no rows), S_b not a multiple of 4 under 16-byte copies
    (4, 300, 4100, ([300, 171, 1, 0], [4100, 4097, 2, 4099])),
    # odd S (single-float copies), S % 4 == 2 (8-byte copies)
    (3, 260, 703, ([260, 129, 0], [703, 350, 1])),
    (2, 1000, 702, ([999, 128], [701, 702])),
])
def test_congestion_kernel_matches_plain(dev, bt, p, s, ext):
    rng = np.random.default_rng(bt * p + s)
    b = _incidence(rng, bt, p, s)
    r = rng.random((bt, p), np.float32)
    w = rng.random((bt, s), np.float32) * 1e-3
    rows, cols = ext if ext is not None else ([p] * bt, [s] * bt)
    for i, (pi, si) in enumerate(zip(rows, cols)):
        # beyond the extents: NaN, which any read would spread
        b[i, pi:], b[i, :, si:], r[i, pi:], w[i, si:] = (np.nan,) * 4
    b, r, w = (torch.from_numpy(x).to(dev) for x in (b, r, w))
    before = kernels.launch_counts()
    loads, costs = congestion(b, r, w, extents=ext)
    after = kernels.launch_counts()
    assert after["congestion_batch"] == before["congestion_batch"] + 1
    ref_l, ref_c = congestion_ref(b, r, w, extents=ext)
    torch.testing.assert_close(loads, ref_l, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(costs, ref_c, rtol=1e-5, atol=1e-8)
    # each member equals the single call on its unpadded incidence bit for
    # bit (zeros beyond the extents), and so does that incidence
    # zero-padded to a larger envelope
    for i, (pi, si) in enumerate(zip(rows, cols)):
        assert not loads[i, si:].any() and not costs[i, pi:].any()
        if pi == 0:
            assert not loads[i].any()
            continue
        bi = b[i, :pi, :si].contiguous()
        ri, wi = r[i, :pi].contiguous(), w[i, :si].contiguous()
        l1, c1 = congestion(bi, ri, wi)
        assert torch.equal(l1, loads[i, :si]) and torch.equal(c1, costs[i, :pi])
        bp = torch.zeros((pi + 70, si + 300), device=dev)
        bp[:pi, :si] = bi
        rp = torch.zeros(pi + 70, device=dev)
        rp[:pi] = ri
        wp = torch.zeros(si + 300, device=dev)
        wp[:si] = wi
        lp, cp = congestion(bp, rp, wp)
        assert torch.equal(lp[:si], l1) and torch.equal(cp[:pi], c1)


def test_dense_batch_equals_sequential_on_card(dev):
    """A ragged batch over the members' extents (bucketed to 4 with an empty
    filler) equals the sequential dense solves bit for bit."""
    clear_routing_cache()
    systems = []
    for n, d, seed in ((40, 5, 0), (64, 6, 1), (30, 4, 2)):
        top = jellyfish(n, d + 3, d, seed=seed)
        systems.append(build_path_system(
            top, random_permutation_traffic(top, seed=seed), k=8,
            max_slack=3, device=dev, cache=False))
    bat = mw_concurrent_flow_batch(systems, iters=150, backend="dense",
                                   device=dev)
    for ps, got in zip(systems, bat):
        want = mw_concurrent_flow(ps, iters=150, backend="dense", device=dev)
        assert got.alpha == want.alpha
        assert np.array_equal(got.rates, want.rates)


def test_apsp_minplus_blocked_on_card(dev, monkeypatch):
    top = jellyfish(300, 12, 8, seed=3)
    want = apsp_hops_blocked(top.adjacency())
    # the int16 form (the driver's choice at this size), then float32, as
    # the shape rule takes it above HOPS_MAX_N nodes
    for limit, counter in ((ops.HOPS_MAX_N, "minplus_hops"), (0, "minplus")):
        monkeypatch.setattr(ops, "HOPS_MAX_N", limit)
        before = kernels.launch_counts()
        got = ops.apsp_minplus_blocked(top.adjacency(), bm=128, device=dev)
        after = kernels.launch_counts()
        assert after[counter] > before[counter]
        np.testing.assert_array_equal(got, want)


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
    assert after["minplus_hops"] > before["minplus_hops"]
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


def _within_forward_bound(c, a, b):
    """|C - AB| <= gamma_K |A| |B| elementwise, AB in float64, gamma_K =
    K u / (1 - K u) with u the unit roundoff of C's type: the forward error
    bound of a K-term dot product in any summation order.  Kernel and plain
    version sum in different orders, so at K = 4096 with standard-normal
    operands they differ by up to ~3e-4 while both meet this bound.  A
    float64 C is held to 2 gamma_K: its float64 reference rounds too."""
    k = a.shape[1]
    u = 2.0 ** -24 if c.dtype == torch.float32 else 2.0 ** -53
    gamma = k * u / (1 - k * u) * (1 if c.dtype == torch.float32 else 2)
    exact = a.double() @ b.double()
    bound = gamma * (a.double().abs() @ b.double().abs())
    assert bool(((c.double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("m,k,n,dtype", [
    (1, 1, 1, torch.float32), (65, 33, 130, torch.float32),
    (1024, 1024, 1024, torch.float32), (4096, 4096, 8, torch.float32),
    (300, 517, 70, torch.float64), (7, 300, 5, torch.float64),
    # the narrow kernel (N <= 16): odd K takes its single-element copies
    (1, 8191, 1, torch.float32), (792, 791, 8, torch.float32),
    (792, 792, 8, torch.float32), (8192, 1025, 16, torch.float32),
    (8192, 8192, 8, torch.float32), (792, 792, 8, torch.float64),
    (8192, 513, 1, torch.float64), (1, 4097, 16, torch.float64)])
def test_matmul_kernel_matches_plain(dev, m, k, n, dtype):
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.standard_normal((m, k))).to(dev, dtype)
    b = torch.from_numpy(rng.standard_normal((k, n))).to(dev, dtype)
    before = kernels.power.launches
    got = matmul(a, b)
    torch.cuda.synchronize()
    assert kernels.power.launches == before + 1
    assert got.dtype == dtype
    torch.backends.cuda.matmul.allow_tf32 = False
    _within_forward_bound(got, a, b)
    _within_forward_bound(matmul_ref(a, b), a, b)
    # transposed operands and the column-major Q of QR, read in place
    q, _ = torch.linalg.qr(b) if k >= n else (b, None)
    at = a.T.contiguous().T
    assert not at.is_contiguous() or m == 1 or k == 1
    _within_forward_bound(matmul(at, q), a, q)


def test_power_iteration_on_card_matches_cpu(dev):
    top = jellyfish(300, 12, 8, seed=3)
    v0 = np.random.default_rng(0).standard_normal((300, 8)).astype(np.float32)
    before = kernels.power.launches
    got = ops.power_iteration_lambda2(top.adjacency(), iters=100, v0=v0,
                                      device=dev)
    assert kernels.power.launches == before + 101
    want = ops.power_iteration_lambda2(top.adjacency(), iters=100, v0=v0,
                                       device="cpu")
    assert got == pytest.approx(want, rel=1e-4)


def test_delta_update_on_card_equals_rebuild(dev):
    top = jellyfish(400, 12, 8, seed=0)
    perm = random_server_permutation(top.n_servers, seed=0)
    comm = permutation_commodities(top, perm)
    clear_routing_cache()
    ps = build_path_system(top, comm, k=8, device=dev)
    grown = expand_to(top, 404, 12, 8, seed=1)
    perm = extend_server_permutation(perm, grown.n_servers, seed=2)
    comm = permutation_commodities(grown, perm)
    failed = fail_links(grown, 0.03, seed=3)
    for old, new in ((top, grown), (grown, failed)):
        before = kernels.launch_counts()
        ps = update_path_system(ps, old, new, comm, device=dev)
        assert kernels.launch_counts()["admission"] > before["admission"]
        full = build_path_system(new, comm, k=8, cache=False, device=dev)
        w = max(ps.path_edges.shape[1], full.path_edges.shape[1])
        pad = [np.pad(x.path_edges, ((0, 0), (0, w - x.path_edges.shape[1])),
                      constant_values=2 * x.n_edges) for x in (ps, full)]
        np.testing.assert_array_equal(pad[0], pad[1])
        for f in ("path_len", "path_owner", "unrouted", "demands"):
            np.testing.assert_array_equal(getattr(ps, f), getattr(full, f))


def test_congestion_loads_extents_on_card(dev):
    """``ops.congestion_loads`` over extents: each member equals the single
    call on its unpadded incidence bit for bit, a filler member is zeros."""
    rng = np.random.default_rng(5)
    sizes = [(300, 4100), (171, 4097), (0, 0), (64, 703)]
    P, S = 300, 4100
    b = _incidence(rng, len(sizes), P, S)
    r = rng.random((len(sizes), P), np.float32)
    for i, (pi, si) in enumerate(sizes):
        b[i, pi:], b[i, :, si:], r[i, pi:] = (np.nan,) * 3
    b, r = torch.from_numpy(b).to(dev), torch.from_numpy(r).to(dev)
    ext = ([p for p, _ in sizes], [s for _, s in sizes])
    before = kernels.launch_counts()
    loads = ops.congestion_loads(b, r, extents=ext)
    assert kernels.launch_counts()["congestion_batch"] == \
        before["congestion_batch"] + 1
    for i, (pi, si) in enumerate(sizes):
        assert not loads[i, si:].any()
        if pi == 0:
            assert not loads[i].any()
            continue
        one = ops.congestion_loads(b[i, :pi, :si].contiguous(),
                                   r[i, :pi].contiguous())
        assert torch.equal(one, loads[i, :si])


def _bits(x):
    return x.contiguous().view(torch.int32).cpu()


def _cell_operands(dev):
    """The sim cell's fan-in table: 8 members of RRG(512, 24, 18), k = 8,
    slack 4, with their slot extents and uniform rates, zero on padded
    rows (as in the engine) and on a tenth of the real ones."""
    from repro_torch.core import build_path_system_batch

    tops = [jellyfish(512, 24, 18, seed=s) for s in range(8)]
    comms = [random_permutation_traffic(t, seed=s) for s, t in enumerate(tops)]
    batch = build_path_system_batch(tops, comms, k=8, max_slack=4,
                                    device=dev)
    rng = np.random.default_rng(0)
    rates = rng.uniform(0.5, 1.5, (batch.n_batch, batch.p_max))
    rates[rng.random(rates.shape) < 0.1] = 0.0
    for i, p in enumerate(batch.n_paths.tolist()):
        rates[i, p:] = 0.0
    return (fan_in_table(batch.slot_gather, dev),
            torch.from_numpy(rates.astype(np.float32)).to(dev),
            batch.path_edges.shape[-1], [ps.n_slots for ps in batch.systems])


def _fan_in_case(dev, case):
    if case == "cell":
        return _cell_operands(dev)
    if case == "shared":
        table, rates, L, _ = _ir_operands(dev, shared=True,
                                          shape=(700, 4, 2050),
                                          slots=(2050,) * 5)
        return table, rates, L, None
    if case == "members-130":  # past the launch's 128 members
        return _ir_operands(dev, shape=(20, 3, 70),
                            slots=tuple(i % 71 for i in range(130)), seed=3)
    # ragged: a member with no rows, extents off every multiple of the
    # block, empty slots, zero and -0.0 rates (rows as long as D keep -0.0:
    # the member with the fewest slots has the widest rows)
    table, rates, L, slots = _ir_operands(
        dev, shape=(300, 4, 4100), slots=(4100, 4097, 0, 703, 129), seed=1)
    rates[4] = -0.0
    rates[3, ::3] = 0.0
    return table, rates, L, slots


@pytest.mark.parametrize("case", ["cell", "ragged", "shared", "members-130"])
def test_fan_in_kernel_equals_plain_bit_for_bit(dev, case):
    """The fan-in kernel against its plain version on the same operands,
    bit for bit (``.view(torch.int32)``): every real slot, the exact zeros
    past each member's extent, the signs of zero sums."""
    table, rates, L, slots = _fan_in_case(dev, case)
    before = kernels.launch_counts()["fan_in_loads"]
    got = fan_in_loads(table, rates, L, slots)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["fan_in_loads"] == before + 1
    want = fan_in_loads(table.cpu(), rates.cpu(), L, slots)
    assert torch.equal(_bits(got), _bits(want))
    if slots is not None:
        for i, s in enumerate(slots):
            assert torch.equal(_bits(got[i, s:]), _bits(torch.zeros(
                got.shape[1] - s)))
    if case == "ragged":  # -0.0 survives only in rows as long as D
        full = (table[4].cpu() < rates.shape[1] * L).all(dim=0)
        assert full.any()
        assert torch.signbit(got[4].cpu()[full]).all()
        assert not torch.signbit(got[4].cpu()[~full]).any()


def test_simulate_ksp_lc_on_fan_in_kernel_matches_cpu(dev):
    """``ksp_lc`` under ``auto`` on the card: every loads call is one launch
    of the fan-in kernel and none of the dense one; from one numpy-drawn
    stream, admissions equal the CPU's ``gather`` run and every
    accumulator lies within 2e-6 of it."""
    from repro_torch import obs
    from repro_torch.analysis.contracts import check_sim_state
    from repro_torch.sim import SimConfig, simulate, steady_poisson

    batch = _sim_systems(dev)
    T, A = 40, 8
    wl = steady_poisson(T, rate=6.0, size=12.0)
    cfg = SimConfig(max_flows=512, max_arrivals=A, wf_iters=6)
    rng = np.random.default_rng(9)
    n = rng.poisson(6.0, (T, batch.n_batch))
    comm = np.stack([rng.integers(0, ps.n_commodities, (T, A))
                     for ps in batch.systems], axis=1)
    stream = (n, comm, np.zeros(comm.shape, bool))
    calls = obs.counter("sim/loads_calls")
    before, c0 = kernels.launch_counts(), calls.value
    card = simulate(batch, wl, policy="ksp_lc", config=cfg, arrivals=stream,
                    device=dev)
    after = kernels.launch_counts()
    assert card.backend == "gather"
    assert calls.value - c0 > 0
    assert after["fan_in_loads"] - before["fan_in_loads"] == calls.value - c0
    assert after["congestion_batch"] == before["congestion_batch"]
    check_sim_state(card)
    cpu = simulate(batch, wl, policy="ksp_lc", config=cfg, arrivals=stream,
                   backend="gather", device="cpu")
    for f in ("admitted", "drops", "comm_offered"):
        assert np.array_equal(getattr(card, f), getattr(cpu, f)), f
    for f in ("throughput", "active", "fct_hist", "fct_sum", "fct_count",
              "comm_delivered", "util_sum", "inflight"):
        np.testing.assert_allclose(getattr(card, f), getattr(cpu, f),
                                   atol=2e-6, err_msg=f)


def _sim_systems(dev):
    from repro_torch.core import build_path_system_batch

    tops = [jellyfish(60, 10, 6, seed=s) for s in range(3)]
    comms = [random_permutation_traffic(t, seed=s + 10)
             for s, t in enumerate(tops)]
    return build_path_system_batch(tops, comms, k=8, max_slack=3, device=dev)


def test_simulate_on_card_deterministic(dev):
    from repro_torch.analysis.contracts import check_sim_state
    from repro_torch.sim import (
        SimConfig,
        simulate,
        steady_poisson,
        steady_state_throughput,
    )

    batch = _sim_systems(dev)
    wl = steady_poisson(40, rate=6.0, size=12.0)
    cfg = SimConfig(max_flows=512, max_arrivals=8, wf_iters=6)
    runs = {}
    for key, be in (("a", "dense"), ("b", "dense"), ("g", "gather")):
        before = kernels.launch_counts()
        runs[key] = simulate(batch, wl, policy="ecmp", config=cfg, seed=3,
                             backend=be, device=dev)
        launched = kernels.launch_counts()["congestion_batch"] \
            - before["congestion_batch"]
        assert (launched > 0) == (be == "dense")
    a, b, g = runs["a"], runs["b"], runs["g"]
    check_sim_state(a)
    for f in ("throughput", "comm_delivered", "comm_offered", "fct_hist",
              "util_sum", "admitted", "drops"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    # ecmp's choices do not depend on loads: the same arrivals and paths,
    # rates to the dense product's rounding
    assert np.array_equal(a.admitted, g.admitted)
    np.testing.assert_allclose(steady_state_throughput(a),
                               steady_state_throughput(g), rtol=1e-4)


def test_mptcp_and_waterfill_on_card(dev):
    from repro_torch.core import mptcp_throughput
    from repro_torch.sim import waterfill_rates

    batch = _sim_systems(dev)
    ps = batch.systems[0]
    before = kernels.launch_counts()
    dense = mptcp_throughput(ps, iters=600, backend="dense", device=dev)
    assert kernels.launch_counts()["congestion"] == before["congestion"] + 602
    gather = mptcp_throughput(ps, iters=600, backend="gather", device=dev)
    cpu = mptcp_throughput(ps, iters=600, backend="gather", device="cpu")
    np.testing.assert_allclose(dense.per_flow, gather.per_flow, atol=1e-4)
    np.testing.assert_allclose(gather.per_flow, cpu.per_flow, atol=2e-6)
    rd, ld = waterfill_rates(batch, wf_iters=32, backend="dense", device=dev)
    rg, lg = waterfill_rates(batch, wf_iters=32, backend="gather", device=dev)
    np.testing.assert_allclose(rd, rg, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ld, lg, rtol=1e-5, atol=1e-6)


def test_build_batch_and_pipeline_on_card(dev):
    from repro_torch.core import build_path_system_batch, stream_builds

    tops = [jellyfish(80, 10, 6, seed=s) for s in range(2)]
    comms = [random_permutation_traffic(t, seed=s) for s, t in enumerate(tops)]
    clear_routing_cache()
    cpu = build_path_system_batch(tops, comms, k=8, max_slack=3,
                                  device="cpu", cache=False)

    def thunk():
        return build_path_system_batch(tops, comms, k=8, max_slack=3,
                                       device=dev, cache=False)

    counts = {}
    for on in (True, False):
        before = kernels.launch_counts()
        out = list(stream_builds([thunk, thunk], enabled=on, device=dev))
        after = kernels.launch_counts()
        counts[on] = {k: after[k] - before[k] for k in after}
        for got in out:
            for a, b in zip(got.systems, cpu.systems):
                for f in ("path_edges", "path_len", "path_owner", "demands"):
                    assert np.array_equal(getattr(a, f), getattr(b, f)), f
    # launches from the pipeline's worker thread are all counted
    assert counts[True] == counts[False]
    assert counts[True]["admission"] > 0 and counts[True]["minplus_hops"] > 0


_EVENT_FIELDS = ("throughput", "active", "fct_hist", "fct_sum", "fct_count",
                 "comm_delivered", "comm_offered", "util_sum", "drops",
                 "admitted", "blackholed", "blackholed_total", "inflight")


def _event_instances():
    tops = [jellyfish(60, 10, 6, seed=s) for s in range(3)]
    comms = [random_permutation_traffic(t, seed=s + 10)
             for s, t in enumerate(tops)]
    return tops, comms


@pytest.mark.parametrize("policy", ["ksp_lc", "ecmp"])
def test_simulate_events_empty_schedule_on_card(dev, policy):
    """CT-segment on the card: an empty schedule, whole or split by
    ``max_seg``, equals ``simulate`` on the fan-in kernel (``auto``'s
    choice for the loads-only product) bit for bit."""
    from repro_torch.sim import (
        SimConfig,
        simulate,
        simulate_events,
        steady_poisson,
    )

    tops, comms = _event_instances()
    systems = _sim_systems(dev).systems
    wl = steady_poisson(40, rate=6.0, size=12.0)
    cfg = SimConfig(max_flows=512, max_arrivals=8, wf_iters=6)
    base = simulate(systems, wl, policy=policy, config=cfg, seed=3,
                    device=dev)
    assert base.backend == "gather"
    for max_seg in (0, 15):
        before = kernels.launch_counts()
        ev = simulate_events(tops, comms, [], wl, systems=systems,
                             policy=policy, config=cfg, seed=3,
                             max_seg=max_seg, device=dev)
        after = kernels.launch_counts()
        assert after["fan_in_loads"] > before["fan_in_loads"]
        assert after["congestion_batch"] == before["congestion_batch"]
        assert ev.result.backend == "gather"
        for f in _EVENT_FIELDS:
            assert np.array_equal(getattr(ev.result, f),
                                  getattr(base, f)), (max_seg, f)


def test_simulate_events_fail_heal_dense_vs_gather_on_card(dev):
    """A fail / heal run on the card, dense against gather from one stream
    of every segment: the same migrations (``ecmp`` reselects by hash,
    not by load), every accumulator within 1e-3 of its largest magnitude
    (the dense product's rounding; ``chip_smoke.py``'s bound)."""
    from repro_torch.analysis.contracts import check_sim_state
    from repro_torch.sim import (
        Event,
        SimConfig,
        draw_arrivals,
        simulate_events,
        steady_poisson,
    )

    tops, comms = _event_instances()
    wl = steady_poisson(36, rate=6.0, size=12.0)
    cfg = SimConfig(max_flows=512, max_arrivals=8, wf_iters=6)
    sched = [Event(step=10, kind="fail_links", n_links=6, seed=2, tag="f"),
             Event(step=22, kind="heal_links", heal_of="f")]

    def arrivals(ts, logits, eos):
        return draw_arrivals(4, ts, wl.rate[ts], logits, eos, 0.0,
                             cfg.max_arrivals, device="cpu")

    runs = {be: simulate_events(tops, comms, sched, wl, policy="ecmp",
                                config=cfg, seed=4, backend=be, device=dev,
                                arrivals=arrivals)
            for be in ("dense", "gather")}
    d, g = runs["dense"], runs["gather"]
    assert d.result.backend == "dense" and g.result.backend == "gather"
    check_sim_state(d.result)
    assert len(d.events) == 2 and d.result.blackholed_total.sum() > 0
    for rd, rg in zip(d.events, g.events):
        for f in ("survived", "reselected", "killed"):
            assert np.array_equal(rd[f], rg[f]), f
    for f in _EVENT_FIELDS:
        x = np.asarray(getattr(d.result, f), np.float64)
        y = np.asarray(getattr(g.result, f), np.float64)
        assert np.abs(x - y).max() <= 1e-3 * max(np.abs(y).max(), 1.0), f


def test_fabric_ring_and_delta_on_card_equal_cpu(dev):
    """A 256-pod Jellyfish ring and a ``fail -> path_system`` delta through
    ``FabricModel`` on the card equal the CPU's (host BFS, numpy admission)
    exactly; the card's run launches the int16 min-plus and the admission
    kernel, the CPU's launches nothing."""
    from repro_torch.fabric import make_fabric

    runs = {}
    for where in ("cuda", "cpu"):
        clear_routing_cache()
        kernels.reset_launch_counts()
        fb = make_fabric("jellyfish", n_pods=256, degree=8, seed=0,
                         device=dev if where == "cuda" else "cpu")
        comm = random_permutation_traffic(fb.topology, seed=0)
        emb = fb.ring()
        fb.path_system(comm)
        ps = fb.fail(0.1, seed=1).path_system(comm)
        runs[where] = (emb, ps, kernels.launch_counts())
    (eg, pg, cg), (ec, pc, cc) = runs["cuda"], runs["cpu"]
    assert np.array_equal(eg.order, ec.order) and eg.hop_paths == ec.hop_paths
    assert (eg.stretch, eg.congestion) == (ec.stretch, ec.congestion)
    assert pg.row_map is not None and np.array_equal(pg.row_map, pc.row_map)
    for f in ("path_edges", "path_len", "path_owner", "demands", "src", "dst",
              "unrouted"):
        assert np.array_equal(getattr(pg, f), getattr(pc, f)), f
    assert cg["minplus_hops"] > 0 and cg["admission"] > 0
    assert not any(cc.values())


@pytest.mark.parametrize("arch", ["minitron-8b", "qwen2-moe-a2.7b",
                                  "rwkv6-1.6b", "recurrentgemma-2b",
                                  "mixtral-8x22b"])
def test_serving_path_on_card_equals_cpu(dev, arch):
    """The serving path at ``reduced()`` in float32 (TF32 off), the same
    weights on the card and on the CPU: prefill logits and every cache
    tensor, then 10 greedy decode steps (a 24-token prompt wraps the 16-slot
    windows, the steps pass position 32), within the CPU parity tests'
    bounds (logits rtol 1e-4, atol 2e-5; caches rtol 1e-4, atol 5e-5),
    cache positions and greedy tokens equal.  No kernel of the port runs."""
    from repro_torch.configs import get
    from repro_torch.models import LM, decode_step, init_params, prefill

    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = get(arch).reduced()
    cpu = init_params(cfg, seed=0, device="cpu")
    card = LM(cfg, seed=None, device=dev)
    card.load_state_dict(cpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(1))
    kernels.reset_launch_counts()
    lc, cc = prefill(cpu, {"tokens": toks}, max_len=34)
    lg, cg = prefill(card, {"tokens": toks.to(dev)}, max_len=34)
    tol = dict(rtol=1e-4, atol=2e-5)
    assert torch.allclose(lg.cpu(), lc, **tol)
    for a, b in zip(cg, cc):
        for k in b:
            if k == "abs_pos":
                assert torch.equal(a[k].cpu(), b[k])
            else:
                assert torch.allclose(a[k].cpu(), b[k], rtol=1e-4, atol=5e-5)
    for i in range(10):
        tc = torch.argmax(lc[:, :cfg.vocab_size], -1)
        tg = torch.argmax(lg[:, :cfg.vocab_size], -1)
        assert torch.equal(tg.cpu(), tc)
        lc, cc = decode_step(cpu, cc, tc, 24 + i)
        lg, cg = decode_step(card, cg, tg, 24 + i)
        assert torch.allclose(lg.cpu(), lc, **tol)
    assert not any(kernels.launch_counts().values())


def test_one_rank_card_mesh_step_equals_unsharded(dev):
    """The sharded train step on ``make_local_mesh()`` over the card (an
    NCCL mesh of one rank) against ``mesh=None`` from the same weights:
    two steps, parameters, ``mu`` and ``nu`` bit for bit (one rank: no
    collective reorders a sum)."""
    import torch.distributed as dist

    from repro_torch.configs import get
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init

    cfg = get("internvl2-1b").reduced()
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                     generator=g).to(dev)}
    assert not dist.is_initialized()
    try:
        mesh = make_local_mesh()
        assert dist.get_backend() == "nccl" and tuple(mesh.shape) == (1, 1)
        runs = []
        for m in (None, mesh):
            model = init_params(cfg, seed=0, dtype=torch.float32, device=dev)
            opt = adamw_init(model)
            step = make_train_step(cfg, mesh=m, lr=1e-3, dtype=torch.float32)
            for _ in range(2):
                _, opt, metrics = step(model, opt, batch)
            runs.append((model, opt, float(metrics["loss"])))
        (m0, o0, l0), (m1, o1, l1) = runs
        assert l0 == l1
        for (n, a), (_, b) in zip(m0.named_parameters(),
                                  m1.named_parameters()):
            assert torch.equal(a, b.full_tensor()), n
            assert torch.equal(o0.mu[n], o1.mu[n].full_tensor()), n
            assert torch.equal(o0.nu[n], o1.nu[n].full_tensor()), n
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_ir_audit_on_card_is_clean_and_reaches_every_kernel(dev):
    """The dispatch-level audit on the card: no finding beyond the recorded
    exemptions, and every kernel and dense solver case moved the launch
    counters it names (the kernels launch through ctypes, unseen by the
    dispatcher); a second MW batch in one shape bucket builds nothing."""
    from repro_torch.analysis import irlint, retrace
    from repro_torch.analysis.registry import registered_entries

    _build.build_all()
    findings, rows = irlint.audit_entries(registered_entries(), dev)
    assert findings == [], "\n".join(map(str, findings))
    assert rows
    for row in rows:
        for name in row["kernels"]:
            assert row["launches"].get(name, 0) > 0, row
    systems = []
    for s in range(4):
        top = jellyfish(22 + 2 * (s % 2), 8, 4, seed=s)
        comm = random_permutation_traffic(top, seed=s + 5)
        systems.append(build_path_system(top, comm, k=4, device=dev))
    mw_concurrent_flow_batch(systems[:2], iters=24, device=dev)
    before = retrace.solver_cache_sizes()
    with retrace.track_compiles() as c:
        mw_concurrent_flow_batch(systems[2:], iters=24, device=dev)
    assert c.count == 0, c.events
    assert retrace.solver_cache_sizes() == before
