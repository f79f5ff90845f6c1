"""The flow-level simulator (paper §3: Table 1, Fig 9): port against
reference, on the CPU.

Tolerances, and why each holds:

* ``flow_hash``: exact (integer mixing; golden values shared with the
  reference's ``tests/test_sim.py``).
* ``waterfill_rates`` under ``gather``: equal to the reference's bit for
  bit, both freeze rules (the same float32 operations in the same order:
  the loads through the ordered fan-in tables, the minimums exact in any
  order).  Under ``dense`` (the plain product on the CPU, BLAS order):
  rtol 1e-5 against the reference — measured 2.4e-7 on the rates and
  5.4e-7 on the loads.
* ``simulate`` from the arrival stream drawn in JAX exactly as the
  reference's scan draws it (``jax.random`` keyed by ``fold_in(PRNGKey(
  seed), t)``): every accumulator — throughput, active flows, admitted,
  drops, FCT histogram/sum/count, per-commodity offered and delivered
  volume, link utilization, in-flight volume — equal to the reference's
  bit for bit, for all three policies, under ``gather``, on steady,
  elephant/mice, diurnal and multi-epoch permutation-churn workloads and
  with the ``exact`` freeze rule over a 32-slot table.  The offered and
  delivered volumes sum each step's contributions in ascending slot order
  (``_ordered_scatter_add``), as XLA's CPU scatter-add does.  The FCT bins
  use the exact ``floor(log2(age))``; XLA:CPU's ``log2`` rounds 8192 and
  32768 just below the power (checked up to 2^21), ages these horizons
  never reach.
* Under the port's own generator: CT-sim conservation, and two runs with
  one seed equal bit for bit (a different seed differs).
"""

import dataclasses
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core as R
import repro.sim as RS
from repro.sim import engine as ref_engine
import repro_torch.core as T
import repro_torch.sim as PS
from repro_torch import convert, env
from repro_torch.analysis.contracts import ContractViolation, check_sim_state
from repro_torch.core.flow import (
    PathSystemBatch,
    make_congestion_fn_batch,
    make_loads_fn_batch,
)
from repro_torch.kernels import ops
from repro_torch.sim import engine as port_engine

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _conv(ps):
    return convert.path_system_from_numpy(dataclasses.asdict(ps))


def _pair_systems(specs):
    out = []
    for n, ports, net, seed, cseed in specs:
        top = R.jellyfish(n, ports, net, seed=seed)
        rps = R.build_path_system(
            top, R.random_permutation_traffic(top, seed=cseed), k=8)
        out.append((rps, _conv(rps)))
    return out


TINY = _pair_systems([(40, 10, 6, s, s + 10) for s in range(3)])
SMALL = _pair_systems([(60, 10, 6, 1, 2), (40, 10, 6, 2, 3)])


# --------------------------------------------------------------------------- #
# flow hash
# --------------------------------------------------------------------------- #

_HASH_SRC = np.array([0, 3, 17, 250, 511], dtype=np.uint32)
_HASH_DST = np.array([1, 7, 42, 13, 509], dtype=np.uint32)
_HASH_FID = np.array([0, 1, 2**20, 12345, 4294967295], dtype=np.uint32)
_HASH_GOLDEN_5EED = [2060987080, 45655268, 3184681298, 105157940, 3795607632]
_HASH_GOLDEN_0 = [208060452, 2317150453, 3607758292, 2622168110, 44152540]


def test_flow_hash_golden_values():
    got = PS.flow_hash(_HASH_SRC, _HASH_DST, _HASH_FID, 0x5EED)
    assert got.dtype == np.uint32 and got.tolist() == _HASH_GOLDEN_5EED
    assert PS.flow_hash(_HASH_SRC, _HASH_DST, _HASH_FID, 0).tolist() == \
        _HASH_GOLDEN_0
    t = [torch.from_numpy(x.astype(np.int64))
         for x in (_HASH_SRC, _HASH_DST, _HASH_FID)]
    th = PS.flow_hash(*t, 0x5EED)
    assert th.dtype == torch.int64 and th.tolist() == _HASH_GOLDEN_5EED
    assert PS.flow_hash(*t, 0).tolist() == _HASH_GOLDEN_0


def test_flow_hash_torch_matches_reference_numpy():
    rng = np.random.default_rng(0)
    n = 20000
    s, d, f = (rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
               for _ in range(3))
    f[:4] = [0, 1, 2**31, 2**32 - 1]
    for salt in (0, 0x5EED, 2**32 - 1):
        want = RS.flow_hash(s, d, f, salt)
        assert PS.flow_hash(s, d, f, salt).tolist() == want.tolist()
        got = PS.flow_hash(torch.from_numpy(s.astype(np.int64)),
                           torch.from_numpy(d.astype(np.int64)),
                           torch.from_numpy(f.astype(np.int64)), salt)
        assert got.tolist() == want.tolist()


def test_hash_select_rows_and_path_diversity_match_reference():
    rps = R.ecmp_path_system(
        R.jellyfish(48, 10, 6, seed=2),
        R.random_permutation_traffic(R.jellyfish(48, 10, 6, seed=2), seed=3),
        n_ways=16)
    pps = _conv(rps)
    for salt in (1, 2):
        np.testing.assert_array_equal(PS.hash_select_rows(pps, salt),
                                      RS.hash_select_rows(rps, salt))
    want, got = RS.path_diversity(rps), PS.path_diversity(pps)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]))


# --------------------------------------------------------------------------- #
# waterfilling and the loads half
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rule", ["exact", "fast"])
def test_waterfill_matches_reference(rule):
    ref = [r for r, _ in SMALL]
    port = [p for _, p in SMALL]
    want_r, want_l = RS.waterfill_rates(ref, wf_iters=32, rule=rule)
    got_r, got_l = PS.waterfill_rates(port, wf_iters=32, rule=rule,
                                      backend="gather", device=CPU)
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_l, want_l)
    got_r, got_l = PS.waterfill_rates(port, wf_iters=32, rule=rule,
                                      backend="dense", device=CPU)
    np.testing.assert_allclose(got_r, want_r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-5, atol=1e-6)


def _bottlenecked(ps, rates, loads, nflow):
    """Max-min certificate: each flow is limited by a saturated link on its
    path at which its rate is maximal among the crossing flows."""
    E2 = ps.n_slots
    slot_max = np.zeros(E2 + 1)
    for p in range(ps.n_paths):
        if nflow[p] > 0:
            np.maximum.at(slot_max, ps.path_edges[p][ps.path_edges[p] < E2],
                          rates[p])
    ok = np.ones(ps.n_paths, dtype=bool)
    for p in range(ps.n_paths):
        if nflow[p] > 0:
            hops = ps.path_edges[p][ps.path_edges[p] < E2]
            ok[p] = bool(np.any((loads[hops] >= 1.0 - 1e-3)
                                & (rates[p] >= slot_max[hops] - 1e-4)))
    return ok


def test_waterfill_feasible_bottlenecked_order_invariant():
    ps = SMALL[0][1]
    nf = ps.demands[ps.path_owner].astype(np.float32)
    rates, loads = PS.waterfill_rates([ps], n_flows_per_path=nf[None],
                                      wf_iters=64, device=CPU)
    r, ld = rates[0, : ps.n_paths], loads[0, : ps.n_slots]
    assert ld.max() <= 1.0 + 1e-4
    assert (r[nf > 0] > 0).all()
    assert _bottlenecked(ps, r, ld, nf).all()
    perm = np.random.default_rng(0).permutation(ps.n_paths)
    shuffled = dataclasses.replace(
        ps, path_edges=ps.path_edges[perm], path_len=ps.path_len[perm],
        path_owner=ps.path_owner[perm])
    r2, _ = PS.waterfill_rates([shuffled], n_flows_per_path=nf[perm][None],
                               wf_iters=64, device=CPU)
    np.testing.assert_allclose(r[perm], r2[0, : ps.n_paths], rtol=1e-5,
                               atol=1e-6)


def test_waterfill_batch_equals_single():
    a, b = SMALL[0][1], SMALL[1][1]
    ra, _ = PS.waterfill_rates([a], wf_iters=32, device=CPU)
    rb, _ = PS.waterfill_rates([b], wf_iters=32, device=CPU)
    rab, _ = PS.waterfill_rates([a, b], wf_iters=32, device=CPU)
    np.testing.assert_array_equal(rab[0, : a.n_paths], ra[0, : a.n_paths])
    np.testing.assert_array_equal(rab[1, : b.n_paths], rb[0, : b.n_paths])
    with pytest.raises(ValueError):
        PS.waterfill_rates([a], n_flows_per_path=np.ones((2, 3)), device=CPU)
    with pytest.raises(ValueError, match="rule"):
        PS.waterfill_rates([a], rule="slow", device=CPU)


def test_loads_fn_gather_dense_and_fused():
    batch = PathSystemBatch.from_systems([p for _, p in SMALL])
    B, S = batch.n_batch, batch.s_max
    pe = torch.as_tensor(batch.path_edges)
    rng = np.random.default_rng(0)
    rates = torch.from_numpy(rng.random((B, batch.p_max)).astype(np.float32))
    zeros = torch.zeros((B, S))
    fused = make_congestion_fn_batch(pe, S, B, "gather", batch.slot_gather)
    gather = make_loads_fn_batch(pe, S, "gather", batch.slot_gather)
    np.testing.assert_array_equal(gather(rates).numpy(),
                                  fused(rates, zeros)[0].numpy())
    ext = (batch.n_paths, [ps.n_slots for ps in batch.systems])
    dense = make_loads_fn_batch(pe, S, "dense", extents=ext)
    np.testing.assert_allclose(dense(rates).numpy(), gather(rates).numpy(),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        make_loads_fn_batch(pe, S, "gather")
    with pytest.raises(ValueError):
        make_loads_fn_batch(pe, S, "scatter", batch.slot_gather)


def test_congestion_loads_extents_equal_single_calls():
    """A stacked ``congestion_loads`` over extents equals each member's
    single call on its unpadded incidence; a filler member gives zeros."""
    rng = np.random.default_rng(1)
    sizes = [(50, 37), (64, 40), (0, 0), (20, 9)]
    Pm, Sm = 64, 40
    b3 = torch.zeros((len(sizes), Pm, Sm))
    for i, (p, s) in enumerate(sizes):
        b3[i, :p, :s] = torch.from_numpy(
            (rng.random((p, s)) < 0.2).astype(np.float32))
        b3[i, p:, :] = 1.0  # padding the extents must keep out
        b3[i, :, s:] = 1.0
    r3 = torch.from_numpy(rng.random((len(sizes), Pm)).astype(np.float32))
    ext = ([p for p, _ in sizes], [s for _, s in sizes])
    loads = ops.congestion_loads(b3, r3, extents=ext)
    for i, (p, s) in enumerate(sizes):
        assert not loads[i, s:].any()
        if p == 0:
            assert not loads[i].any()
            continue
        one = ops.congestion_loads(b3[i, :p, :s].contiguous(),
                                   r3[i, :p].contiguous())
        np.testing.assert_allclose(loads[i, :s].numpy(), one.numpy(),
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------- #
# simulate against the reference, from the JAX-drawn arrival stream
# --------------------------------------------------------------------------- #


def _jax_stream(seed, wl, rbatch, cfg):
    """The reference scan's own draws (engine.py's step), step by step."""
    K = rbatch.demands.shape[1] - 1
    logits, eos = ref_engine._epoch_logits(wl, rbatch, K, wl.n_steps)
    B, A = rbatch.n_batch, cfg.max_arrivals
    p_el = ref_engine._size_params(wl)[0]
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def one(t, rate_t, lg, p):
        k_n, k_c, k_sz = jax.random.split(jax.random.fold_in(key, t), 3)
        has = jnp.any(jnp.isfinite(lg), axis=1)
        n = jax.random.poisson(k_n, rate_t, (B,)).astype(jnp.int32)
        safe = jnp.where(has[:, None], lg, 0.0)
        c = jax.random.categorical(k_c, safe[:, None, :], axis=-1,
                                   shape=(B, A))
        return n, c, jax.random.bernoulli(k_sz, p, (B, A))

    out = [one(jnp.int32(t), jnp.float32(wl.rate[t]),
               jnp.asarray(logits[eos[t]]), jnp.float32(p_el))
           for t in range(wl.n_steps)]
    return tuple(np.stack([np.asarray(o[i]) for o in out]) for i in range(3))


SIM_FIELDS = ("throughput", "active", "fct_hist", "fct_sum", "fct_count",
              "comm_delivered", "comm_offered", "util_sum", "drops",
              "admitted", "blackholed", "blackholed_total", "inflight",
              "slot_valid", "demands")


def _sim_case(wl_kind):
    """(reference systems, port systems, reference workload, config
    keywords) of one parity case."""
    ref_sys, port_sys = [r for r, _ in TINY], [p for _, p in TINY]
    cfg = dict(max_flows=512, max_arrivals=8, wf_iters=8)
    if wl_kind == "steady":
        rwl = RS.steady_poisson(36, rate=5.0, size=12.0)
    elif wl_kind == "elephant":
        rwl = RS.elephant_mice(36, rate=4.0, p_elephant=0.2, size_mice=6.0,
                               size_elephant=60.0)
    elif wl_kind == "diurnal":
        rwl = RS.diurnal_wave(40, 6.0, amplitude=0.7, period=20, size=10.0)
    elif wl_kind == "exact32":  # few slots: the slot table fills and drops
        rwl = RS.steady_poisson(36, rate=6.0, size=12.0)
        cfg.update(max_flows=32, wf_rule="exact")
    else:  # churn: three demand epochs over each instance's union
        ref_sys, port_sys, rwl = _churn_systems()
    return ref_sys, port_sys, rwl, cfg


@functools.lru_cache(maxsize=1)
def _churn_systems():
    kw = dict(n_epochs=3, steps_per_epoch=12, rate=5.0, seed=2, size=12.0)
    ref_sys, rwl = RS.permutation_churn(
        [R.jellyfish(40, 10, 6, seed=s) for s in (0, 1)], **kw)
    port_sys, _ = PS.permutation_churn(
        [T.jellyfish(40, 10, 6, seed=s) for s in (0, 1)], device=CPU, **kw)
    return ref_sys, port_sys, rwl


@pytest.mark.parametrize("policy,wl_kind", [
    ("ecmp", "steady"), ("ksp_lc", "elephant"), ("mptcp", "steady"),
    ("ecmp", "churn"), ("ksp_lc", "churn"), ("mptcp", "churn"),
    ("ksp_lc", "diurnal"), ("mptcp", "diurnal"),
    ("ecmp", "exact32"), ("ksp_lc", "exact32")])
def test_simulate_matches_reference_from_jax_stream(policy, wl_kind):
    ref_sys, port_sys, rwl, cfg = _sim_case(wl_kind)
    pwl = PS.Workload(**dataclasses.asdict(rwl))
    rcfg, pcfg = RS.SimConfig(**cfg), PS.SimConfig(**cfg)
    want = RS.simulate(ref_sys, rwl, policy=policy, config=rcfg, seed=1)
    stream = _jax_stream(1, rwl, ref_engine._as_batch(ref_sys), rcfg)
    got = PS.simulate(port_sys, pwl, policy=policy, config=pcfg,
                      seed=1, backend="gather", device=CPU, arrivals=stream)
    assert got.backend == "gather" and want.admitted.sum() > 0
    if wl_kind == "exact32":
        assert want.drops.sum() > 0
    for f in SIM_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.n_steps == want.n_steps and got.policy == want.policy
    # the reference's reductions on the port's result give its numbers
    for fn in ("steady_state_throughput", "fct_percentiles",
               "per_commodity_throughput", "per_commodity_goodput"):
        np.testing.assert_array_equal(getattr(PS, fn)(got),
                                      getattr(RS, fn)(want), err_msg=fn)
    assert PS.link_utilization(got) == RS.link_utilization(want)
    for a, b in zip(PS.ranked_normalized_throughput(got),
                    RS.ranked_normalized_throughput(want)):
        np.testing.assert_array_equal(a, b)


def test_ordered_scatter_add_is_sequential():
    rng = np.random.default_rng(2)
    B, N, M = 3, 7, 200
    idx = rng.integers(0, N, (B, M))
    vals = (rng.random((B, M)) * 10.0 ** rng.integers(-5, 4, (B, M))
            ).astype(np.float32)
    vals[rng.random((B, M)) < 0.3] = 0.0
    acc = rng.random((B, N)).astype(np.float32)
    want = acc.copy()
    for b in range(B):
        for m in range(M):
            want[b, idx[b, m]] = np.float32(want[b, idx[b, m]] + vals[b, m])
    got = port_engine._ordered_scatter_add(
        torch.from_numpy(acc), torch.from_numpy(idx), torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------- #
# the port's own generator
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy", ["ecmp", "ksp_lc", "mptcp"])
def test_simulate_conservation_and_determinism(policy):
    systems = [p for _, p in TINY[:2]]
    wl = PS.steady_poisson(30, rate=5.0, size=12.0)
    cfg = PS.SimConfig(max_flows=512, max_arrivals=8, wf_iters=6)
    a = PS.simulate(systems, wl, policy=policy, config=cfg, seed=7,
                    device=CPU)
    b = PS.simulate(systems, wl, policy=policy, config=cfg, seed=7,
                    device=CPU)
    c = PS.simulate(systems, wl, policy=policy, config=cfg, seed=8,
                    device=CPU)
    check_sim_state(a)  # CT-sim: offered = delivered + blackholed + inflight
    for f in SIM_FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert not np.array_equal(a.comm_offered, c.comm_offered)
    assert a.throughput.shape == (30, 2) and (a.admitted > 0).all()
    assert ((a.fct_count + a.active[-1]) == a.admitted).all()
    if policy != "mptcp":
        np.testing.assert_allclose(a.comm_offered.sum(axis=1),
                                   a.admitted * 12.0, rtol=1e-5)
    util = a.util_sum / a.n_steps
    assert (util[a.slot_valid] <= 1.0 + 1e-4).all()
    bad = dataclasses.replace(a, comm_delivered=a.comm_delivered * 2 + 1)
    with pytest.raises(ContractViolation):
        check_sim_state(bad)


def test_draw_arrivals_replays_absolute_steps():
    logits = np.log(np.array([[[1.0, 2.0, 0.5], [1.0, 1.0, 1.0]]],
                             np.float32))
    rates = np.full(10, 3.0, np.float32)
    eos = np.zeros(10, np.int32)
    whole = port_engine.draw_arrivals(4, np.arange(10), rates, logits, eos,
                                      0.3, 5, device=CPU)
    tail = port_engine.draw_arrivals(4, np.arange(6, 10), rates[6:], logits,
                                     eos[6:], 0.3, 5, device=CPU)
    for x, y in zip(whole, tail):
        assert torch.equal(x[6:], y)
    other = port_engine.draw_arrivals(5, np.arange(10), rates, logits, eos,
                                      0.3, 5, device=CPU)
    assert not torch.equal(whole[1], other[1])


def test_simulate_validates_inputs(monkeypatch):
    systems = [p for _, p in TINY[:1]]
    with pytest.raises(ValueError, match="policy"):
        PS.simulate(systems, PS.steady_poisson(4, 1.0), policy="spray",
                    device=CPU)
    cfg = PS.SimConfig(max_flows=16, max_arrivals=8)
    with pytest.raises(ValueError, match="max_flows"):
        PS.simulate(systems, PS.steady_poisson(4, 1.0), policy="mptcp",
                    config=cfg, device=CPU)
    with pytest.raises(ValueError, match="arrivals"):
        PS.simulate(systems, PS.steady_poisson(4, 1.0), device=CPU,
                    arrivals=(np.zeros((4, 1)), np.zeros((4, 1, 3)),
                              np.zeros((4, 1, 3), bool)))
    monkeypatch.setattr(port_engine, "SIM_MAX_STEPS", 8)
    with pytest.raises(ValueError, match="REPRO_SIM_MAX_STEPS"):
        port_engine.simulate(systems, PS.steady_poisson(9, 1.0), device=CPU)
    monkeypatch.setattr(port_engine, "SIM_MAX_STEPS", 200_000)
    monkeypatch.setattr(port_engine, "SIM_MAX_BATCH", 1)
    with pytest.raises(ValueError, match="REPRO_SIM_MAX_BATCH"):
        port_engine.simulate([p for _, p in TINY[:2]],
                             PS.steady_poisson(4, 1.0), device=CPU)


@pytest.mark.parametrize("var", ["REPRO_SIM_MAX_STEPS", "REPRO_SIM_MAX_BATCH"])
def test_sim_env_caps_validated(monkeypatch, var):
    for bad in ("ten", "0", "-3"):
        monkeypatch.setenv(var, bad)
        with pytest.raises(ValueError, match=var):
            env.read(var)
    monkeypatch.setenv(var, "17")
    assert env.read(var) == 17
    # a bad value fails the package's import, naming the variable
    proc = subprocess.run(
        [sys.executable, "-c", "import repro_torch.sim"],
        env={**os.environ, var: "ten", "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, cwd=str(ROOT), timeout=120)
    assert proc.returncode != 0 and var in proc.stderr


# --------------------------------------------------------------------------- #
# workloads
# --------------------------------------------------------------------------- #


def test_workload_generators_match_reference():
    pairs = [
        (PS.steady_poisson(20, 3.0, 9.0), RS.steady_poisson(20, 3.0, 9.0)),
        (PS.diurnal_wave(50, 4.0, amplitude=0.5, period=25),
         RS.diurnal_wave(50, 4.0, amplitude=0.5, period=25)),
        (PS.elephant_mice(10, 1.0, p_elephant=0.1),
         RS.elephant_mice(10, 1.0, p_elephant=0.1)),
    ]
    for got, want in pairs:
        np.testing.assert_array_equal(got.rate, want.rate)
        for f in ("p_elephant", "size_mice", "size_elephant"):
            assert getattr(got, f) == getattr(want, f)
        assert got.n_steps == want.n_steps
    with pytest.raises(ValueError):
        PS.diurnal_wave(10, 1.0, amplitude=1.5)
    with pytest.raises(ValueError):
        PS.elephant_mice(10, 1.0, p_elephant=2.0)
    wl = convert.workload_from_numpy(dataclasses.asdict(pairs[1][1]))
    np.testing.assert_array_equal(wl.rate, pairs[1][1].rate)


def test_permutation_churn_matches_reference():
    ptops = [T.jellyfish(40, 10, 6, seed=s) for s in (0, 1)]
    rtops = [R.jellyfish(40, 10, 6, seed=s) for s in (0, 1)]
    pb, pwl = PS.permutation_churn(ptops, n_epochs=3, steps_per_epoch=8,
                                   rate=4.0, seed=2, device=CPU)
    rb, rwl = RS.permutation_churn(rtops, n_epochs=3, steps_per_epoch=8,
                                   rate=4.0, seed=2)
    np.testing.assert_array_equal(pwl.demand_epochs, rwl.demand_epochs)
    np.testing.assert_array_equal(pwl.epoch_of_step, rwl.epoch_of_step)
    np.testing.assert_array_equal(pb.path_edges, np.asarray(rb.path_edges))
    res = PS.simulate(pb, pwl, policy="ecmp", device=CPU,
                      config=PS.SimConfig(max_flows=256, max_arrivals=8,
                                          wf_iters=6))
    assert res.throughput.shape == (24, 2) and res.admitted.sum() > 0
