"""Live topology events in the simulator (paper §4.3): port against
reference, on the CPU.

Tolerances, and why each holds:

* ``simulate_events`` from per-segment arrival streams drawn in JAX
  exactly as the reference's scan draws them (``jax.random`` keyed by
  ``fold_in(PRNGKey(seed), t)`` at each ABSOLUTE step, from that segment's
  demand log-weights — the routed commodity set, and so the logits, change
  at every boundary): every ``SimResult`` accumulator, every migration
  record and ``event_summary`` equal to the reference's bit for bit, for
  all three policies, under ``gather``.  The migration is the reference's
  numpy code on the same values (the ``fid`` hash on the same uint32s, the
  first argmin in stable row order, killed remainders summed in float64).
* An empty schedule, and one split by ``max_seg``, equal the port's own
  ``simulate`` bit for bit under the port's generator: each segment
  re-seeds at its absolute steps.
* Everything else (schedules, contracts, producers) is exact.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import repro.core as R
import repro.sim as RS
from repro.sim import engine as ref_engine
import repro_torch.core as T
import repro_torch.sim as PS
from repro_torch.analysis.contracts import (
    ContractViolation,
    check_carry_migration,
)
from repro_torch.core import routing as port_routing
from repro_torch.core.flow import PathSystemBatch

CPU = "cpu"
ROOT = pathlib.Path(__file__).resolve().parents[1]

SIM_FIELDS = ("throughput", "active", "fct_hist", "fct_sum", "fct_count",
              "comm_delivered", "comm_offered", "util_sum", "drops",
              "admitted", "blackholed", "blackholed_total", "inflight",
              "demands", "slot_valid")
RECORD_FIELDS = ("step", "kinds", "tags", "survived", "disrupted",
                 "reselected", "killed", "fct_sum_before",
                 "fct_count_before", "blackholed_before", "blackholed_kills")
SYSTEM_FIELDS = ("path_edges", "path_len", "path_owner", "demands", "src",
                 "dst", "unrouted")


def _draws(seed, rates, p_el, A):
    """``(ts, logits, eos) -> stream``: the reference scan's own per-step
    draws (engine.py's step) over absolute steps ``ts``."""
    key = jax.random.PRNGKey(seed)

    @jax.jit
    def one(t, rate_t, lg, p):
        B = lg.shape[0]
        k_n, k_c, k_sz = jax.random.split(jax.random.fold_in(key, t), 3)
        has = jnp.any(jnp.isfinite(lg), axis=1)
        n = jax.random.poisson(k_n, rate_t, (B,)).astype(jnp.int32)
        safe = jnp.where(has[:, None], lg, 0.0)
        c = jax.random.categorical(k_c, safe[:, None, :], axis=-1,
                                   shape=(B, A))
        return n, c, jax.random.bernoulli(k_sz, p, (B, A))

    def draw(ts, logits, eos):
        out = [one(jnp.int32(t), jnp.float32(rates[t]),
                   jnp.asarray(logits[eos[i]]), jnp.float32(p_el))
               for i, t in enumerate(np.asarray(ts).tolist())]
        return tuple(np.stack([np.asarray(o[i]) for o in out])
                     for i in range(3))

    return draw


def _instances(n=2, n_sw=20, ports=8, net=5):
    """The reference's event-test instances, built by both packages."""
    def make(P):
        tops = [P.jellyfish(n_sw, ports, net, seed=s + 1) for s in range(n)]
        comms = [P.permutation_commodities(
            t, P.random_server_permutation(t.n_servers,
                                           np.random.default_rng(s)))
            for s, t in enumerate(tops)]
        return tops, comms
    return make(R), make(T)


def _cfgs(**kw):
    kw = {"max_flows": 256, "max_arrivals": 8, "wf_iters": 6, **kw}
    return RS.SimConfig(**kw), PS.SimConfig(**kw)


def _assert_same_run(got, want):
    for f in SIM_FIELDS:
        np.testing.assert_array_equal(getattr(got.result, f),
                                      getattr(want.result, f), err_msg=f)
    assert got.result.backend == "gather"
    assert got.boundaries == want.boundaries and got.lag == want.lag
    assert len(got.events) == len(want.events)
    for g, w in zip(got.events, want.events):
        for f in RECORD_FIELDS:
            np.testing.assert_array_equal(np.asarray(g[f]), np.asarray(w[f]),
                                          err_msg=f)
    for g, w in zip(PS.event_summary(got), RS.event_summary(want)):
        assert g.keys() == w.keys()
        for f in g:
            np.testing.assert_array_equal(np.asarray(g[f]), np.asarray(w[f]),
                                          err_msg=f)
    assert [T.edge_fingerprint(t) for t in got.tops] == \
        [R.edge_fingerprint(t) for t in want.tops]
    for g, w in zip(got.systems, want.systems):
        for f in SYSTEM_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(w, f)),
                                          err_msg=f)


def _event_pair(ref, port, sched, wl_args, policy, seed=7, k=4, **kw):
    (rtops, rcomms), (ptops, pcomms) = ref, port
    rwl = RS.steady_poisson(*wl_args)
    pwl = PS.steady_poisson(*wl_args)
    rcfg, pcfg = _cfgs()
    want = RS.simulate_events(rtops, rcomms, sched(RS), rwl, k=k,
                              policy=policy, config=rcfg, seed=seed, **kw)
    got = PS.simulate_events(
        ptops, pcomms, sched(PS), pwl, k=k, policy=policy, config=pcfg,
        seed=seed, backend="gather", device=CPU,
        arrivals=_draws(seed, rwl.rate, rwl.p_elephant, rcfg.max_arrivals),
        **kw)
    return got, want


# --------------------------------------------------------------------------- #
# port against reference, every accumulator and record
# --------------------------------------------------------------------------- #


def _mixed_schedule(S):
    return [
        S.Event(step=10, kind="fail_links", n_links=4, seed=5, tag="f"),
        S.Event(step=16, kind="heal_links", heal_of="f"),
        S.Event(step=24, kind="fail_switches", fraction=0.1, seed=2),
        S.Event(step=30, kind="expand", grow=2, seed=6),
        S.Event(step=30, kind="fail_links", fraction=0.05, seed=8),
    ]


@pytest.mark.parametrize("policy", ["ecmp", "ksp_lc", "mptcp"])
def test_simulate_events_matches_reference(policy):
    ref, port = _instances()
    got, want = _event_pair(ref, port, _mixed_schedule, (40, 3.0), policy)
    _assert_same_run(got, want)
    assert want.result.blackholed_total.sum() > 0
    for what in ("reselected", "killed"):
        assert sum(int(r[what].sum()) for r in want.events) > 0
    assert [r["step"] for r in got.events] == [10, 16, 24, 30]


def test_simulate_events_matches_reference_past_delta_gate(monkeypatch):
    # 400 switches: the deltas repair the cached APSP in place and certify
    # it (the other side of update_path_system's 384 gate), and surviving
    # rows keep their flows
    calls = []
    repair = port_routing._repair_dist
    monkeypatch.setattr(port_routing, "_repair_dist",
                        lambda *a, **kw: calls.append(1) or repair(*a, **kw))
    ref, port = _instances(n=1, n_sw=400, ports=8, net=6)

    def sched(S):
        return [S.Event(step=3, kind="fail_links", n_links=8, seed=1,
                        tag="f"),
                S.Event(step=6, kind="heal_links", heal_of="f"),
                S.Event(step=8, kind="expand", grow=2, seed=4)]

    got, want = _event_pair(ref, port, sched, (10, 12.0), "ksp_lc", k=2,
                            max_slack=1)
    _assert_same_run(got, want)
    assert got.tops[0].n_switches == 402 and len(calls) >= 2
    assert all(r["survived"].sum() > 0 for r in got.events)


def test_max_seg_split_matches_reference():
    ref, port = _instances()

    def sched(S):
        return [S.Event(step=13, kind="fail_links", n_links=3, seed=9,
                        tag="f"),
                S.Event(step=21, kind="heal_links", heal_of="f")]

    got, want = _event_pair(ref, port, sched, (32, 3.0), "ecmp", max_seg=6,
                            lag=3)
    _assert_same_run(got, want)
    assert got.boundaries == [0, 6, 12, 13, 19, 21, 27]


# --------------------------------------------------------------------------- #
# CT-segment parity with the port's own simulate and generator
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("policy,max_seg", [("ecmp", 0), ("ksp_lc", 10),
                                            ("mptcp", 7)])
def test_empty_schedule_equals_simulate(policy, max_seg):
    _, (tops, comms) = _instances()
    systems = [T.build_path_system(t, c, k=4, device=CPU)
               for t, c in zip(tops, comms)]
    wl = PS.steady_poisson(32, 3.0)
    _, cfg = _cfgs()
    base = PS.simulate(PathSystemBatch.from_systems(systems), wl,
                       policy=policy, config=cfg, seed=7, device=CPU)
    ev = PS.simulate_events(tops, comms, [], wl, systems=systems,
                            policy=policy, config=cfg, seed=7, device=CPU,
                            max_seg=max_seg)
    for f in SIM_FIELDS:
        a, b = getattr(base, f), getattr(ev.result, f)
        assert a.shape == b.shape and np.array_equal(a, b), f
    assert ev.result.backend == base.backend
    assert ev.events == []
    step = max_seg or 32
    assert ev.boundaries == list(range(0, 32, step))


# --------------------------------------------------------------------------- #
# mirrors of the reference's own event tests
# --------------------------------------------------------------------------- #


def _assert_conserved(res):
    off = res.comm_offered.sum(axis=1, dtype=np.float64)
    dele = res.comm_delivered.sum(axis=1, dtype=np.float64)
    err = np.abs(off - (dele + res.blackholed_total + res.inflight))
    assert np.all(err <= 1e-3 * np.maximum(off, 1.0)), err


@pytest.mark.parametrize("policy", ["ecmp", "ksp_lc", "mptcp"])
def test_fail_heal_expand_conservation(policy):
    _, (tops, comms) = _instances()
    wl = PS.steady_poisson(40, 3.0)
    sched = [
        PS.Event(step=12, kind="fail_links", n_links=4, seed=5, tag="f"),
        PS.Event(step=22, kind="heal_links", heal_of="f"),
        PS.Event(step=30, kind="expand", grow=1, seed=6),
    ]
    _, cfg = _cfgs()
    ev = PS.simulate_events(tops, comms, sched, wl, k=4, policy=policy,
                            config=cfg, seed=7, device=CPU)
    _assert_conserved(ev.result)
    assert [r["step"] for r in ev.events] == [12, 22, 30]
    B = len(tops)
    for rec in ev.events:
        assert rec["disrupted"].shape == (B,)
        assert np.all(rec["survived"] >= 0)
        assert np.all(rec["disrupted"] == rec["reselected"] + rec["killed"])
    assert np.all(ev.result.blackholed_total >= 0)
    assert ev.result.blackholed_total.sum() > 0
    assert all(t.n_switches == 21 for t in ev.tops)
    summ = PS.event_summary(ev)
    assert len(summ) == 3
    assert summ[0]["kinds"] == ["fail_links"]
    assert np.all(np.isfinite(summ[0]["throughput_retention"]))
    assert np.all(summ[0]["blackholed_bytes"] >= 0)


def test_lag_zero_blackholes_nothing_on_survivable_failure():
    _, (tops, comms) = _instances()
    wl = PS.steady_poisson(30, 3.0)
    sched = [PS.Event(step=10, kind="fail_links", n_links=2, seed=3)]
    _, cfg = _cfgs()
    ev = PS.simulate_events(tops, comms, sched, wl, k=4, policy="ecmp",
                            config=cfg, seed=7, lag=0, device=CPU)
    _assert_conserved(ev.result)
    if all(int(r["killed"].sum()) == 0 for r in ev.events):
        assert np.all(ev.result.blackholed_total == 0.0)
    ev_lag = PS.simulate_events(tops, comms, sched, wl, k=4, policy="ecmp",
                                config=cfg, seed=7, lag=4, device=CPU)
    _assert_conserved(ev_lag.result)
    assert ev_lag.result.blackholed_total.sum() >= \
        ev.result.blackholed_total.sum()


def test_heal_inverts_fail_delta():
    top = T.jellyfish(20, 8, 5, seed=3)
    failed = T.fail_links(top, seed=11, n_links=4)
    healed = T.heal_links(failed, failed.meta["edges_removed"])
    assert T.edge_fingerprint(healed) == T.edge_fingerprint(top)
    assert healed.meta["delta_kind"] == "heal_links"
    assert healed.meta["edges_removed"] == []
    assert sorted(healed.meta["edges_added"]) == sorted(
        failed.meta["edges_removed"])
    comm = T.permutation_commodities(top, T.random_server_permutation(
        top.n_servers, np.random.default_rng(0)))
    ps0 = T.build_path_system(top, comm, k=4, device=CPU)
    ps1 = T.update_path_system(ps0, top, failed, comm, device=CPU)
    ps2 = T.update_path_system(ps1, failed, healed, comm, device=CPU)
    ref = T.build_path_system(healed, comm, k=4, cache=False, device=CPU)
    assert ps2.n_paths == ref.n_paths
    assert np.array_equal(np.sort(np.asarray(ps2.path_len)),
                          np.sort(np.asarray(ref.path_len)))


def _migration_fixture():
    # one instance, 3 old rows -> 3 new rows; rows 0,2 survive, row 1 dies
    row_o = np.array([[0, 1, 2, 4]], np.int64)  # slot 3 empty (p_old=4)
    rem_o = np.array([[3.0, 2.0, 1.0, 0.0]], np.float32)
    age_o = np.array([[5.0, 4.0, 3.0, 0.0]], np.float32)
    fid_o = np.array([[7, 8, 9, 0]], np.int64)
    hold_o = np.zeros((1, 4), np.int64)
    fwd = [np.array([1, -1, 0], np.int64)]
    row_n = np.array([[1, 2, 0, 3]], np.int64)  # slot 1 re-selected
    hold_n = np.array([[0, 2, 0, 0]], np.int64)
    return [row_o, row_n, rem_o, rem_o.copy(), age_o, age_o.copy(), fid_o,
            fid_o.copy(), hold_o, hold_n, fwd]


def _forge(arg, fix):
    args = _migration_fixture()
    args[arg] = fix(args[arg])
    return args


@pytest.mark.parametrize("args,match", [
    (_forge(10, lambda _: [np.array([1, 1, 0], np.int64)]), "injective"),
    (_forge(3, lambda a: a + np.array([[0.5, 0, 0, 0]], np.float32)),
     "bit-exactly"),
    (_forge(9, lambda a: a + np.array([[0, 7, 0, 0]])), "hold"),
    (_forge(1, lambda a: np.array([[1, 2, 0, 0]])), "empty slot"),
])
def test_carry_migration_contract_rejects_forgeries(args, match):
    check_carry_migration(*_migration_fixture(), 4, 3, 2)  # the valid one
    with pytest.raises(ContractViolation, match=match):
        check_carry_migration(*args, 4, 3, 2)


def test_validate_schedule_errors():
    E = PS.Event
    bad = [
        ([E(step=1, kind="meteor")], "unknown event kind"),
        ([E(step=10, kind="fail_links", n_links=1)], "outside"),
        ([E(step=1, kind="fail_links")], "n_links or fraction"),
        ([E(step=1, kind="fail_switches")], "needs fraction"),
        ([E(step=1, kind="expand")], "grow"),
        ([E(step=1, kind="heal_links")], "heal_of"),
        ([E(step=1, kind="heal_links", heal_of="nope")], "does not name"),
        ([E(step=5, kind="fail_links", n_links=1, tag="f"),
          E(step=2, kind="heal_links", heal_of="f")], "does not name"),
        ([E(step=1, kind="fail_links", n_links=1, tag="f"),
          E(step=2, kind="fail_links", n_links=1, tag="f")], "duplicate tag"),
    ]
    for sched, match in bad:
        with pytest.raises(ValueError, match=match):
            PS.validate_schedule(sched, 10)
    with pytest.raises(TypeError, match="expected an Event"):
        PS.validate_schedule([("fail_links", 1)], 10)
    PS.validate_schedule([
        E(step=1, kind="fail_links", n_links=1, tag="f"),
        E(step=3, kind="heal_links", heal_of="f"),
        E(step=4, kind="expand", grow=2),
    ], 10)


def test_simulate_events_rejects_bad_inputs():
    _, (tops, comms) = _instances(1)
    wl = PS.steady_poisson(8, 1.0)
    wl.demand_epochs = np.ones((1, 4), np.float32)
    wl.epoch_of_step = np.zeros(8, np.int32)
    with pytest.raises(ValueError, match="demand-epoch"):
        PS.simulate_events(tops, comms, [], wl, k=4, device=CPU)
    wl = PS.steady_poisson(8, 1.0)
    for kw, match in (({"policy": "spray"}, "policy"), ({"lag": -1}, "lag"),
                      ({"max_seg": -2}, "max_seg")):
        with pytest.raises(ValueError, match=match):
            PS.simulate_events(tops, comms, [], wl, k=4, device=CPU, **kw)
    with pytest.raises(ValueError, match="commodity sets"):
        PS.simulate_events(tops, comms * 2, [], wl, k=4, device=CPU)


def test_poisson_failure_schedule_matches_reference():
    kw = dict(mtbf_steps=12.0, mttr_steps=6.0, seed=4)
    a = PS.poisson_failure_schedule(200, **kw)
    assert a == PS.poisson_failure_schedule(200, **kw)
    assert a != PS.poisson_failure_schedule(200, **{**kw, "seed": 5})
    for args in ((200, 12.0, 6.0, 1, 1, 4), (160, 40.0, 20.0, 1, 26, 17),
                 (90, 7.0, None, 2, 3, 0)):
        got = [dataclasses.asdict(e)
               for e in PS.poisson_failure_schedule(*args)]
        want = [dataclasses.asdict(e)
                for e in RS.poisson_failure_schedule(*args)]
        assert got == want
    PS.validate_schedule(a, 200)
    fails = [e for e in a if e.kind == "fail_links"]
    assert fails and fails[0].step == 1
    assert [e.step for e in a] == sorted(e.step for e in a)
    heals = {e.heal_of: e.step for e in a if e.kind == "heal_links"}
    fail_steps = {e.tag: e.step for e in fails}
    assert set(heals) <= set(fail_steps)
    assert all(hs > fail_steps[tag] for tag, hs in heals.items())
    with pytest.raises(ValueError, match="mtbf"):
        PS.poisson_failure_schedule(100, mtbf_steps=0.0)
    with pytest.raises(ValueError, match="mttr"):
        PS.poisson_failure_schedule(100, mtbf_steps=5.0, mttr_steps=-1.0)
    assert PS.poisson_failure_schedule(0, mtbf_steps=5.0) == []


@pytest.mark.parametrize("var", ["REPRO_SIM_EVENT_LAG",
                                 "REPRO_SIM_EVENT_MAX_SEG"])
def test_event_env_validated_at_import(var):
    for bad in ("soon", "-3", "1.5"):
        proc = subprocess.run(
            [sys.executable, "-c", "import repro_torch.sim"],
            env={**os.environ, var: bad, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, cwd=str(ROOT), timeout=120)
        assert proc.returncode != 0, (var, bad)
        assert var in proc.stderr, (var, bad)


# --------------------------------------------------------------------------- #
# tenant churn
# --------------------------------------------------------------------------- #


def test_tenant_churn_matches_reference():
    rtops = [R.jellyfish(20, 8, 5, seed=s) for s in (0, 1)]
    ptops = [T.jellyfish(20, 8, 5, seed=s) for s in (0, 1)]
    rseg = RS.tenant_churn_segments(rtops, n_events=3, grow=2, k=4, seed=3)
    pseg = PS.tenant_churn_segments(ptops, n_events=3, grow=2, k=4, seed=3,
                                    device=CPU)
    assert len(pseg) == len(rseg) == 4
    for g, w in zip(pseg, rseg):
        for gd, wd in zip(g["demands"], w["demands"]):
            np.testing.assert_array_equal(gd, wd)
        for gs, ws in zip(g["systems"], w["systems"]):
            assert gs.n_edges == ws.n_edges
            for f in SYSTEM_FIELDS:
                np.testing.assert_array_equal(np.asarray(getattr(gs, f)),
                                              np.asarray(getattr(ws, f)),
                                              err_msg=f)
    rcfg, pcfg = _cfgs()
    want = RS.run_tenant_churn(rseg, 16, 3.0, config=rcfg, seed=5)
    streams = []
    for si, seg in enumerate(rseg):  # each segment's own seed and weights
        batch = ref_engine._as_batch(seg["systems"])
        K = batch.demands.shape[1] - 1
        de = np.zeros((1, batch.n_batch, K), np.float32)
        for i, (ps, w) in enumerate(zip(seg["systems"], seg["demands"])):
            dem = np.asarray(ps.demands) * np.asarray(w)
            de[0, i, : len(dem)] = dem
        logits = np.where(de > 0, np.log(np.maximum(de, 1e-30)),
                          -np.inf).astype(np.float32)
        rates = np.full(16, 3.0, np.float32)
        streams.append(_draws(5 + si, rates, 0.0, rcfg.max_arrivals)(
            np.arange(16), logits, np.zeros(16, np.int32)))
    got = PS.run_tenant_churn(pseg, 16, 3.0, config=pcfg, seed=5,
                              device=CPU, arrivals=streams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert w.admitted.sum() > 0
        for f in SIM_FIELDS:
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f),
                                          err_msg=f)
    with pytest.raises(ValueError, match="arrival streams"):
        PS.run_tenant_churn(pseg, 16, 3.0, device=CPU, arrivals=streams[:1])
