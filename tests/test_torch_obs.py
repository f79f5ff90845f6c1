"""The port's tracer and the counters its solvers keep, on the CPU.

* A live span, or a call of an ``obs.spanned`` function, is also the
  profiler label ``repro/<name>``, nested in its parent's label, and an
  obs span that ``obs.annotate`` adds attributes to; with tracing off
  ``span()`` is the shared no-op and records nothing; a loop of spans
  reads the RSS watermark once an interval, not once a span.
* The simulator counts its steps, loads products and blocking host reads
  once per ``_run_steps`` call: 2 x ``wf_iters`` + 3 loads calls and 2
  host reads a step under either backend; ``simulate_events`` counts each
  step once, spans each event's application (``sim/apply_event``, with its
  kind) and each migration (``sim/migrate``) inside the boundary's
  ``sim/reroute``, and counts its events by kind.
* The batched MW adds its members' iterations to ``mw/iters`` and its
  solves to ``mw/solves``; ``flow/backend/<name>`` counts each ``auto``
  resolution.
* Traced runs (spans on, under ``torch.profiler``) equal untraced ones bit
  for bit (INVARIANTS.md OB-1).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch.core as T
import repro_torch.sim as PS
from repro_torch import obs
from repro_torch.core.flow import PathSystemBatch
from repro_torch.obs import trace as obs_trace

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@contextlib.contextmanager
def _tracing(flag: bool):
    prev = obs.set_trace(flag)
    obs.reset_trace()
    obs.reset_metrics()
    try:
        yield
    finally:
        obs.set_trace(prev)
        obs.reset_trace()


def _systems(n_inst=2, n=30, ports=8, net=5):
    tops = [T.jellyfish(n, ports, net, seed=s) for s in range(n_inst)]
    comms = [T.random_permutation_traffic(t, seed=s) for s, t in enumerate(tops)]
    return tops, comms, [T.build_path_system(t, c, k=4, device=CPU)
                         for t, c in zip(tops, comms)]


@pytest.mark.parametrize("enabled", [True, False])
def test_span_is_a_profiler_label_nested_in_its_parent(enabled):
    @obs.spanned("outer/c")
    def whole(x):
        obs.annotate(size=x.numel())
        return x.sum()

    with _tracing(enabled), profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer/a", n=1):
            obs.annotate(m=2)
            with obs.span("outer/b"):
                torch.ones(4).sum()
            assert float(whole(torch.ones(3))) == 3.0
        spans = obs.get_spans()
    labels = {ev.name(): (ev.start_ns(), ev.start_ns() + ev.duration_ns())
              for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("repro/")}
    if not enabled:
        assert obs.span("x") is obs_trace._NOOP
        assert spans == [] and labels == {}
        return
    assert set(labels) == {"repro/outer/a", "repro/outer/b", "repro/outer/c"}
    (a0, a1), (b0, b1) = labels["repro/outer/a"], labels["repro/outer/b"]
    c0, c1 = labels["repro/outer/c"]
    assert a0 <= b0 <= b1 <= c0 <= c1 <= a1
    by = {sp.name: sp for sp in spans}
    assert by["outer/b"].parent_id == by["outer/a"].span_id
    assert by["outer/c"].parent_id == by["outer/a"].span_id
    assert by["outer/a"].attrs == {"n": 1, "m": 2}
    assert by["outer/c"].attrs == {"size": 3}
    # the label is a host-side operator, not a user annotation: the
    # profiler mirrors user annotations on the device timeline
    kinds = {ev.name(): ev.is_user_annotation()
             for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("repro/")}
    assert kinds == {"repro/outer/a": False, "repro/outer/b": False,
                     "repro/outer/c": False}


def test_spans_read_the_rss_watermark_at_most_every_interval(monkeypatch):
    """``getrusage`` costs more than the rest of a span on a card's host:
    a tight loop of spans reads it once an ``RSS_EVERY_S``, not once a
    span, and every span still carries the watermark."""
    import resource

    calls = []
    plain = resource.getrusage
    monkeypatch.setattr(resource, "getrusage",
                        lambda who: calls.append(who) or plain(who))
    monkeypatch.setattr(obs_trace, "_rss_read", [float("-inf"), 0.0])
    with _tracing(True):
        t0 = time.perf_counter()
        for _ in range(200):
            with obs.span("loop/a"):
                pass
        elapsed = time.perf_counter() - t0
        spans = obs.get_spans()
    assert len(spans) == 200 and all(sp.rss_mb > 0 for sp in spans)
    assert 1 <= len(calls) <= 1 + elapsed / obs_trace.RSS_EVERY_S


def _sim_counts(run):
    with _tracing(False):
        run()
        snap = obs.snapshot()
    return snap


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_sim_counts_loads_calls_and_host_reads_a_step(backend):
    _, _, systems = _systems()
    cfg = PS.SimConfig(max_flows=128, max_arrivals=6, wf_iters=4)
    wl = PS.steady_poisson(12, rate=3.0, size=10.0)
    snap = _sim_counts(lambda: PS.simulate(
        PathSystemBatch.from_systems(systems), wl, policy="ksp_lc",
        config=cfg, seed=3, backend=backend, device=CPU))
    assert snap["sim/steps"] == 12
    assert snap["sim/loads_calls"] / snap["sim/steps"] == 2 * cfg.wf_iters + 3
    assert snap["sim/host_syncs"] / snap["sim/steps"] == 2


def test_simulate_events_counts_each_step_once():
    tops, comms, _ = _systems()
    cfg = PS.SimConfig(max_flows=128, max_arrivals=6, wf_iters=4)
    wl = PS.steady_poisson(20, rate=3.0, size=10.0)
    sched = [PS.Event(step=7, kind="fail_links", n_links=2, seed=1, tag="f"),
             PS.Event(step=13, kind="heal_links", heal_of="f")]
    snap = _sim_counts(lambda: PS.simulate_events(
        tops, comms, sched, wl, k=4, policy="ecmp", config=cfg, seed=5,
        device=CPU, max_seg=6))
    assert snap["sim/steps"] == 20
    assert snap["sim/segments"] > 3
    assert snap["sim/loads_calls"] == 20 * (2 * cfg.wf_iters + 3)


def _event_schedule():
    """Every event kind the benchmark's event cell runs, two of them at
    one step (one boundary, two applications)."""
    return [PS.Event(step=5, kind="fail_links", n_links=2, seed=1, tag="f"),
            PS.Event(step=10, kind="heal_links", heal_of="f"),
            PS.Event(step=15, kind="expand", grow=2, seed=3),
            PS.Event(step=15, kind="fail_links", n_links=1, seed=4)]


def _events_run():
    tops, comms, _ = _systems()
    res = PS.simulate_events(
        tops, comms, _event_schedule(),
        PS.steady_poisson(20, rate=3.0, size=10.0), k=4, policy="ksp_lc",
        config=PS.SimConfig(max_flows=128, max_arrivals=6, wf_iters=4),
        seed=5, device=CPU)
    r = res.result
    return [r.throughput, r.active, r.blackholed, r.comm_delivered,
            r.comm_offered, r.fct_sum, r.blackholed_total, r.inflight]


def test_simulate_events_spans_each_event_and_migration():
    """Inside each boundary's ``sim/reroute``: one ``sim/apply_event`` an
    event, with its kind, and one ``sim/migrate``; ``sim/events/<kind>``
    counts the schedule's events."""
    with _tracing(True):
        _events_run()
        spans = obs.get_spans()
        snap = obs.snapshot()
    by_id = {sp.span_id: sp for sp in spans}
    applied = [sp for sp in spans if sp.name == "sim/apply_event"]
    moved = [sp for sp in spans if sp.name == "sim/migrate"]
    reroutes = [sp for sp in spans if sp.name == "sim/reroute"]
    assert [sp.attrs["kind"] for sp in applied] == [
        e.kind for e in _event_schedule()]
    assert len(moved) == len(reroutes) == 3
    for sp in applied + moved:
        assert by_id[sp.parent_id].name == "sim/reroute"
    assert [by_id[sp.parent_id].attrs["step"] for sp in moved] == [5, 10, 15]
    assert {k: v for k, v in snap.items() if k.startswith("sim/events/")} == {
        "sim/events/fail_links": 2, "sim/events/heal_links": 1,
        "sim/events/expand": 1}
    assert snap["sim/migrations"] == 3


@pytest.mark.parametrize("target", [None, 0.5])
def test_batched_mw_counts_its_members_iterations(target):
    _, _, systems = _systems(n_inst=3)
    with _tracing(False):
        res = T.mw_concurrent_flow_batch(systems, iters=120, check_every=20,
                                         target_alpha=target, device=CPU)
        snap = obs.snapshot()
    assert snap["mw/iters"] == sum(r.iters for r in res)
    assert snap["mw/solves"] == len(systems)
    chosen = res[0].method.rsplit("-", 1)[1]
    assert snap[f"flow/backend/{chosen}"] == 1
    assert [k for k in snap if k.startswith("flow/backend/")] == [
        f"flow/backend/{chosen}"]


def _expand_chain():
    top = T.jellyfish(40, 8, 5, seed=2)
    perm = T.random_server_permutation(top.n_servers, seed=1)
    ps = T.build_path_system(top, T.permutation_commodities(top, perm), k=4,
                             device=CPU)
    cold = T.mw_concurrent_flow(ps, iters=60, device=CPU)
    rng = np.random.default_rng(4)
    new = T.expand_to(top, 42, seed=rng)
    perm = T.extend_server_permutation(perm, new.n_servers, seed=rng)
    ps2 = T.update_path_system(ps, top, new,
                               T.permutation_commodities(new, perm),
                               device=CPU)
    warm = T.mw_concurrent_flow(ps2, iters=40, warm=cold, device=CPU)
    return [ps2.path_edges, ps2.path_len, warm.rates, np.float64(warm.alpha)]


def _sim_run():
    _, _, systems = _systems()
    res = PS.simulate(PathSystemBatch.from_systems(systems),
                      PS.steady_poisson(10, rate=3.0, size=10.0),
                      policy="ksp_lc", config=PS.SimConfig(
                          max_flows=128, max_arrivals=6, wf_iters=4),
                      seed=9, device=CPU)
    return [res.throughput, res.comm_delivered, res.fct_sum, res.active]


def _batch_run():
    _, _, systems = _systems(n_inst=3)
    res = T.mw_concurrent_flow_batch(systems, iters=80, check_every=20,
                                     target_alpha=0.6, device=CPU)
    return [r.rates for r in res] + [np.array([r.alpha for r in res])]


@pytest.mark.parametrize("run", [_expand_chain, _sim_run, _batch_run,
                                 _events_run])
def test_traced_run_equals_untraced(run):
    with _tracing(False):
        plain = run()
    with _tracing(True), profile(activities=[ProfilerActivity.CPU]):
        traced = run()
        assert obs.get_spans()
    for a, b in zip(plain, traced):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b))
