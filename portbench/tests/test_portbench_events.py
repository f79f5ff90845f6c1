"""The event cell's driver against ``reference/events.py``, at tiny size on
the CPU: a sound run comes out correct, the control and each planted fault
not, each by the check that reads the rule it breaks; the frozen failure
producers equal the program's."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from portbench import faults_events, harness
from portbench.tests import tiny


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the host: one intra-op thread each."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def events_cell(fraction: float = 0.05, grow: int = 2) -> harness.Cell:
    """The cell's configuration and traffic with their scale cut: 2
    instances of RRG(64, 24, 18) (the tiny sim cell's), 48 steps, the
    events at steps 12, 24 and 36."""
    config = tiny._load(tiny.CONFIGS, "rrg512x8-events")
    config.update(switches=64, instances=2, max_flows=256, max_arrivals=8)
    tr = tiny._load(tiny.TRAFFIC, "sim_events")
    tr.update(steps=48, rate=4.0, size=12.0)
    fail, heal, grow_ev = tr["events"]
    tr["events"] = [dict(fail, step=12, fraction=fraction),
                    dict(heal, step=24), dict(grow_ev, step=36, grow=grow)]
    return harness.Cell("tiny.sim_events", 1, config, tr, tr["kind"], [], [])


def _over(line) -> set:
    return {n for n, c in line["checks"].items() if not c["value"] <= c["limit"]}


def test_sound_run_is_correct():
    line = tiny.run(events_cell())
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert line["correct"], line["checks"]
    moved = line["notes"]["migrations"]
    assert len(moved) == 3 and all(s > 0 and r > 0 for s, r, _ in moved)
    # every step of the call, each instance, held to one reference step
    assert line["notes"]["steps_compared"] == 48 * 2
    assert line["checks"]["rerun_mismatch"]["value"] == 0


def test_a_rebuild_that_kills_flows_is_correct():
    """Nine links in ten fail: each delta is a rebuild (no row survives)
    and switches are cut off, so flows are killed and their remainders
    blackholed; the reference's rules hold all the same."""
    line = tiny.run(events_cell(fraction=0.9))
    moved = line["notes"]["migrations"]
    assert moved[0][0] == 0 and moved[0][2] > 0, moved
    assert not _over(line) - {"throughput_gap", "fct_gap"}, line["checks"]


def test_control_is_not_correct():
    line = tiny.run(events_cell(), control=True)
    assert not line["correct"]
    assert "reselect_mismatch" in _over(line), line["checks"]


@pytest.mark.parametrize("name, check, fraction", [
    ("events.age_reset", "survivor_mismatch", 0.05),
    ("events.lag_ignored", "reselect_mismatch", 0.05),
    ("events.kill_unaccounted", "blackholed_mismatch", 0.9),
    ("events.hold_unheeded", "step_gap", 0.05),
])
def test_planted_fault_is_not_correct(name, check, fraction):
    """With the program's own contracts off, as in the benchmark's runs
    (the conservation contract would stop ``kill_unaccounted`` first)."""
    from repro_torch.analysis.contracts import set_check_enabled

    prev = set_check_enabled(False)
    try:
        line = tiny.run(events_cell(fraction=fraction),
                        hook=faults_events.FAULTS[name])
    finally:
        set_check_enabled(prev)
    assert not line["correct"]
    assert check in _over(line), line["checks"]


@pytest.mark.parametrize("kind", ["fail_links", "heal_links"])
def test_frozen_failure_producers_equal_the_programs(kind):
    from portbench.reference.frozen import failures as ffail
    from portbench.reference.frozen import jellyfish as fjelly
    from repro_torch.core import failures, jellyfish

    top, ftop = jellyfish(64, 24, 18, seed=3), fjelly.jellyfish(64, 24, 18,
                                                                seed=3)
    for fraction, n_links in ((0.05, None), (0.0, None), (None, 7)):
        kw = ({"n_links": n_links} if n_links is not None
              else {"fraction": fraction})
        got = failures.fail_links(top, seed=np.random.default_rng([5, 1]),
                                  **kw)
        want = ffail.fail_links(ftop, seed=np.random.default_rng([5, 1]),
                                **kw)
        if kind == "heal_links":
            got = failures.heal_links(got, got.meta["edges_removed"])
            want = ffail.heal_links(want, want.meta["edges_removed"])
            assert np.array_equal(want.edges, ftop.edges)
        assert np.array_equal(got.edges, want.edges)
        for key in ("edges_added", "edges_removed", "delta_kind"):
            assert got.meta[key] == want.meta[key]


def test_cell_files_state_the_schedule():
    bench = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
    c = harness.load_cell(bench, "rrg512x8.sim_events")
    assert c.kind == "sim_events" and c.chips == 1
    assert [e["step"] for e in c.traffic["events"]] == [40, 80, 120]
    assert c.config["lag"] == 2 and c.config["reduced"] == []
    assert {m["name"] for m in c.end_to_end} == {"sim_step_rate", "setup_s"}
    assert {m["name"] for m in c.per_layer} == {
        "sim.reroute_s_per_event", "routing.event_delta_s_per_event",
        "sim.migrate_s_per_event", "sim.reselected_share",
        "device.idle_share.events"}
