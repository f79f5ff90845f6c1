"""The arithmetic of ``sets.py``: the quartile spread, the run left out
where that narrows it, the bound by rule with its limits, the units'
spreads, and the summary that ``main`` prints over sets of runs."""

from __future__ import annotations

import json
import subprocess

import pytest

from portbench import sets


def test_quartile_spread_is_the_quartiles_over_the_median():
    # statistics.quantiles: q1 92.5, median 100, q3 107.5
    assert sets.quartile_spread([90, 95, 100, 105, 110]) == pytest.approx(0.15)
    assert sets.quartile_spread([110, 90, 105, 95, 100]) == pytest.approx(0.15)
    assert sets.quartile_spread([42.0]) is None
    assert sets.quartile_spread([0.0, 0.0, 0.0]) is None


def test_spread_leaves_out_the_farthest_run_where_that_narrows_it():
    values = [90, 95, 100, 105, 110, 200]
    assert sets.quartile_spread(values) == pytest.approx(0.37805, rel=1e-4)
    assert sets.spread(values) == pytest.approx(0.15)


def test_spread_keeps_every_run_where_leaving_one_out_widens_it():
    values = [94, 108, 108, 94, 107, 94]
    whole = sets.quartile_spread(values)
    # the farthest from the median 100.5 is the first 108
    rest = sets.quartile_spread([94, 108, 94, 107, 94])
    assert rest > whole
    assert sets.spread(values) == pytest.approx(whole)


def test_spread_of_two_runs_leaves_none_out():
    assert sets.spread([90.0, 110.0]) == sets.quartile_spread([90.0, 110.0])
    assert sets.spread([1.0]) is None


@pytest.mark.parametrize("spreads, bound", [
    ([0.02, 0.03], 0.15),
    ([0.03, None, 0.0317], 0.1585),
    ([0.0811, 0.1219, 0.0317], 0.25),  # five times 12.19 % is over the cap
    ([0.0001], 0.01),                  # never under 1 %
    ([0.0], 0.01),
])
def test_bound_by_rule_is_five_times_the_widest_within_its_limits(spreads,
                                                                    bound):
    assert sets.bound_by_rule(spreads) == pytest.approx(bound)


def test_bound_by_rule_without_a_reading_is_none():
    assert sets.bound_by_rule([]) is None
    assert sets.bound_by_rule([None, None]) is None


def test_parse_prior_groups_spreads_by_metric():
    assert sets.parse_prior(["sim_step_rate=0.1219", "setup_s=0.13",
                             "sim_step_rate=0.0317"]) == {
        "sim_step_rate": [0.1219, 0.0317], "setup_s": [0.13]}
    assert sets.parse_prior([]) == {}


def test_units_spread_within_and_between_runs():
    lines = [{"notes": {"unit_s": [1.0, 1.2, 1.4, 1.6, 3.0]}},
             {"notes": {"unit_s": [2.0, 2.0, 2.0]}},
             {"notes": {"unit_s": [1.0]}},  # one unit reads no spread
             {"metrics": {}}]
    got = sets.units_spread(lines)
    # the 3.0 s unit left out: quartiles 1.05 and 1.55 about 1.3
    assert got["within"] == [pytest.approx(0.5 / 1.3), 0.0]
    assert got["medians"] == [pytest.approx(1.4), 2.0]
    assert got["between"] == sets.spread([1.4, 2.0])
    assert sets.units_spread([{"notes": {}}]) is None


def _line(rate: float, setup: float, units: list) -> dict:
    return {"correct": True, "attempted": len(units), "failed": 0,
            "metrics": {"sim_step_rate": {"value": rate, "unit": "steps/s"},
                        "setup_s": {"value": setup, "unit": "s"}},
            "device": {}, "notes": {"unit_s": units},
            "checks": {"fct_gap": {"value": 1e-3, "limit": 8e-3}}}


def test_main_prints_each_sets_spread_and_the_bound_by_rule(monkeypatch,
                                                            capsys, tmp_path):
    """Two sets of three seeds through ``main`` with the runs stood in for:
    the printed bound is five times the widest spread of the sets and of
    the readings given with ``--prior``, each metric its own."""
    rates = iter([100.0, 96.0, 104.0, 100.0, 90.0, 110.0])
    calls = []

    def fake_run(cmd, **kw):
        calls.append(cmd)
        line = _line(next(rates), 15.0 + len(calls) % 2, [1.0, 1.1, 1.2])
        return subprocess.CompletedProcess(cmd, 0, json.dumps(line) + "\n", "")

    monkeypatch.setattr(sets.subprocess, "run", fake_run)
    out = tmp_path / "sets.jsonl"
    assert sets.main(["--workload", "rrg512x8.sim_ksp", "--seconds", "1",
                      "--seeds", "7", "8", "9", "--repeat", "2",
                      "--out", str(out), "--prior", "sim_step_rate=0.03"]) == 0
    assert len(calls) == 6 and all("--seed" in c for c in calls)
    assert len(out.read_text().splitlines()) == 6
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    per_set = {(p["set"], p["metric"]): p for p in printed
               if "set" in p and "metric" in p}
    first = sets.spread([100.0, 96.0, 104.0])
    second = sets.spread([100.0, 90.0, 110.0])
    assert per_set[(0, "sim_step_rate")]["spread"] == pytest.approx(first)
    assert per_set[(1, "sim_step_rate")]["spread"] == pytest.approx(second)
    rule = {p["metric"]: p for p in printed
            if "bound_by_rule" in p}
    assert rule["sim_step_rate"]["prior"] == [0.03]
    assert rule["sim_step_rate"]["bound_by_rule"] == pytest.approx(
        min(0.25, 5 * max(first, second, 0.03)))
    assert rule["setup_s"]["prior"] == []
    units = [p["units"] for p in printed if "units" in p]
    assert len(units) == 2 and units[0]["between"] == 0.0
