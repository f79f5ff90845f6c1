"""The benchmark's layout: BENCHMARK.json's keys, names and limits,
every part found by its name, a throwaway traffic mix discovered without a
line of code, and the benchmark's isolation from the JAX package."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness, isolation
from portbench.tests import tiny

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_part_of_a_cell_is_found_by_name(cell):
    c = harness.load_cell(BENCH, cell)
    assert (harness.HERE / "kinds" / f"{c.kind}.py").is_file()
    for m in c.end_to_end:
        assert (harness.HERE / "endtoend" / f"{m['name']}.py").is_file()
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.per_layer:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    w = {x["name"]: x for x in BENCH["workloads"]}[cell]
    conf = {x["name"]: x for x in BENCH["configs"]}[w["config"]]
    assert conf["file"].startswith("portbench/configs/")
    assert c.config["reduced"] == conf["reduced"]


def test_a_traffic_file_alone_makes_a_new_cell(monkeypatch):
    """Discovery by name: a cell whose traffic mix is a new data file runs
    with no code added."""
    tiny.mw_everywhere(monkeypatch)
    name = f"throwaway_{os.getpid()}"
    path = harness.HERE / "traffic" / f"{name}.json"
    tr = dict(tiny.cell("probe").traffic,
              servers={"first": 120, "last": 120, "step": 20})
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "jf720k24.throwaway",
                               "config": "jf720-k24", "traffic": name,
                               "chips": 1, "why": "test"})
    try:
        path.write_text(json.dumps(tr))
        c = harness.load_cell(bench, "jf720k24.throwaway")
    finally:
        path.unlink()
    assert c.kind == "probe" and c.traffic["servers"]["first"] == 120
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]
    c.config.update(tiny.cell("probe").config)
    assert tiny.run(c)["correct"]


def test_nothing_imports_the_jax_package_or_references_the_program():
    assert isolation.scan_imports(harness.HERE) == []


def test_forbidden_names_compare_whole_top_levels():
    assert isolation.loaded_forbidden({"repro_torch.core": 1,
                                       "reproduce": 1}) == []
    assert isolation.loaded_forbidden({"repro.core": 1, "jax.numpy": 1,
                                       "benchmarks": 1}) == [
        "benchmarks", "jax", "repro"]


def test_result_line_schema(monkeypatch):
    tiny.mw_everywhere(monkeypatch)
    line = tiny.run(tiny.cell("expand"))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        line["device"])
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_run_refuses_without_a_card():
    """Without CUDA the command prints no result and exits non-zero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "jf720k24.probe", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        check=False)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
