"""The port's benchmark helpers and obs CLI against the reference's.

* ``Timer`` / ``timed`` / ``timed_peak`` behave as ``repro.obs.bench``'s;
  with a CPU device they are the host-clock helpers, and a CUDA device
  without a card raises;
* ``count_compiles`` counts the ``cuda/nvcc_build`` events that
  ``kernels._build.build_all`` publishes, one per compiled source (here
  through a stand-in compiler), and nothing for a reused library;
* ``python -m repro_torch.obs report`` prints the reference's table for one
  JSONL written by the port's tracer; ``smoke --device cpu`` returns 0.
"""

import json
import os
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from repro.obs import __main__ as ref_cli
from repro.obs import bench as ref_bench
from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.obs import __main__ as cli
from repro_torch.obs import bench

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_timer_measures_and_matches_reference_contract():
    for dev in (None, "cpu", torch.device("cpu")):
        with bench.Timer(dev) as t:
            time.sleep(0.01)
        assert 0.009 < t.dt < 5.0
    with ref_bench.Timer() as r:
        time.sleep(0.01)
    assert 0.009 < r.dt < 5.0
    assert obs.Timer is bench.Timer


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA: checks that a CUDA timer raises there")
def test_cuda_timer_without_card_raises():
    with pytest.raises((RuntimeError, AssertionError)):
        with bench.Timer(device="cuda"):
            pass


@pytest.mark.parametrize("device", [None, "cpu"])
def test_timed_counts_calls(device):
    calls = []
    dt = bench.timed(lambda: calls.append(1), warmup=2, iters=5,
                     device=device)
    assert len(calls) == 7 and dt >= 0.0
    calls.clear()
    ref_bench.timed(lambda: calls.append(1), warmup=2, iters=5)
    assert len(calls) == 7


@pytest.mark.parametrize("device", [None, "cpu"])
def test_timed_peak_measures_a_separate_call(device):
    calls = []

    def fn():
        calls.append(1)
        return bytearray(4 << 20)

    out, dt, peak = bench.timed_peak(fn, device=device)
    assert len(out) == 4 << 20 and dt >= 0.0 and len(calls) == 2
    assert peak >= 4 << 20
    _, _, ref_peak = ref_bench.timed_peak(fn)
    assert abs(peak - ref_peak) < 1 << 20


def test_count_compiles_counts_build_events_only():
    with bench.count_compiles() as c:
        obs.emit("cuda/nvcc_build", source="x.cu", seconds=1.0)
        obs.emit("xla/backend_compile")
        obs.emit("something/else")
        obs.emit(bench.COMPILE_EVENT, source="y.cu", seconds=2.0)
        assert c.count == 2
    obs.emit(bench.COMPILE_EVENT)  # after the block: not counted
    assert c.count == 2


class _FakeProc:
    """Stands in for one ``nvcc`` process: writes its ``-o`` output."""

    def __init__(self, cmd, **kw):
        out = pathlib.Path(cmd[cmd.index("-o") + 1])
        out.write_bytes(b"\x7fELF stand-in")
        self.returncode = 0

    def communicate(self):
        return "ptxas info    : Used 1 registers", None


def test_count_compiles_counts_each_compiled_source(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "torch_kernels")
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-stand-in")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeProc)
    with bench.count_compiles() as c:
        built = _build.build_all()
    assert sorted(built) == sorted(_build.SOURCES)
    assert c.count == len(_build.SOURCES)
    # every library exists now: a second build compiles and counts nothing
    with bench.count_compiles() as again:
        assert _build.build_all() == {}
    assert again.count == 0


def _write_port_trace(path: pathlib.Path) -> pathlib.Path:
    prev = obs.set_trace(True)
    obs.reset_trace()
    try:
        with obs.span("fabric/ring/tour", members=4):
            with obs.span("fabric/ring/enumerate", pairs=4):
                time.sleep(0.002)
        with obs.span("fabric/ring/tour", members=8):
            pass
        obs.instant("pipeline/stall", step=1)
        obs.emit(bench.COMPILE_EVENT, source="z.cu", seconds=0.1)
        return obs.write_jsonl(path)
    finally:
        obs.set_trace(prev)
        obs.reset_trace()


def test_report_prints_reference_table(tmp_path, capsys):
    jsonl = _write_port_trace(tmp_path / "trace.jsonl")
    recs = [json.loads(x) for x in jsonl.read_text().splitlines() if x]
    assert sum(r["kind"] == "span" for r in recs) == 3
    assert cli.report([str(jsonl)]) == 0
    got = capsys.readouterr().out
    assert ref_cli.report([str(jsonl)]) == 0
    want = capsys.readouterr().out
    assert got == want
    assert "fabric/ring/tour" in got and "instant/counter events" in got
    # a glob argument reads the same file
    assert cli.report([str(tmp_path / "*.jsonl")]) == 0
    assert capsys.readouterr().out == want


def test_report_without_records_fails_like_reference(tmp_path, capsys):
    missing = str(tmp_path / "none" / "*.jsonl")
    assert cli.report([missing]) == ref_cli.report([missing]) == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text("\n")
    assert cli.report([str(empty)]) == ref_cli.report([str(empty)]) == 1
    capsys.readouterr()


def test_smoke_on_cpu_returns_zero(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["smoke", "--device", "cpu"]) == 0
    assert "obs-smoke OK" in capsys.readouterr().out
    chrome = json.loads(
        (tmp_path / "artifacts" / "obs" / "trace.chrome.json").read_text())
    assert obs.validate_chrome_trace(chrome) == []
    assert not obs.trace_enabled()


def test_cli_usage_and_exit_codes(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    run = lambda *a: subprocess.run(  # noqa: E731
        [sys.executable, "-m", "repro_torch.obs", *a], capture_output=True,
        text=True, env=env, cwd=str(tmp_path), timeout=120)
    assert run().returncode == 2
    assert run("report", str(tmp_path / "missing.jsonl")).returncode == 1
    jsonl = _write_port_trace(tmp_path / "t.jsonl")
    out = run("report", str(jsonl))
    assert out.returncode == 0 and "fabric/ring/enumerate" in out.stdout
