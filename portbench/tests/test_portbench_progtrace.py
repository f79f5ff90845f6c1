"""The program's spans in the device trace (``progtrace.py``).

* On a synthetic trace: each program span's device seconds (launched
  inside it) and idle seconds (inclusive of its children's), and the
  longest idle gaps named by the innermost program label open at their
  middle; ``devtrace``'s own reading is the same with the program's labels
  in the trace as without them.
* Tiny cells of each kind, traced (the program's spans on, under the
  profiler) and untraced, give the same outputs bit for bit, and the
  traced runs report each new metric of their cell.
"""

from __future__ import annotations

import json
import math
import time

import numpy as np
import pytest
import torch

from portbench import devtrace, harness, progtrace
from portbench.tests import tiny

BENCH = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
CPU_T = torch.autograd.DeviceType.CPU
CUDA_T = torch.autograd.DeviceType.CUDA


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The CPU tests run several workers at once: one intra-op thread each
    keeps the small products from contending for the cores (restored
    after the module)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class _Ev:
    """One event of a Kineto result, as ``devtrace._events`` reads it;
    times in microseconds."""

    def __init__(self, name, a, b, device=CPU_T, corr=0, linked=0):
        self._n, self._a, self._b = name, a, b
        self._d, self._c, self._l = device, corr, linked

    def name(self):
        return self._n

    def start_ns(self):
        return int(self._a * 1000)

    def duration_ns(self):
        return int((self._b - self._a) * 1000)

    def device_type(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l


class _Prof:
    def __init__(self, events):
        res = type("R", (), {"events": lambda self: list(events)})()
        self.profiler = type("P", (), {"kineto_results": res})()


#: window 0-1000 us; four kernels, each launched by its runtime call
BASE = [
    _Ev("portbench/window", 0, 1000),
    _Ev("portbench/window", 0, 1000, CUDA_T),  # the label's device copy
    _Ev("portbench/kernels.congestion", 600, 700),
    _Ev("cudaLaunchKernel", 120, 121, corr=1),
    _Ev("cudaLaunchKernel", 320, 321, corr=2),
    _Ev("cudaLaunchKernel", 650, 651, corr=3),
    _Ev("cudaLaunchKernel", 900, 901, corr=4),
    _Ev("aten::add", 118, 125, corr=50),
    _Ev("k_one", 130, 160, CUDA_T, corr=1, linked=50),
    _Ev("k_two", 330, 400, CUDA_T, corr=2),
    _Ev("congestion_band", 655, 690, CUDA_T, corr=3),
    _Ev("k_four", 910, 940, CUDA_T, corr=4),
]
#: the program's labels: host-side operators with ids of their own
PROGRAM = [
    _Ev("repro/build/batch", 100, 500, corr=101),
    _Ev("repro/build/enumerate", 150, 300, corr=102),
    _Ev("repro/kernels/congestion", 600, 700, corr=103),
    _Ev("repro/sim/step", 800, 950, corr=104),
]


def test_program_spans_and_named_gaps_on_a_synthetic_trace():
    got = progtrace.read(_Prof(BASE + PROGRAM))
    want = {  # (count, host us, device us, idle us)
        "build/batch": (1, 400, 30 + 70, 30 + 170 + 100),
        "build/enumerate": (1, 150, 0, 140),
        "kernels/congestion": (1, 100, 35, 55 + 10),
        "sim/step": (1, 150, 30, 110 + 10),
    }
    assert set(got["spans"]) == set(want)
    for name, (n, host, device, idle) in want.items():
        sp = got["spans"][name]
        assert sp["count"] == n
        assert sp["host_s"] == pytest.approx(host * 1e-6)
        assert sp["device_s"] == pytest.approx(device * 1e-6)
        assert sp["idle_s"] == pytest.approx(idle * 1e-6)
    names = [n for n, _ in got["idle_gaps_in_program"]]
    secs = [s for _, s in got["idle_gaps_in_program"]]
    assert names == [progtrace.OUTSIDE, "sim/step", "build/enumerate",
                     progtrace.OUTSIDE, progtrace.OUTSIDE]
    assert secs == pytest.approx([255e-6, 220e-6, 170e-6, 130e-6, 60e-6])
    # devtrace's reading does not move with the program's labels
    plain = devtrace.read_trace(_Prof(BASE), attribute_to=["kernels.congestion"])
    with_prog = devtrace.read_trace(_Prof(BASE + PROGRAM),
                                    attribute_to=["kernels.congestion"])
    assert plain == with_prog
    assert devtrace.breakdown(plain) == devtrace.breakdown(with_prog)
    assert plain.labelled["kernels.congestion"] == pytest.approx(35e-6)


def test_a_trace_without_program_labels_reads_no_spans():
    got = progtrace.read(_Prof(BASE))
    assert got["spans"] == {}
    assert {n for n, _ in got["idle_gaps_in_program"]} == {progtrace.OUTSIDE}


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


CELLS = {"probe": "jf720k24.probe", "expand": "jf720k24.expand",
         "sim": "rrg512x8.sim_ksp"}
NEW = {"probe": ["routing.enum_s_per_probe", "device.build_idle_s_per_probe"],
       "expand": ["expansion.expand_s_per_step",
                  "routing.delta_enum_s_per_step"],
       "sim": ["sim.loads_calls_per_step", "sim.host_syncs_per_step"]}


@pytest.mark.parametrize("kind", ["probe", "expand", "sim"])
def test_traced_tiny_run_equals_untraced_and_reads_its_spans(kind,
                                                             monkeypatch):
    from repro_torch import obs

    tiny.mw_everywhere(monkeypatch)
    cell = tiny.cell(kind)
    cell.per_layer = harness.load_cell(BENCH, CELLS[kind]).per_layer
    kinds, lines = [], []
    for trace in (False, True):
        prev = obs.set_trace(trace)
        obs.reset_metrics()  # a fresh process's registry, as run.py has
        try:
            lines.append(harness.execute(
                cell, 2**31 + 91, 0.2, trace, torch.device("cpu"),
                time.perf_counter(), hook=kinds.append))
        finally:
            obs.set_trace(prev)
            obs.reset_trace()
    plain, traced = (k.records for k in kinds)
    n = min(len(plain), len(traced))
    assert n >= 1 and _same(plain[:n], traced[:n])
    assert all(line["correct"] for line in lines)
    for name in NEW[kind]:
        assert math.isfinite(lines[1]["metrics"][name]["value"]), name
    if kind == "sim":
        cfg = cell.config
        assert lines[1]["metrics"]["sim.loads_calls_per_step"]["value"] == (
            2 * cfg["wf_iters"] + 3)
        assert lines[1]["metrics"]["sim.host_syncs_per_step"]["value"] == 2


def test_readers_find_the_window_profiler_in_harness_execute(monkeypatch):
    """The span readers take the window's profiler from the local ``prof``
    of ``harness.execute`` (``progtrace.find_profiler``): a rename there
    would silently drop their metrics from the result line."""
    found = []
    plain = harness.read_metrics

    def reading(run, entries, folder, *a, **kw):
        found.append((folder, progtrace.find_profiler()))
        return plain(run, entries, folder, *a, **kw)

    monkeypatch.setattr(harness, "read_metrics", reading)
    harness.execute(tiny.cell("sim"), 2**31 + 93, 0.1, True,
                    torch.device("cpu"), time.perf_counter())
    assert [folder for folder, _ in found] == ["metrics"]
    prof = found[0][1]
    assert prof is not None and prof.profiler.kineto_results is not None
