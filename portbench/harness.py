"""The benchmark's core: finds a cell's parts by name and runs one run.

Everything that belongs to one configuration, traffic mix or metric lives
in files of its own, found by the names in ``BENCHMARK.json``:

* ``configs/<config>.json``       the configuration as it is run;
* ``traffic/<traffic>.json``      the traffic mix's parameters; its ``kind``
                                  names the general driver that reads it,
                                  ``kinds/<kind>.py``;
* ``endtoend/<metric>.py``        an end-to-end metric's reader;
* ``metrics/<metric>.py``         a per-layer metric's reader.

A reader is a module with ``read(run) -> float | None``; ``None`` means it
found nothing to read, and the metric is left out of the result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

__all__ = ["Cell", "Run", "HERE", "execute", "judge", "load_cell",
           "load_module", "read_metrics"]

HERE = pathlib.Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    kind: str
    end_to_end: list  # BENCHMARK.json entries reported by --trace 0
    per_layer: list  # entries reported by --trace 1


@dataclasses.dataclass
class Run:
    """What a reader may read of one run."""

    cell: Cell
    units: int  # driver units completed in the window
    work: float  # the cell's end-to-end work done in the window
    window_s: float
    setup_s: float
    layer: dict  # the driver's per-layer readings (counts, spans, work)
    trace: object = None  # devtrace.DeviceTrace of a traced run


def load_module(path: pathlib.Path, name: str):
    """Import one file of the benchmark by its path (names hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _reported(entry: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in e2e_names


def load_cell(bench: dict, name: str, root: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``), its files read."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    base = root.parent
    config = json.loads((base / conf["file"]).read_text())
    traffic = json.loads((root / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _reported(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, traffic["kind"], e2e,
                per)


def read_metrics(run: Run, entries: list, folder: str,
                 root: pathlib.Path = HERE) -> dict:
    """``{name: {"value", "unit"}}`` of each entry whose reader finds a
    finite value."""
    out = {}
    for m in entries:
        mod = load_module(root / folder / f"{m['name']}.py",
                          f"portbench_{folder}_{m['name'].replace('.', '_')}")
        v = mod.read(run)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def judge(checks: list) -> bool:
    """A run is correct when every compared number is finite and within
    its limit."""
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, hook=None, control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: set-up, the measured window, the
    metrics, then the check.  Returns the result line (``checks`` last).
    ``hook(driver)``, when given, runs before set-up (the control and the
    fault tests use it to put other code in the program's place);
    ``control`` puts the kind's control there (``install_control``)."""
    import numpy as np
    import torch

    from portbench import labels
    from portbench.timing import Spans

    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    kind = load_module(HERE / "kinds" / f"{cell.kind}.py",
                       f"portbench_kind_{cell.kind}")
    spans = Spans(device, enabled=trace)
    driver = kind.Driver(cell, seed, device, spans)
    if control:
        kind.install_control(driver)
    if hook is not None:
        hook(driver)
    marks = contextlib.ExitStack()
    marks.enter_context(labels.congestion_labels(enabled=trace))
    driver.setup()
    sync()
    setup_s = time.perf_counter() - t_start

    driver.before_window()
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
    units = 0
    ends = []
    with prof:
        with spans.span("window"):
            t0 = time.perf_counter()
            while True:
                driver.unit()
                sync()
                units += 1
                window_s = time.perf_counter() - t0
                ends.append(window_s)
                if window_s >= seconds:
                    break
    marks.close()
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    run = Run(cell, units, driver.work(units), window_s, setup_s,
              driver.layer())
    dev_info = {"platform": "gpu" if cuda else device.type,
                "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": peak}
    extra, labelled = {}, None
    if trace:
        from portbench import devtrace

        run.trace = devtrace.read_trace(prof, attribute_to=[labels.CONGESTION])
        metrics = read_metrics(run, cell.per_layer, "metrics")
        dev_info.update(busy_s=run.trace.busy_s, window_s=window_s)
        extra["breakdown"] = devtrace.breakdown(run.trace)
        # device seconds inside the congestion label, beside the seconds of
        # the kernels named so, as a check on the attribution
        labelled = {"labelled": dict(run.trace.labelled),
                    "named_congestion": sum(v for k, v in run.trace.ops.items()
                                            if "congestion" in k)}
    else:
        metrics = read_metrics(run, cell.end_to_end, "endtoend")
    del prof
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks, failed = driver.check(np.random.default_rng([seed, 0x5EED]))
    return {"correct": judge(checks), "attempted": units, "failed": failed,
            "metrics": metrics, "device": dev_info, **extra,
            "notes": {"setup_s": setup_s, "window_s": window_s,
                      **({"device_s": labelled} if trace else {}),
                      "unit_s": [b - a for a, b in zip([0.0] + ends, ends)],
                      **getattr(driver, "notes", {})},
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}
