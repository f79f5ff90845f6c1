"""The program's own spans in the device trace of a traced run.

While ``REPRO_TRACE`` is on, each span of the program (``repro_torch.obs``)
is also a profiler label ``repro/<span name>``, so the ``torch.profiler``
trace of the measured window holds the program's spans beside the device
operations, on the same clock.  This module reads them as ``devtrace``
reads the benchmark's own labels, with ``devtrace``'s own arithmetic:

* ``spans``: for each program span name, ``count``, ``host_s`` (the
  labels' seconds), ``device_s`` (the seconds of the device operations
  launched inside them, by ``devtrace.attribute``) and ``idle_s`` (the
  window's idle seconds while a label of that name was open, counted
  inclusively: a span's idle time holds its children's);
* ``idle_gaps_in_program``: the longest holes between device operations,
  as ``devtrace`` finds them, each named by the innermost program label
  open at its middle, or ``(outside)`` where none is.

The harness hands its readers ``devtrace``'s summary and not the profiler
itself; it keeps the window's profiler, as ``prof``, in the frame of
``harness.execute`` until the readers have run.  ``of_run`` finds it there,
reads it once and keeps the reading on the run.  A run without the
program's labels (a program older than its spans) reads as no spans, and
its readers return ``None``.

    python3 portbench/progtrace.py --workload <cell> --seeds 1 2 \\
        [--seconds 51] [--trace 1 0] [--out <file>.jsonl]

runs the cell once per seed and per ``--trace`` value, all in one process
(the program's spans follow each run's ``--trace``), and prints each
run's metrics, unit seconds and, for a traced run, its ``spans`` and
``idle_gaps_in_program``.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import bisect
import json
import pathlib
import sys
import time

__all__ = ["OUTSIDE", "PREFIX", "counter_ratio", "find_profiler", "of_run",
           "per_unit", "read", "read_events"]

#: The program's label prefix (``repro_torch.obs.trace``).
PREFIX = "repro/"
#: The name of a hole no program label was open over.
OUTSIDE = "(outside)"

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _program_labels(prof) -> list:
    """``(name, start_us, end_us)`` of the program's labels on the host."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != cuda and name.startswith(PREFIX):
            start = ev.start_ns() / 1e3
            out.append((name, start, start + ev.duration_ns() / 1e3))
    return out


def _holes(dev, window) -> list:
    """The gaps between device operations inside the window, as
    ``devtrace.read_trace`` finds them: ``[(start_us, end_us)]``."""
    lo, hi = window
    spans = sorted((a, b) for _, a, b, *_ in dev if b > lo and a < hi)
    edge, holes = lo, []
    for a, b in spans:
        if a > edge:
            holes.append((edge, a))
        edge = max(edge, b)
    if hi > edge:
        holes.append((edge, hi))
    return holes


def _union(iv: list) -> list:
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _overlap_s(iv: list, holes: list) -> float:
    """Seconds of ``holes`` (sorted, disjoint) that the union of ``iv``
    covers."""
    starts = [a for a, _ in holes]
    total = 0.0
    for a, b in _union(iv):
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(holes) and holes[i][0] < b:
            lo, hi = max(a, holes[i][0]), min(b, holes[i][1])
            if hi > lo:
                total += hi - lo
            i += 1
    return total / 1e6


def read_events(dev, labels, launch, prog, top: int = 10) -> dict:
    """The program's spans and the named idle gaps from the events of
    ``devtrace._events`` (``dev``, ``labels``, ``launch``) and the
    program's labels ``prog``."""
    from portbench import devtrace

    dev = [d for d in dev if not devtrace._runtime(d[0])
           and not d[0].startswith(PREFIX)]
    window = [lab for lab in labels if lab[0] == "portbench/window"]
    holes = _holes(dev, window[0][1:]) if dev and window else []
    by_name: dict[str, list] = {}
    for name, a, b in prog:
        by_name.setdefault(name[len(PREFIX):], []).append((a, b))
    device = devtrace.attribute(dev, prog, launch,
                                {PREFIX + n for n in by_name})
    spans = {}
    for name, iv in sorted(by_name.items()):
        spans[name] = {"count": len(iv),
                       "host_s": sum(b - a for a, b in iv) / 1e6,
                       "device_s": device.get(PREFIX + name, 0.0),
                       "idle_s": _overlap_s(iv, holes)}
    gaps = []
    for a, b in sorted(holes, key=lambda h: h[0] - h[1])[:top]:
        mid = 0.5 * (a + b)
        at = [lab for lab in prog if lab[1] <= mid <= lab[2]]
        name = (max(at, key=lambda lab: lab[1])[0][len(PREFIX):] if at
                else OUTSIDE)
        gaps.append([name, (b - a) / 1e6])
    return {"spans": spans, "idle_gaps_in_program": gaps}


def read(prof, top: int = 10) -> dict:
    """``read_events`` of a finished ``torch.profiler.profile``."""
    from portbench import devtrace

    dev, labels, launch = devtrace._events(prof)
    return read_events(dev, labels, launch, _program_labels(prof), top)


def find_profiler():
    """The profiler of the window being read: the local ``prof`` of the
    innermost calling frame that holds a finished profiler."""
    frame = sys._getframe(1)
    while frame is not None:
        prof = frame.f_locals.get("prof")
        if hasattr(getattr(prof, "profiler", None), "kineto_results"):
            return prof
        frame = frame.f_back
    return None


def of_run(run) -> dict | None:
    """The program's spans of a traced run, read once and kept on it;
    ``None`` for an untraced run."""
    if run.trace is None:
        return None
    got = getattr(run, "program_trace", None)
    if got is None:
        prof = find_profiler()
        if prof is None:
            return None
        got = read(prof)
        run.program_trace = got
    return got


def per_unit(run, name: str, field: str, per: str):
    """A program span's ``field`` (``host_s``, ``device_s``, ``idle_s``)
    over the window's ``per`` (a count of ``run.layer``)."""
    got = of_run(run)
    n = run.layer.get(per)
    if got is None or name not in got["spans"] or not n:
        return None
    return got["spans"][name][field] / n


def counter_ratio(num: str, den: str):
    """The ratio of two of the program's counters, from one registry: the
    whole process's, which holds the set-up's counts too where a cell does
    not reset it before the window, so only a ratio is sound."""
    from repro_torch import obs

    snap = obs.snapshot()
    if num not in snap or not snap.get(den):
        return None
    return snap[num] / snap[den]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--trace", type=int, nargs="+", choices=(0, 1),
                    default=[1])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    from run import _program_env

    _program_env(bool(args.trace[0]))
    import torch

    from portbench import devtrace, harness
    from repro_torch import obs

    if not torch.cuda.is_available():
        print("progtrace: needs a CUDA device", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cell = harness.load_cell(json.loads((ROOT / "BENCHMARK.json").read_text()),
                             args.workload)
    plain = devtrace.read_trace
    kept = {}

    def reading(prof, *a, **kw):
        kept["program"] = read(prof)
        return plain(prof, *a, **kw)

    devtrace.read_trace = reading
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        for trace in args.trace:
            kept.clear()
            obs.set_trace(bool(trace))
            obs.reset_trace()
            t0 = time.perf_counter()
            line = harness.execute(cell, seed, args.seconds, bool(trace), dev,
                                   t0)
            rec = {"workload": cell.name, "seed": seed, "trace": trace,
                   "correct": line["correct"], "metrics": line["metrics"],
                   "unit_s": line["notes"]["unit_s"],
                   "breakdown": line.get("breakdown"), **kept}
            if out:
                out.write(json.dumps(rec) + "\n")
                out.flush()
            print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
