"""Reading a ``torch.profiler`` trace of the measured window.

The device's busy seconds are the arithmetic of the program's
``chip_smoke.sim_trace``, copied: the sum of every device operation's
seconds (kernels, copies and fills; the runtime's host-side API entries
left out) over one stream, so the operations do not overlap; the idle
share is one minus busy over the traced host window.  The breakdown lists
the device operations that took most time and the longest gaps between
device operations, each named by the benchmark's span (a
``portbench/...`` profiler label) that the host was in at the gap's
middle.

Device time is also attributed to the benchmark's labels that name a
layer of work (``labels.py``): a device operation counts for a label when
the host launched it inside that label.  The launch is found by the
operation's correlation with its runtime call (``cudaLaunchKernel`` and
the like), else with the PyTorch operator that issued it.
"""

from __future__ import annotations

import bisect
import dataclasses

__all__ = ["DeviceTrace", "attribute", "read_trace"]


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float  # sum of device operations' seconds
    ops: dict  # device operation name -> seconds
    gaps: list  # [(label, seconds)], longest first
    #: label (``portbench/`` dropped) -> seconds of the device operations
    #: launched inside it
    labelled: dict = dataclasses.field(default_factory=dict)


def _events(prof):
    """(device events, label events, launch times) from the profiler's
    Kineto results.  A device event is ``(name, start_us, end_us,
    correlation, linked correlation)``, a label ``(name, start_us,
    end_us)``; launch times map a runtime call's correlation id, and
    (under ``op:``) a PyTorch operator's, to its host start."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, labels, launch = [], [], {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, dur = ev.start_ns() / 1e3, ev.duration_ns() / 1e3
        if ev.device_type() == cuda:
            if not name.startswith("portbench/"):  # a label's device copy
                dev.append((name, start, start + dur, ev.correlation_id(),
                            ev.linked_correlation_id()))
        elif name.startswith("portbench/"):
            labels.append((name, start, start + dur))
        elif _runtime(name):
            launch[ev.correlation_id()] = start
        elif ev.linked_correlation_id() == 0:
            launch[("op", ev.correlation_id())] = start
    return dev, labels, launch


def attribute(dev, labels, launch, names) -> dict:
    """Seconds of the device events launched inside each label of
    ``names`` (``portbench/`` dropped); see ``_events`` for the shapes."""
    spans = {}
    for name, a, b in labels:
        short = name.removeprefix("portbench/")
        if short in names:
            spans.setdefault(short, []).append((a, b))
    out = {}
    for short, iv in spans.items():
        iv.sort()
        starts = [a for a, _ in iv]
        total = 0.0
        for ev in dev:
            t = launch.get(ev[3])
            if t is None:
                t = launch.get(("op", ev[4]))
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += (ev[2] - ev[1]) / 1e6
        out[short] = total
    return out


def _runtime(name: str) -> bool:
    # runtime API entries (cudaLaunchKernel, cudaMemcpyAsync, ...) are host
    # work, as sim_trace leaves them out
    return name.startswith("cuda")


def read_trace(prof, top: int = 10, attribute_to=()) -> DeviceTrace:
    """The trace's busy time, device operations, longest idle gaps, and
    the device seconds of each label of ``attribute_to``."""
    dev, labels, launch = _events(prof)
    dev = [d for d in dev if not _runtime(d[0])]
    ops: dict[str, float] = {}
    for name, a, b, *_ in dev:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    busy = sum(ops.values())
    gaps = []
    window = [lab for lab in labels if lab[0] == "portbench/window"]
    if dev and window:
        lo, hi = window[0][1], window[0][2]
        spans = sorted((a, b) for _, a, b, *_ in dev if b > lo and a < hi)
        edge = lo
        holes = []
        for a, b in spans:
            if a > edge:
                holes.append((edge, a))
            edge = max(edge, b)
        if hi > edge:
            holes.append((edge, hi))
        inner = [lab for lab in labels if lab[0] != "portbench/window"]
        for a, b in sorted(holes, key=lambda h: h[0] - h[1])[:top]:
            mid = 0.5 * (a + b)
            at = [lab for lab in inner if lab[1] <= mid <= lab[2]]
            name = (max(at, key=lambda lab: lab[1])[0] if at
                    else "portbench/window")
            gaps.append((name.removeprefix("portbench/"), (b - a) / 1e6))
    return DeviceTrace(busy, ops, gaps,
                       attribute(dev, labels, launch, set(attribute_to)))


def breakdown(trace: DeviceTrace, top: int = 10) -> dict:
    ops = sorted(trace.ops.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in trace.gaps[:top]]}
