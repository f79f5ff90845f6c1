"""Shared benchmark measurement helpers — ONE timing/memory schema.

The port of ``repro/obs/bench.py``: ``Timer``, ``timed``, ``timed_peak``,
``ru_maxrss_mb`` and ``count_compiles``.

Device time: ``Timer``, ``timed`` and ``timed_peak`` take an optional
``device``; when it is a CUDA device they call
``torch.cuda.synchronize(device)`` before each clock read, so the wall time
covers the work the timed code queued on the card.  With ``device=None``
they are the reference's host-clock helpers.

Compiles: the port's only compile step is the ``nvcc`` build of the CUDA
kernels (``kernels._build.build_all``), which publishes one
``cuda/nvcc_build`` event per compiled source on the obs bus;
``count_compiles`` counts those.  A library reused from the build
directory compiles nothing and counts nothing.

Measurement discipline (the reference's): time and tracemalloc peak come
from SEPARATE calls — tracemalloc hooks every allocation and inflates
numpy-heavy wall clock by 1.3-2x, which would make rows apples-to-oranges
against plain timings.  ``ru_maxrss`` is a process-lifetime high-water
mark (never goes down); the tracemalloc peak is the per-call high water of
the arrays + temporaries.  This module imports torch only when a device is
given.
"""

from __future__ import annotations

import contextlib
import resource
import time
import tracemalloc

from . import metrics as _metrics

__all__ = [
    "COMPILE_EVENT",
    "CompileCounter",
    "Timer",
    "count_compiles",
    "ru_maxrss_mb",
    "timed",
    "timed_peak",
]

#: The obs-bus event ``kernels._build.build_all`` publishes per compiled
#: source.
COMPILE_EVENT = "cuda/nvcc_build"


def _syncer(device):
    """A no-argument callable that waits for ``device``'s queued work (a
    no-op unless ``device`` is a CUDA device)."""
    if device is None:
        return lambda: None
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.synchronize(dev)


class Timer:
    """``with Timer() as t: ...`` — elapsed ``perf_counter`` in ``t.dt``;
    ``Timer(device="cuda")`` synchronizes the card before each read."""

    def __init__(self, device=None) -> None:
        self._sync = _syncer(device)

    def __enter__(self) -> "Timer":
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a) -> None:
        self._sync()
        self.dt = time.perf_counter() - self.t0


def ru_maxrss_mb() -> float:
    """Process peak RSS in MiB (ru_maxrss is KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def timed(fn, warmup: int = 1, iters: int = 3, device=None) -> float:
    """Mean wall seconds per call over ``iters`` calls after ``warmup``."""
    sync = _syncer(device)
    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def timed_peak(fn, device=None):
    """(result, seconds, tracemalloc-peak-bytes) over two calls of ``fn``.

    Time and peak are measured in SEPARATE calls (see module docstring);
    the peak is the second call's high-water mark of traced (host)
    allocations.
    """
    sync = _syncer(device)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    dt = time.perf_counter() - t0
    tracemalloc.start()
    fn()
    sync()
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    return out, dt, peak


class CompileCounter:
    """The ``nvcc`` builds seen while a ``count_compiles`` block was live:
    ``count``, and ``events`` (the compiled source of each build)."""

    def __init__(self) -> None:
        self.count = 0
        self.events: list[str] = []


@contextlib.contextmanager
def count_compiles():
    """Count the kernels' ``nvcc`` builds (``cuda/nvcc_build`` events on the
    obs bus) made inside the block.  Yields a :class:`CompileCounter` whose
    ``count`` and ``events`` are live."""
    c = CompileCounter()

    def on_event(name: str, **attrs) -> None:
        if name == COMPILE_EVENT:
            c.count += 1
            c.events.append(str(attrs.get("source", name)))

    _metrics.subscribe(on_event)
    try:
        yield c
    finally:
        _metrics.unsubscribe(on_event)
