"""Host/device double-buffered path-system build pipeline.

The port's copy of ``repro/core/buildpipe.py``.  The sweeps (the
capacity bisection's probe waves) interleave two different workloads per
instance shard:

    host:   enumerate + assemble   (numpy frontier expansion in
            ``build_path_system_batch``, with its APSP and admission
            launches on the card)
    device: batched MW solve       (a Python loop of torch operations and
            congestion launches; each returns once enqueued)

Run sequentially, the card idles while the host enumerates and vice versa.
This module overlaps them with ONE stage of lookahead:

    shard:      0          1          2
    host    [build 0] [build 1] [build 2]
    device            [solve 0] [solve 1] [solve 2]
                       ^ build 1 runs while solve 0 executes

``stream_builds(thunks)`` submits build i+1 to a single background worker
*before* yielding build i, so the consumer's solve of shard i runs
concurrently with the host enumeration of shard i+1.

Buffering discipline — why exactly one worker and one slot of lookahead:

- ``max_workers=1`` serializes all builds on one thread, so the routing
  module's process-global ``_topo_cache`` only ever sees one mutating
  thread during a stream.  Builds never run concurrently with each other —
  only with the *consumer's* device work — which is what makes the
  pipeline a pure scheduling change.
- One slot of lookahead bounds peak memory at two in-flight builds (the one
  being consumed + the one being built).

CUDA streams: with ``device`` a CUDA device, the worker runs every build
under a CUDA stream of its own.  The builds' APSP and admission launches,
and their copies to the host, then queue on that stream and not behind the
consumer's solve on the default stream; a build's results are host numpy
arrays (every copy back has completed) before the worker hands them over.
The kernels' launch counters are guarded by a lock (``kernels._build``),
so launches from both threads are counted.

Bit-exactness: the pipeline reorders nothing — thunk i's result is yielded
at position i, and each thunk runs exactly once on the single worker in
submission order.  Combined with ``build_path_system_batch``'s own contract
(batch == B sequential builds, CT-build), a pipelined sweep produces
byte-identical path systems, alphas, and verdicts to the sequential
loop; the only observable difference is wall-clock.
``REPRO_BUILD_PIPELINE=0`` (or ``enabled=False``) degrades to strict
sequential execution on the caller's thread — same results, no worker.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

import torch

from .. import env
from .. import obs

__all__ = ["pipeline_enabled", "set_build_pipeline", "stream_builds"]

T = TypeVar("T")

_pipeline_default = bool(env.read("REPRO_BUILD_PIPELINE"))


def pipeline_enabled(enabled: bool | None = None) -> bool:
    """Resolve a caller's ``enabled`` argument against the process default.

    ``None`` means "whatever ``REPRO_BUILD_PIPELINE`` said at import" (on
    unless the env set 0, possibly overridden by ``set_build_pipeline``);
    an explicit bool always wins.
    """
    return _pipeline_default if enabled is None else bool(enabled)


def set_build_pipeline(flag: bool) -> bool:
    """Flip the process-wide pipeline default; returns the previous value.

    The env var only seeds the initial state (read once at import); tests
    and ``chip_smoke.py`` flip this to compare both modes in one process.
    """
    global _pipeline_default
    prev, _pipeline_default = _pipeline_default, bool(flag)
    return prev


def _worker_stream(device: "str | torch.device | None"):
    """A context that puts the calling thread on a CUDA stream of its own
    for a CUDA ``device``; a no-op context otherwise."""
    if device is None or torch.device(device).type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.stream(torch.cuda.Stream(device=torch.device(device)))


def stream_builds(
    thunks: Iterable[Callable[[], T]],
    enabled: bool | None = None,
    device: "str | torch.device | None" = None,
) -> Iterator[T]:
    """Yield ``thunk()`` results in order, prefetching one build ahead.

    Each element of ``thunks`` is a zero-argument build closure (typically
    wrapping ``build_path_system_batch`` over one instance shard).  With
    the pipeline enabled, build i+1 is submitted to the single background
    worker before build i is yielded.  Results arrive in submission order
    regardless of timing; a thunk that raises propagates at its own yield
    position and cancels nothing already submitted (the single worker
    drains it, matching sequential semantics).  ``device`` is the builds'
    device: a CUDA device gives the worker its own stream (module doc).
    """
    if not pipeline_enabled(enabled):
        for i, thunk in enumerate(thunks):
            with obs.span("build/serial", idx=i):
                result = thunk()
            yield result
        return

    def run(thunk: Callable[[], T], idx: int) -> tuple[T, float]:
        # executes on the single worker thread — the span carries that
        # thread's id, so Perfetto shows builds as their own lane
        with obs.span("build/prefetch", idx=idx), _worker_stream(device):
            t0 = time.perf_counter()
            out = thunk()
            return out, time.perf_counter() - t0

    def drain(fut) -> T:
        t0 = time.perf_counter()
        out, build_s = fut.result()
        stall_s = time.perf_counter() - t0
        # stall: consumer time blocked waiting on the worker; overlap:
        # build time hidden behind the consumer's own (device) work
        obs.counter("pipeline/builds").inc()
        obs.counter("pipeline/stall_s").inc(stall_s)
        obs.counter("pipeline/overlap_s").inc(max(build_s - stall_s, 0.0))
        return out

    it = iter(thunks)
    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = None
        for i, thunk in enumerate(it):
            fut = pool.submit(run, thunk, i)
            if pending is not None:
                yield drain(pending)
            pending = fut
        if pending is not None:
            yield drain(pending)
