"""Hierarchical host spans on the device trace's clock.

The port's solvers are Python loops that queue CUDA work: a probe is a host
path build (APSP, slack budgets, frontier enumeration, slot assembly) and
then a batched MW solve; a simulated step is a few dozen kernel launches
and two blocking host reads; an expansion step mutates the topology on the
host before its delta routing.  A device trace alone shows the card idle
between launches and cannot say why.  This module records what the HOST
does, as a tree of named spans that exports to JSONL and to the
Chrome-trace event format, and names each span in the device trace too.

Design constraints (INVARIANTS.md OB-1):

* **A span is a profiler label.**  While a span is live it also opens a
  ``torch.profiler`` label ``repro/<name>`` (a ``RecordFunction``), so a
  ``torch.profiler`` run shows the span in the same Kineto trace as the
  device operations, on the same clock, nested under whatever labels the
  caller opened (a benchmark's own, say).  The label is the fast
  ``RecordFunction`` form, which the profiler keeps on the host timeline
  only: it adds no event to the device timeline.  No span synchronises
  the device: spans time the host, device time comes from the trace, and
  a traced run launches the same kernels on the same inputs as an
  untraced one, so its results are bit-identical (asserted by
  ``tests/test_torch_obs.py``).
* **Zero-overhead off switch** — ``REPRO_TRACE`` (validated through the
  ``repro_torch.env`` registry like every knob) seeds the process default;
  ``span()`` returns one shared no-op context manager when disabled, so
  the instrumented paths pay one flag test and a kwargs dict a span.  The
  disabled path imports nothing; torch is imported the first time a span
  goes live, so this module stays importable without torch.
* **Cheap measurements only while enabled** — wall clock
  (``perf_counter``), thread id, the ``ru_maxrss`` watermark as last read
  (``getrusage`` at most every ``RSS_EVERY_S``: on an H100 machine's host
  one call took ~95 us, more than the rest of a span), and a tracemalloc
  delta ONLY when the caller already started tracemalloc (hooking every
  allocation inflates numpy-heavy wall clock 1.3-2x behind the caller's
  back).

Spans nest per thread: a build running on the ``stream_builds`` prefetch
worker records its own thread id and parents correctly under whatever
span that worker was asked to run inside, so the Chrome trace shows the
prefetch and the consumer as two lanes.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import pathlib
import threading
import time
import tracemalloc
from typing import Any, Iterator

from .. import env

__all__ = [
    "Span",
    "TRACE_OUT",
    "annotate",
    "counter_event",
    "get_events",
    "get_spans",
    "instant",
    "reset_trace",
    "set_trace",
    "span",
    "spanned",
    "trace_enabled",
    "write_chrome_trace",
    "write_jsonl",
]

#: Default artifact directory for trace sinks (JSONL + Chrome trace).
TRACE_OUT = env.read("REPRO_TRACE_OUT")

_trace_default = bool(env.read("REPRO_TRACE"))


def trace_enabled(enabled: bool | None = None) -> bool:
    """Resolve a call site's ``enabled`` argument against the process
    default (``REPRO_TRACE`` at import, possibly flipped by
    :func:`set_trace`); an explicit bool always wins."""
    return _trace_default if enabled is None else bool(enabled)


def set_trace(flag: bool) -> bool:
    """Flip the process-wide tracing default; returns the previous value.

    The env var only seeds the initial state (read once at import, the
    ``repro.env`` discipline); tests and the obs-smoke lane flip this to
    compare traced vs untraced runs in one process.
    """
    global _trace_default
    prev, _trace_default = _trace_default, bool(flag)
    return prev


@dataclasses.dataclass
class Span:
    """One completed span: a named, attributed host-side interval."""

    name: str
    span_id: int
    parent_id: int  # -1 at the root of a thread's stack
    tid: int
    depth: int
    t0: float  # perf_counter seconds (process-relative timeline)
    wall_s: float
    rss_mb: float  # ru_maxrss watermark, read at most RSS_EVERY_S before exit
    trmalloc_delta: int | None  # bytes, only when tracemalloc was tracing
    attrs: dict

    def to_record(self) -> dict:
        rec = {
            "kind": "span",
            "name": self.name,
            "id": self.span_id,
            "parent": self.parent_id,
            "tid": self.tid,
            "depth": self.depth,
            "t0_s": self.t0,
            "wall_s": self.wall_s,
            "rss_mb": self.rss_mb,
        }
        if self.trmalloc_delta is not None:
            rec["tracemalloc_delta_bytes"] = self.trmalloc_delta
        if self.attrs:
            rec["attrs"] = self.attrs
        return rec


#: Seconds between two reads of the process's RSS watermark.
RSS_EVERY_S = 0.1

_rss_read = [float("-inf"), 0.0]  # [perf_counter at the read, MiB]


def _rss_mb() -> float:
    """Process peak RSS in MiB (ru_maxrss is KiB on Linux), as read at most
    ``RSS_EVERY_S`` ago: a watermark only rises, and a span loop at a few
    hundred spans a second must not pay a ``getrusage`` each."""
    now = time.perf_counter()
    if now - _rss_read[0] >= RSS_EVERY_S:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        _rss_read[:] = [now, rss]
    return _rss_read[1]


class _Tracer:
    """Process-global span/event store: thread-local stacks, one flat log."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._next_id = 0
        self.spans: list[Span] = []
        self.events: list[dict] = []  # instant + counter events

    def _stack(self) -> list:
        """This thread's live spans, innermost last."""
        st = getattr(self._local, "stack", None)
        if st is None:
            st = []
            self._local.stack = st
        return st

    def new_id(self) -> int:
        with self._lock:
            sid = self._next_id
            self._next_id += 1
        return sid

    def add_span(self, sp: Span) -> None:
        with self._lock:
            self.spans.append(sp)

    def add_event(self, rec: dict) -> None:
        with self._lock:
            self.events.append(rec)

    def reset(self) -> None:
        with self._lock:
            self.spans.clear()
            self.events.clear()
            self._next_id = 0


_TRACER = _Tracer()


#: ``torch``'s fast profiler label, imported at the first live span.
_LABEL = None


def _label(name: str):
    """A ``RecordFunctionFast`` label: a host-side operator in the
    profiler's trace, which the profiler does not mirror on the device
    timeline (a ``record_function`` user annotation it does mirror)."""
    global _LABEL
    if _LABEL is None:
        import torch

        _LABEL = torch._C._profiler._RecordFunctionFast
    return _LABEL(name)


class _SpanCtx:
    """Live span context manager (only ever constructed while enabled)."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "depth", "t0",
                 "_tm0", "_label")

    def __init__(self, name: str, attrs: dict) -> None:
        self.name = name
        self.attrs = attrs

    def __enter__(self) -> "_SpanCtx":
        self._label = _label(f"repro/{self.name}")
        self._label.__enter__()
        stack = _TRACER._stack()
        self.parent_id = stack[-1].span_id if stack else -1
        self.depth = len(stack)
        self.span_id = _TRACER.new_id()
        stack.append(self)
        self._tm0 = (
            tracemalloc.get_traced_memory()[0]
            if tracemalloc.is_tracing()
            else None
        )
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        wall = time.perf_counter() - self.t0
        self._label.__exit__(*exc)
        stack = _TRACER._stack()
        if stack and stack[-1] is self:
            stack.pop()
        delta = None
        if self._tm0 is not None and tracemalloc.is_tracing():
            delta = tracemalloc.get_traced_memory()[0] - self._tm0
        _TRACER.add_span(
            Span(
                name=self.name,
                span_id=self.span_id,
                parent_id=self.parent_id,
                tid=threading.get_ident(),
                depth=self.depth,
                t0=self.t0,
                wall_s=wall,
                rss_mb=_rss_mb(),
                trmalloc_delta=delta,
                attrs=self.attrs,
            )
        )


class _NoopCtx:
    """Shared do-nothing context manager — the disabled-path ``span()``."""

    __slots__ = ()

    def __enter__(self) -> "_NoopCtx":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None


_NOOP = _NoopCtx()


def span(name: str, **attrs: Any):
    """Context manager timing one named host interval, and labelling it
    ``repro/<name>`` for ``torch.profiler``.

        with obs.span("build/shard", pairs=128, tile=shape):
            ...host enumeration...
            obs.annotate(found=n)  # attributes known only inside

    Disabled (``REPRO_TRACE`` unset / :func:`set_trace(False)`), returns a
    shared no-op object: the call costs one flag test and the kwargs dict.
    """
    if not _trace_default:
        return _NOOP
    return _SpanCtx(name, attrs)


def spanned(name: str):
    """Decorator: each call of the function is the span ``name``.

        @obs.spanned("mw/solve")
        def mw_concurrent_flow(ps, ...):
            obs.annotate(paths=ps.n_paths)

    Disabled, a call costs one flag test more than the bare function.
    """

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args: Any, **kwargs: Any):
            if not _trace_default:
                return fn(*args, **kwargs)
            with _SpanCtx(name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def annotate(**attrs: Any) -> None:
    """Add attributes to this thread's innermost live span, if tracing."""
    if not _trace_default:
        return
    stack = _TRACER._stack()
    if stack:
        stack[-1].attrs.update(attrs)


def instant(name: str, **attrs: Any) -> None:
    """Record an instant event (a point on the timeline), if tracing."""
    if not _trace_default:
        return
    _TRACER.add_event(
        {
            "kind": "instant",
            "name": name,
            "t0_s": time.perf_counter(),
            "tid": threading.get_ident(),
            "attrs": attrs,
        }
    )


def counter_event(name: str, value: float) -> None:
    """Record a counter sample (Perfetto renders these as a value track —
    the MW alpha trajectory uses this), if tracing."""
    if not _trace_default:
        return
    _TRACER.add_event(
        {
            "kind": "counter",
            "name": name,
            "t0_s": time.perf_counter(),
            "tid": threading.get_ident(),
            "value": float(value),
        }
    )


def get_spans() -> list[Span]:
    """Snapshot of the completed spans recorded so far."""
    with _TRACER._lock:
        return list(_TRACER.spans)


def get_events() -> list[dict]:
    """Snapshot of the instant/counter events recorded so far."""
    with _TRACER._lock:
        return list(_TRACER.events)


def reset_trace() -> None:
    """Drop all recorded spans/events (does not change the enable flag)."""
    _TRACER.reset()


def _records() -> Iterator[dict]:
    with _TRACER._lock:
        spans = list(_TRACER.spans)
        events = list(_TRACER.events)
    for sp in spans:
        yield sp.to_record()
    for ev in events:
        yield ev


def write_jsonl(path: str | os.PathLike | None = None) -> pathlib.Path:
    """Write every recorded span/event as one-JSON-object-per-line.

    Default path: ``{REPRO_TRACE_OUT}/trace.jsonl``.  Returns the path.
    """
    p = pathlib.Path(path) if path is not None else (
        pathlib.Path(TRACE_OUT) / "trace.jsonl"
    )
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as fh:
        for rec in _records():
            fh.write(json.dumps(rec, default=str) + "\n")
    return p


def chrome_trace_events(records: "Iterator[dict] | list[dict] | None" = None,
                        pid: int | None = None) -> list[dict]:
    """Convert obs records to Chrome-trace events (Perfetto-loadable).

    Spans become complete events (``ph: "X"``, microsecond ``ts``/``dur``),
    instants ``ph: "i"``, counters ``ph: "C"``.  Takes the live tracer's
    records by default; pass parsed JSONL records to convert a saved log.
    """
    if records is None:
        records = _records()
    if pid is None:
        pid = os.getpid()
    out = []
    for rec in records:
        kind = rec.get("kind", "span")
        base = {
            "name": rec["name"],
            "pid": pid,
            "tid": rec.get("tid", 0),
            "ts": round(float(rec["t0_s"]) * 1e6, 3),
        }
        if kind == "span":
            args = dict(rec.get("attrs") or {})
            args["rss_mb"] = rec.get("rss_mb")
            if "tracemalloc_delta_bytes" in rec:
                args["tracemalloc_delta_bytes"] = rec[
                    "tracemalloc_delta_bytes"
                ]
            out.append(
                {
                    **base,
                    "ph": "X",
                    "cat": rec["name"].split("/")[0],
                    "dur": round(float(rec["wall_s"]) * 1e6, 3),
                    "args": args,
                }
            )
        elif kind == "counter":
            out.append(
                {**base, "ph": "C", "args": {"value": rec.get("value", 0.0)}}
            )
        else:  # instant
            out.append(
                {
                    **base,
                    "ph": "i",
                    "s": "t",
                    "cat": rec["name"].split("/")[0],
                    "args": dict(rec.get("attrs") or {}),
                }
            )
    return out


def write_chrome_trace(path: str | os.PathLike | None = None) -> pathlib.Path:
    """Write the recorded trace in Chrome-trace JSON (load in Perfetto /
    ``chrome://tracing``).  Default: ``{REPRO_TRACE_OUT}/trace.chrome.json``.
    """
    p = pathlib.Path(path) if path is not None else (
        pathlib.Path(TRACE_OUT) / "trace.chrome.json"
    )
    p.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "traceEvents": chrome_trace_events(),
        "displayTimeUnit": "ms",
    }
    p.write_text(json.dumps(payload))
    return p


def validate_chrome_trace(payload: dict) -> list[str]:
    """Schema check for a Chrome-trace payload; returns problems (empty =
    valid).  The obs-smoke CI step runs this over a freshly traced solve so
    a field rename can't silently break Perfetto loading."""
    problems: list[str] = []
    if not isinstance(payload, dict) or "traceEvents" not in payload:
        return ["payload must be an object with a 'traceEvents' list"]
    evs = payload["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be a list"]
    for n, ev in enumerate(evs):
        where = f"traceEvents[{n}]"
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"{where}: missing {field!r}")
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "B", "E", "M"):
            problems.append(f"{where}: unknown phase {ph!r}")
        if ph == "X" and "dur" not in ev:
            problems.append(f"{where}: complete event missing 'dur'")
        if ph == "X" and not isinstance(ev.get("dur"), (int, float)):
            problems.append(f"{where}: 'dur' must be a number")
        if not isinstance(ev.get("ts"), (int, float)):
            problems.append(f"{where}: 'ts' must be a number")
    return problems
