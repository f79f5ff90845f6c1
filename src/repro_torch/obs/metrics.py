"""Counters / gauges / log2-histograms + the obs event bus.

Solver telemetry that a span timeline can't express: HOW MANY commodities
a delta update spliced vs re-enumerated, how far the MW alpha got per
window and why the solve stopped, how much of a streamed build the
consumer actually overlapped.  All host-side Python over plain dicts —
instruments live at host boundaries only (INVARIANTS.md OB-1), so they
can never perturb a jitted computation.

Port copy of ``repro/obs/metrics.py`` (stdlib only), carried over unchanged
apart from this note; the port's solvers call the same spans and counters.

Metric types
------------
* :class:`Counter` — monotone accumulator (int or float; ``inc``).
* :class:`Gauge` — last-write-wins value (``set``).
* :class:`Hist2` — log2-binned histogram (bin ``b`` holds values in
  ``[2^b, 2^(b+1))``; zeros/negatives land in the underflow bin), the same
  binning discipline the sim's FCT histogram uses, with exact sum/count so
  means stay exact.

Unlike the tracer there is no off switch: a metric update is a dict lookup
and an add under the GIL, and every call site sits at a host boundary that
runs tens-to-hundreds of times per solve — the cost is unmeasurable
against an XLA dispatch.  ``snapshot()`` serializes everything;
``reset_metrics()`` zeroes the registry (benches bracket a run with both).

Event bus
---------
``subscribe(fn)`` / ``emit(name, **attrs)`` is the minimal fan-out that
lets process-wide event sources decouple from their consumers.  The
canonical producer is ``repro.analysis.retrace``'s ``jax.monitoring``
listener, which forwards every XLA ``backend_compile`` event here; every
``emit`` increments the counter ``event/{name}`` (so compile counts fold
into metric snapshots for free) and — when tracing is enabled — records a
trace instant, so compiles show up on the Perfetto timeline exactly where
they stalled the sweep.  ``track_compiles()`` is a bus subscriber.
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable

from . import trace as _trace

__all__ = [
    "Counter",
    "Gauge",
    "Hist2",
    "counter",
    "emit",
    "gauge",
    "hist",
    "reset_metrics",
    "snapshot",
    "subscribe",
    "unsubscribe",
]

_LOCK = threading.Lock()


class Counter:
    """Monotone accumulator; ``inc`` accepts ints or floats (seconds)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: float = 0

    def inc(self, n: float = 1) -> None:
        with _LOCK:
            self.value += n

    def to_value(self) -> float:
        return self.value


class Gauge:
    """Last-write-wins sample (e.g. the most recent MW alpha)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str) -> None:
        self.name = name
        self.value: float | None = None

    def set(self, v: float) -> None:
        with _LOCK:
            self.value = float(v)

    def to_value(self) -> float | None:
        return self.value


#: Underflow bin index for values <= 0 (no finite log2).
_UNDERFLOW = -1


class Hist2:
    """Log2-binned histogram with exact sum/count.

    ``observe(v)`` increments bin ``floor(log2(v))`` (values in
    ``[2^b, 2^(b+1))`` share bin ``b``); ``v <= 0`` lands in the underflow
    bin.  Bins are a sparse dict, so microsecond stalls and 200-second
    builds coexist without preallocating a range.
    """

    __slots__ = ("name", "bins", "total", "count")

    def __init__(self, name: str) -> None:
        self.name = name
        self.bins: dict[int, int] = {}
        self.total: float = 0.0
        self.count: int = 0

    def observe(self, v: float) -> None:
        v = float(v)
        b = math.floor(math.log2(v)) if v > 0 else _UNDERFLOW
        with _LOCK:
            self.bins[b] = self.bins.get(b, 0) + 1
            self.total += v
            self.count += 1

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def to_value(self) -> dict:
        return {
            "bins": {str(k): v for k, v in sorted(self.bins.items())},
            "sum": self.total,
            "count": self.count,
            "mean": self.mean(),
        }


_REG: dict[str, Any] = {}


def _get(name: str, cls):
    with _LOCK:
        m = _REG.get(name)
        if m is None:
            m = cls(name)
            _REG[name] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r} is a {type(m).__name__}, "
                f"not a {cls.__name__}"
            )
        return m


def counter(name: str) -> Counter:
    """The process-wide counter registered under ``name`` (created on
    first use)."""
    return _get(name, Counter)


def gauge(name: str) -> Gauge:
    return _get(name, Gauge)


def hist(name: str) -> Hist2:
    return _get(name, Hist2)


def snapshot() -> dict:
    """``{name: value}`` for every registered metric (hists expand to
    their bin dict + exact sum/count/mean)."""
    with _LOCK:
        items = list(_REG.items())
    return {name: m.to_value() for name, m in sorted(items)}


def reset_metrics() -> None:
    """Drop every registered metric (benches bracket runs with this)."""
    with _LOCK:
        _REG.clear()


# --------------------------------------------------------------------------- #
# event bus
# --------------------------------------------------------------------------- #

_SUBSCRIBERS: list[Callable[..., None]] = []


def subscribe(fn: Callable[..., None]) -> None:
    """Register ``fn(name, **attrs)`` to receive every :func:`emit`."""
    with _LOCK:
        _SUBSCRIBERS.append(fn)


def unsubscribe(fn: Callable[..., None]) -> None:
    with _LOCK:
        _SUBSCRIBERS.remove(fn)


def emit(name: str, **attrs: Any) -> None:
    """Publish one event: bump ``event/{name}``, notify subscribers, and —
    when tracing — drop an instant on the timeline."""
    counter(f"event/{name}").inc()
    _trace.instant(name, **attrs)
    with _LOCK:
        subs = list(_SUBSCRIBERS)
    for fn in subs:
        fn(name, **attrs)
