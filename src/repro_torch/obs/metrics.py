"""Counters / gauges + the obs event bus.

Solver telemetry that a span timeline can't express: HOW MANY commodities
a delta update spliced vs re-enumerated, how far the MW alpha got per
window and why the solve stopped, how many loads products and blocking
host reads a simulated step made, which congestion backend ``auto`` chose.
All host-side Python over plain dicts: an update never touches a tensor,
so it can never perturb the device's work (INVARIANTS.md OB-1).

Metric types
------------
* :class:`Counter` — monotone accumulator (int or float; ``inc``).
* :class:`Gauge` — last-write-wins value (``set``).

Unlike the tracer there is no off switch: a metric update is a dict lookup
and an add under a lock, and every call site runs at most a few times per
solve window or per ``_run_steps`` call (a hot loop tallies locally and
adds once).  ``snapshot()`` serializes everything; ``reset_metrics()``
zeroes the registry (benches bracket a run with both).

Event bus
---------
``subscribe(fn)`` / ``emit(name, **attrs)`` is the minimal fan-out that
lets process-wide event sources decouple from their consumers.  The
canonical producer is ``kernels._build.build_all``, which publishes one
``cuda/nvcc_build`` event per compiled kernel source; every ``emit``
increments the counter ``event/{name}`` (so build counts fold into metric
snapshots for free) and — when tracing is enabled — records a trace
instant, so builds show on the timeline where they stalled the run.
``obs.bench.count_compiles`` is a bus subscriber.
"""

from __future__ import annotations

import threading
from typing import Any, Callable

from . import trace as _trace

__all__ = [
    "Counter",
    "Gauge",
    "counter",
    "emit",
    "gauge",
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


def snapshot() -> dict:
    """``{name: value}`` for every registered metric."""
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
