"""`repro_torch.obs` — host-boundary tracing and solver telemetry.

The port's copy of ``repro.obs``:

* :mod:`repro_torch.obs.trace` — hierarchical host-boundary spans with JSONL
  and Chrome-trace (Perfetto) export, gated by ``REPRO_TRACE``.
* :mod:`repro_torch.obs.metrics` — counters / gauges / log2-histograms, and
  the event bus the kernels' ``nvcc`` builds publish into.
* :mod:`repro_torch.obs.bench` — the benchmark timing / memory helpers
  (``Timer(device=...)`` synchronizes the card before each clock read).

``python -m repro_torch.obs report`` summarizes saved trace JSONL;
``python -m repro_torch.obs smoke [--device cpu|cuda]`` runs a traced toy
solve and checks it against an untraced one.

Spans sit only at host boundaries (window edges, shard edges), never between
a kernel launch and the work that feeds it, so a traced run launches the same
kernels on the same inputs as an untraced one.  This package imports only the
stdlib and ``repro_torch.env`` (``bench`` imports torch only when a device
is given).
"""

from __future__ import annotations

from .bench import (
    Timer,
    count_compiles,
    perf_record,
    ru_maxrss_mb,
    timed,
    timed_peak,
)
from .metrics import (
    Counter,
    Gauge,
    Hist2,
    counter,
    emit,
    gauge,
    hist,
    reset_metrics,
    snapshot,
    subscribe,
    unsubscribe,
)
from .trace import (
    Span,
    TRACE_OUT,
    chrome_trace_events,
    counter_event,
    get_events,
    get_spans,
    instant,
    reset_trace,
    set_trace,
    span,
    trace_enabled,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)

__all__ = [
    "Counter",
    "Gauge",
    "Hist2",
    "Span",
    "TRACE_OUT",
    "Timer",
    "chrome_trace_events",
    "count_compiles",
    "counter",
    "counter_event",
    "emit",
    "gauge",
    "get_events",
    "get_spans",
    "hist",
    "instant",
    "perf_record",
    "reset_metrics",
    "reset_trace",
    "ru_maxrss_mb",
    "set_trace",
    "snapshot",
    "span",
    "subscribe",
    "timed",
    "timed_peak",
    "trace_enabled",
    "unsubscribe",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
]
