"""`repro_torch.obs` — host-boundary tracing and solver telemetry.

The port's copy of ``repro.obs`` without the benchmark helpers
(``obs/bench.py`` is not ported yet):

* :mod:`repro_torch.obs.trace` — hierarchical host-boundary spans with JSONL
  and Chrome-trace (Perfetto) export, gated by ``REPRO_TRACE``.
* :mod:`repro_torch.obs.metrics` — counters / gauges / log2-histograms.

Spans sit only at host boundaries (window edges, shard edges), never between
a kernel launch and the work that feeds it, so a traced run launches the same
kernels on the same inputs as an untraced one.  This package imports only the
stdlib and ``repro_torch.env``.
"""

from __future__ import annotations

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
    "chrome_trace_events",
    "counter",
    "counter_event",
    "emit",
    "gauge",
    "get_events",
    "get_spans",
    "hist",
    "instant",
    "reset_metrics",
    "reset_trace",
    "set_trace",
    "snapshot",
    "span",
    "subscribe",
    "trace_enabled",
    "unsubscribe",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
]
