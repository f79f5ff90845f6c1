"""`repro_torch.obs` — host spans on the device trace's clock, and solver
telemetry.

* :mod:`repro_torch.obs.trace` — hierarchical host spans, gated by
  ``REPRO_TRACE``.  A live span is also a ``torch.profiler`` label
  ``repro/<name>``, so a profiled run shows each span in the same Kineto
  trace as the device operations, on the same clock; the spans also
  export to JSONL and Chrome-trace (Perfetto) files.
* :mod:`repro_torch.obs.metrics` — counters and gauges, and the event bus
  the kernels' ``nvcc`` builds publish into.
* :mod:`repro_torch.obs.bench` — the timing / memory helpers
  (``Timer(device=...)`` synchronizes the card before each clock read).

``python -m repro_torch.obs report`` summarizes saved trace JSONL;
``python -m repro_torch.obs smoke [--device cpu|cuda]`` runs a traced toy
solve and checks it against an untraced one.

No span or counter synchronises the device: spans time the host, device
time comes from the profiler's trace, and a traced run launches the same
kernels on the same inputs as an untraced one (INVARIANTS.md OB-1).  This
package imports only the stdlib and ``repro_torch.env``; torch is imported
when the first span goes live (``bench``: when a device is given).
"""

from __future__ import annotations

from .bench import (
    Timer,
    count_compiles,
    ru_maxrss_mb,
    timed,
    timed_peak,
)
from .metrics import (
    Counter,
    Gauge,
    counter,
    emit,
    gauge,
    reset_metrics,
    snapshot,
    subscribe,
    unsubscribe,
)
from .trace import (
    Span,
    TRACE_OUT,
    annotate,
    chrome_trace_events,
    counter_event,
    get_events,
    get_spans,
    instant,
    reset_trace,
    set_trace,
    span,
    spanned,
    trace_enabled,
    validate_chrome_trace,
    write_chrome_trace,
    write_jsonl,
)

__all__ = [
    "Counter",
    "Gauge",
    "Span",
    "TRACE_OUT",
    "Timer",
    "annotate",
    "chrome_trace_events",
    "count_compiles",
    "counter",
    "counter_event",
    "emit",
    "gauge",
    "get_events",
    "get_spans",
    "instant",
    "reset_metrics",
    "reset_trace",
    "ru_maxrss_mb",
    "set_trace",
    "snapshot",
    "span",
    "spanned",
    "subscribe",
    "timed",
    "timed_peak",
    "trace_enabled",
    "unsubscribe",
    "validate_chrome_trace",
    "write_chrome_trace",
    "write_jsonl",
]
