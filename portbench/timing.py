"""Host-clock timing and the benchmark's own spans.

``Timer`` is a frozen copy of the program's ``obs.bench.Timer(device=)``:
it synchronises the card before each clock read, so the time covers the
work the timed code queued on it.  ``Spans`` records the benchmark's spans
around its calls into the program's layers; each span is also a profiler
label (``record_function``), which names the host's work in a device trace.
Spans are recorded only when tracing: an untraced run adds no
synchronisation.
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["Spans", "Timer"]


def _syncer(device):
    if device is None:
        return lambda: None
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return lambda: None
    return lambda: torch.cuda.synchronize(dev)


class Timer:
    """``with Timer() as t: ...`` leaves the elapsed seconds in ``t.dt``;
    ``Timer(device="cuda")`` synchronises the card before each read."""

    def __init__(self, device=None) -> None:
        self._sync = _syncer(device)

    def __enter__(self) -> "Timer":
        self._sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a) -> None:
        self._sync()
        self.dt = time.perf_counter() - self.t0


class Spans:
    """Seconds and counts of the benchmark's named spans."""

    def __init__(self, device=None, enabled: bool = False) -> None:
        self.device = device
        self.enabled = enabled
        self.seconds: dict[str, float] = {}
        self.count: dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        from torch.profiler import record_function

        with record_function(f"portbench/{name}"), Timer(self.device) as t:
            yield
        self.seconds[name] = self.seconds.get(name, 0.0) + t.dt
        self.count[name] = self.count.get(name, 0) + 1

    @contextlib.contextmanager
    def around(self, module, attr: str, name: str):
        """Put a span around every call of ``module.attr`` inside the block
        (nothing is replaced when tracing is off)."""
        if not self.enabled:
            yield
            return
        plain = getattr(module, attr)

        def wrapped(*a, **kw):
            with self.span(name):
                return plain(*a, **kw)

        setattr(module, attr, wrapped)
        try:
            yield
        finally:
            setattr(module, attr, plain)
