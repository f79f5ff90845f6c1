"""Arithmetic shared by the metric readers in ``endtoend/`` and ``metrics/``.

Each reader file names one metric and calls one of these; a helper returns
``None`` when the run holds nothing to read.
"""

from __future__ import annotations

from portbench import labels, roofline

__all__ = ["congestion_roofline", "idle_share", "per_unit", "rate"]


def rate(run):
    """The cell's work completed in the window over the window's whole
    time, to the end of its last unit."""
    return run.work / run.window_s if run.window_s > 0 else None


def per_unit(run, key: str, span: bool = False, per: str = "units"):
    """A layer reading (a span's seconds when ``span``) over a count."""
    layer = run.layer
    total = layer.get("spans", {}).get(key) if span else layer.get(key)
    n = layer.get(per) if per != "units" else run.units
    if total is None or not n:
        return None
    return total / n


def congestion_roofline(run):
    """The congestion product's share of the roofline of the sparse work
    the run's solves needed, in percent: its time is that of every device
    operation launched inside the program's congestion closures
    (``labels.py``), whatever the backend."""
    if run.trace is None or "congestion_work" not in run.layer:
        return None
    return roofline.share_percent(run.layer["congestion_work"],
                                  run.trace.labelled.get(labels.CONGESTION, 0.0))


def idle_share(run):
    """The device's idle share of the traced window, in percent."""
    if run.trace is None or run.trace.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.window_s)
