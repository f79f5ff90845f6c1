"""Profiler labels around the program's congestion product.

Every backend of the congestion product, the dense kernel, a gather of
PyTorch index operations or any other, is reached through a closure that
one of the factories of ``repro_torch.core.flow`` builds.  In a traced run
each closure the factories return is wrapped in the profiler label
``portbench/kernels.congestion``; ``devtrace`` then counts the device
operations launched inside that label, whatever their names.  The labels
are put in place before set-up (so closures built there carry them too)
and taken out after the window.
"""

from __future__ import annotations

import contextlib
import sys

__all__ = ["CONGESTION", "FACTORIES", "congestion_labels"]

#: the label, as ``devtrace`` reads it (the ``portbench/`` prefix dropped)
CONGESTION = "kernels.congestion"
FACTORIES = ("make_congestion_fn", "make_congestion_fn_batch",
             "make_loads_fn_batch")


def _labelled(factory):
    from torch.profiler import record_function

    def make(*a, **kw):
        fn = factory(*a, **kw)

        def call(*x, **y):
            with record_function(f"portbench/{CONGESTION}"):
                return fn(*x, **y)

        return call

    return make


@contextlib.contextmanager
def congestion_labels(enabled: bool = True):
    """Wrap the factories wherever the program's modules hold them."""
    if not enabled:
        yield
        return
    from repro_torch.core import flow

    plain = {name: getattr(flow, name) for name in FACTORIES}
    wrapped = {name: _labelled(f) for name, f in plain.items()}
    patched = []
    for modname, mod in list(sys.modules.items()):
        if mod is None or modname.split(".")[0] != "repro_torch":
            continue
        for name, f in plain.items():
            if getattr(mod, name, None) is f:
                setattr(mod, name, wrapped[name])
                patched.append((mod, name, f))
    try:
        yield
    finally:
        for mod, name, f in patched:
            setattr(mod, name, f)
