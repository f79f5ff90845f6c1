"""Compile tracer of the port: a second same-bucket run builds nothing.

The port of ``repro/analysis/retrace.py``, in the meaning it has here.  The
reference counts XLA compiles: its solvers are bucketed-shape jits, and a
silent retrace (a jit tracing again for inputs that should share a bucket)
makes a sweep 10-100x slower with nothing numerically wrong.  The port runs
eager PyTorch: it keeps no compile cache and uses neither ``torch.compile``
nor CUDA graphs.  Its only compile step is the ``nvcc`` build of the
hand-written kernels (``kernels._build.build_all``), which publishes one
``cuda/nvcc_build`` event per compiled source on the obs bus.

So RT-1 reads, on the port: a second run in the same shape bucket builds
no kernel.  Two instruments, as in the reference:

``track_compiles()``
    Context manager counting the ``nvcc`` builds made inside the block:
    ``obs.bench.count_compiles`` (one bus subscriber, not a second one).

``solver_cache_sizes()``
    ``{entry: -1}`` for every registered solver entry: eager PyTorch keeps
    no compilation cache, and ``-1`` is the value the reference itself
    gives an entry that is not a jit.  Diffing two snapshots stays
    meaningful: an entry added or removed between them shows.
"""

from __future__ import annotations

from ..obs.bench import CompileCounter, count_compiles

__all__ = [
    "CompileCounter",
    "named_solver_entries",
    "solver_cache_sizes",
    "track_compiles",
]


def named_solver_entries() -> dict:
    """``{"module.attr": function}`` for every registered solver entry
    (``kind="solver"``; dispatch wrappers are left out, as the reference
    leaves them out of its jit view)."""
    from .registry import registered_entries

    return {
        name: e.resolve()
        for name, e in registered_entries().items()
        if e.kind == "solver"
    }


def solver_cache_sizes() -> dict:
    """Compilation-cache size per solver entry: ``-1`` for each (eager
    PyTorch compiles nothing per call; see the module docstring)."""
    return {name: -1 for name in named_solver_entries()}


def track_compiles():
    """Count the kernels' ``nvcc`` builds inside the block:

        with track_compiles() as c:
            mw_concurrent_flow_batch(first)    # may build: c.count >= 0
        with track_compiles() as c:
            mw_concurrent_flow_batch(second)   # same bucket: c.count == 0

    Counts are process-wide (any thread), which is the point: a build
    behind a helper the registry does not list still shows up."""
    return count_compiles()
