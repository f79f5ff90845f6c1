"""Hand-written Hopper kernels of the port, each beside its plain version.

=========================  ==============================  =====================
wrapper                    CUDA source (csrc/)             replaces (repro/...)
=========================  ==============================  =====================
``congestion.congestion``  ``congestion.cu``               ``kernels/congestion.py``
``minplus.minplus``        ``minplus.cu`` (float32)        ``kernels/minplus.py``
``minplus.minplus_hops``   ``minplus.cu`` (int16, DPX)     ``kernels/minplus.py``
``admission.admission``    ``admission.cu``                ``kernels/admission.py``
``power.matmul``           ``matmul.cu``                   ``kernels/power.py``
``fanin.fan_in_loads``     ``fanin.cu``                    none (loads-only calls)
=========================  ==============================  =====================

A wrapper launches its kernel on CUDA tensors and uses its plain torch
version on CPU tensors; it never falls back from one to the other.  The
kernels are compiled with ``nvcc`` at first use (``_build``), never at
import.  Each wrapper module counts its kernel launches (``launch_counts``)
under ``_build.COUNT_LOCK``, so launches from the build pipeline's worker
thread and the caller's thread are all counted.
"""

from __future__ import annotations

from . import _build, admission, congestion, fanin, minplus, ops, power

__all__ = ["admission", "congestion", "fanin", "minplus", "ops", "power",
           "launch_counts", "reset_launch_counts"]

#: counter name -> (wrapper module, attribute holding its launch count)
_COUNTERS = {
    "congestion": (congestion, "launches"),
    "congestion_batch": (congestion, "batch_launches"),
    "minplus": (minplus, "launches"),
    "minplus_hops": (minplus, "hops_launches"),
    "admission": (admission, "launches"),
    "matmul": (power, "launches"),
    "fan_in_loads": (fanin, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since import or the last reset
    (``congestion`` counts single-incidence calls, ``congestion_batch``
    stacked ones; ``minplus`` the float32 form, ``minplus_hops`` the int16
    form; ``fan_in_loads`` the loads-only calls of the fan-in kernel)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    with _build.COUNT_LOCK:
        for mod, attr in _COUNTERS.values():
            setattr(mod, attr, 0)
