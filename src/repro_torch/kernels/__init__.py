"""Hand-written Hopper kernels of the port, each beside its plain version.

=========================  ==============================  =====================
wrapper                    CUDA source (csrc/)             replaces (repro/...)
=========================  ==============================  =====================
``congestion.congestion``  ``congestion.cu``               ``kernels/congestion.py``
``minplus.minplus``        ``minplus.cu``                  ``kernels/minplus.py``
``admission.admission``    ``admission.cu``                ``kernels/admission.py``
``power.matmul``           ``matmul.cu``                   ``kernels/power.py``
=========================  ==============================  =====================

A wrapper launches its kernel on CUDA tensors and uses its plain torch
version on CPU tensors; it never falls back from one to the other.  The
kernels are compiled with ``nvcc`` at first use (``_build``), never at
import.  Each wrapper module counts its kernel launches (``launch_counts``).
"""

from __future__ import annotations

from . import admission, congestion, minplus, ops, power

__all__ = ["admission", "congestion", "minplus", "ops", "power",
           "launch_counts", "reset_launch_counts"]

#: counter name -> (wrapper module, attribute holding its launch count)
_COUNTERS = {
    "congestion": (congestion, "launches"),
    "congestion_batch": (congestion, "batch_launches"),
    "minplus": (minplus, "launches"),
    "admission": (admission, "launches"),
    "matmul": (power, "launches"),
}


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since import or the last reset
    (``congestion`` counts single-incidence calls, ``congestion_batch``
    stacked ones)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
