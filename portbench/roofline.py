"""The congestion product's work and the H100's published peaks.

Every backend of the congestion product (the dense kernel, a gather, a CSR
kernel) computes the same thing from the same routing table, so its work is
counted from the table's sparse incidence, never from the matrix one
implementation reads.  One call over a routing table of ``P`` paths, ``S``
directed slots and ``H`` path-hop entries (the sum of the paths' hop
counts) reads each entry once as a 4-byte slot index and each rate once,
and writes each load once; the fused form (loads and path costs, as in the
MW solver) also reads each price and writes each cost once.  Each entry is
one addition for the loads and, in the fused form, one for the costs.

The peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit:
3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor cores.
"""

from __future__ import annotations

__all__ = ["FP32_FLOPS_PER_S", "HBM_BYTES_PER_S", "Work", "bound_seconds",
           "call_work", "share_percent"]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


class Work:
    """Bytes and operations, summed over calls."""

    def __init__(self) -> None:
        self.bytes = 0.0
        self.flops = 0.0

    def add(self, other: tuple, calls: float = 1.0) -> None:
        self.bytes += calls * other[0]
        self.flops += calls * other[1]


def call_work(hops: int, n_paths: int, n_slots: int,
              fused: bool = True) -> tuple:
    """(bytes, flops) of one congestion call over one routing table."""
    byt = 4.0 * hops + 4.0 * n_paths + 4.0 * n_slots
    if fused:
        return byt + 4.0 * n_slots + 4.0 * n_paths, 2.0 * hops
    return byt, 1.0 * hops


def bound_seconds(work: Work) -> float:
    """The least time the card could take: the larger of bytes over the HBM
    rate and operations over the float32 rate."""
    return max(work.bytes / HBM_BYTES_PER_S, work.flops / FP32_FLOPS_PER_S)


def share_percent(work: Work, kernel_s: float):
    """The kernels' share of their roofline, in percent; ``None`` when the
    trace holds no congestion kernel time or the run did no such work."""
    if kernel_s <= 0.0 or work.bytes <= 0.0:
        return None
    return 100.0 * bound_seconds(work) / kernel_s
