"""Collective cost models over a physical fabric.

Standard alpha-beta models, with the beta term scaled by the fabric
embedding's efficiency (``repro_torch.fabric.embedding``).  The port's copy
of ``repro/fabric/collectives.py``: pure Python, and every cost equals the
reference's bit for bit.

All sizes in bytes, bandwidths in bytes/second, times in seconds.
"""

from __future__ import annotations

import dataclasses

__all__ = ["LinkSpec", "CollectiveCost", "ring_all_reduce", "ring_all_gather",
           "ring_reduce_scatter", "all_to_all", "tree_all_reduce",
           "bytes_on_wire"]


@dataclasses.dataclass
class LinkSpec:
    # a model parameter (the reference's default), not a measured rate
    bandwidth: float = 50e9
    latency: float = 1e-6
    efficiency: float = 1.0  # fabric embedding efficiency (<= 1)

    @property
    def effective_bw(self) -> float:
        return self.bandwidth * self.efficiency


@dataclasses.dataclass
class CollectiveCost:
    time: float
    wire_bytes_per_device: float
    steps: int

    def __add__(self, other: "CollectiveCost") -> "CollectiveCost":
        return CollectiveCost(
            self.time + other.time,
            self.wire_bytes_per_device + other.wire_bytes_per_device,
            self.steps + other.steps,
        )


def ring_all_reduce(size: int, n: int, link: LinkSpec) -> CollectiveCost:
    """Bandwidth-optimal ring: 2(n-1)/n * size per device on the wire."""
    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    wire = 2.0 * size * (n - 1) / n
    steps = 2 * (n - 1)
    return CollectiveCost(wire / link.effective_bw + steps * link.latency, wire, steps)


def ring_reduce_scatter(size: int, n: int, link: LinkSpec) -> CollectiveCost:
    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    wire = size * (n - 1) / n
    return CollectiveCost(wire / link.effective_bw + (n - 1) * link.latency, wire, n - 1)


def ring_all_gather(size: int, n: int, link: LinkSpec) -> CollectiveCost:
    """``size`` is the OUTPUT (gathered) size."""
    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    wire = size * (n - 1) / n
    return CollectiveCost(wire / link.effective_bw + (n - 1) * link.latency, wire, n - 1)


def all_to_all(size: int, n: int, link: LinkSpec) -> CollectiveCost:
    """``size`` = per-device resident bytes; (n-1)/n of them leave the chip."""
    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    wire = size * (n - 1) / n
    return CollectiveCost(wire / link.effective_bw + (n - 1) * link.latency, wire, n - 1)


def tree_all_reduce(size: int, n: int, link: LinkSpec) -> CollectiveCost:
    """Latency-optimal binary-tree reduce+broadcast: 2 log2(n) steps of size."""
    import math

    if n <= 1:
        return CollectiveCost(0.0, 0.0, 0)
    steps = 2 * math.ceil(math.log2(n))
    wire = 2.0 * size
    return CollectiveCost(wire / link.effective_bw + steps * link.latency, wire, steps)


def bytes_on_wire(kind: str, size: int, n: int) -> float:
    """Per-device wire bytes for a collective op (used by the HLO parser).

    ``size`` is the per-device operand size reported in the HLO (for
    all-gather: the OUTPUT size)."""
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return size * (n - 1) / n
    if kind == "collective-permute":
        return float(size)
    raise ValueError(kind)
