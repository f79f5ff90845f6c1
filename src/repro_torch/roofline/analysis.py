"""Roofline terms of a traced dry-run cell.

The port of ``repro/roofline/analysis.py``.  Three terms per (arch x shape
x mesh), all in seconds:

    compute    = FLOPs_per_device / peak_flops
    memory     = HBM_bytes_per_device / hbm_bw
    collective = per_device_wire_bytes / link_bw

The per-device FLOPs, bytes and collectives come from ``op_stats`` (the
ops rank 0 executes on its shards).  Collective bytes apply per-op
wire-byte models (ring algorithms), the reference's five:

    all-reduce       2 S (n-1)/n        (S = operand bytes)
    all-gather       G (n-1)/n          (G = gathered output bytes)
    reduce-scatter   R (n-1)            (R = scattered output bytes)
    all-to-all       S (n-1)/n
    collective-permute  S

The *fabric-adjusted* collective term divides by the Jellyfish/fat-tree ring
embedding efficiency for the cross-pod share of the traffic (see
``repro_torch.fabric``).  The reference also parses collectives out of HLO
text (``parse_collectives``); the port has no HLO and records them as
DTensor emits them (``op_stats.OpCounter``).

Hardware constants: the NVIDIA H100 SXM 80GB at 700 W, from its data
sheet, not measured: 989e12 dense bf16 FLOP/s, 3.35e12 B/s of HBM3, and
one 400 Gb/s NDR InfiniBand port a card (50e9 B/s).  A 16-wide mesh axis
spans two 8-card nodes, so every axis of the production mesh crosses
nodes and the port's link rate is the network's, not NVLink's.
"""

from __future__ import annotations

import dataclasses

__all__ = ["HW", "CollectiveOp", "collective_wire_bytes", "roofline_terms"]


@dataclasses.dataclass(frozen=True)
class HW:
    # data sheet, H100 SXM 80GB (700 W): dense bf16 tensor-core peak
    peak_flops: float = 989e12
    # data sheet, H100 SXM 80GB: HBM3 bandwidth
    hbm_bw: float = 3.35e12
    # data sheet: one 400 Gb/s NDR InfiniBand port per card
    link_bw: float = 50e9


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    count: int = 1

    def wire_bytes(self) -> float:
        s, n = self.result_bytes, self.group_size
        if n <= 1:
            return 0.0
        if self.kind == "all-reduce":
            return 2.0 * s * (n - 1) / n
        if self.kind == "all-gather":
            return s * (n - 1) / n
        if self.kind == "reduce-scatter":
            return float(s * (n - 1))
        if self.kind == "all-to-all":
            return s * (n - 1) / n
        if self.kind == "collective-permute":
            return float(s)
        return 0.0


def collective_wire_bytes(
    ops: list[CollectiveOp], loop_multiplier: float = 1.0
) -> float:
    return sum(op.wire_bytes() * op.count for op in ops) * loop_multiplier


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    hw: HW = HW(),
    fabric_efficiency: float = 1.0,
) -> dict:
    compute = flops_per_device / hw.peak_flops
    memory = bytes_per_device / hw.hbm_bw
    coll = wire_bytes_per_device / (hw.link_bw * fabric_efficiency)
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", coll),
        key=lambda kv: kv[1],
    )[0]
    total = max(compute, memory, coll)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": coll,
        "dominant": dominant,
        "bound_fraction": {
            "compute": compute / total if total else 0.0,
            "memory": memory / total if total else 0.0,
            "collective": coll / total if total else 0.0,
        },
    }
