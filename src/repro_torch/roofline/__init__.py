"""Roofline analysis of the dry run's traced cells (see analysis.py)."""

from .analysis import HW, CollectiveOp, collective_wire_bytes, roofline_terms
from .op_stats import OpCounter, OpStats

__all__ = ["HW", "CollectiveOp", "OpCounter", "OpStats",
           "collective_wire_bytes", "roofline_terms"]
