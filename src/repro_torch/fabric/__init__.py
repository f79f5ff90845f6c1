"""Fabric layer: the paper's interconnect as a feature of the runtime.

The port of ``repro.fabric``: collective cost models, ring and all-to-all
embeddings over the fabric, and ``FabricModel`` with its elastic delta
routing.  Entry points take ``device=`` and default to ``"cuda"``.
"""

from .collectives import (
    CollectiveCost,
    LinkSpec,
    all_to_all,
    bytes_on_wire,
    ring_all_gather,
    ring_all_reduce,
    ring_reduce_scatter,
    tree_all_reduce,
)
from .embedding import RingEmbedding, all_to_all_congestion, embed_ring
from .model import FabricModel, make_fabric

__all__ = [
    "LinkSpec", "CollectiveCost", "ring_all_reduce", "ring_all_gather",
    "ring_reduce_scatter", "all_to_all", "tree_all_reduce", "bytes_on_wire",
    "RingEmbedding", "embed_ring", "all_to_all_congestion",
    "FabricModel", "make_fabric",
]
