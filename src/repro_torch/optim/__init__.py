"""Optimizers and distributed-optimization utilities.

The port of ``repro.optim``: AdamW with global-norm clipping, int8 gradient
compression with error feedback, and the learning-rate schedules, as plain
functions over a model's parameter tensors keyed by name.
"""

from .adamw import OptState, adamw_init, adamw_update, global_norm
from .compression import compress, decompress, ef_init, ef_roundtrip
from .schedules import constant, warmup_cosine

__all__ = ["OptState", "adamw_init", "adamw_update", "global_norm",
           "compress", "decompress", "ef_init", "ef_roundtrip",
           "constant", "warmup_cosine"]
