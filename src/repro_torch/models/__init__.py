"""Architecture zoo: one API over dense GQA / MoE / RWKV-6 / RG-LRU.

The port of ``repro/models``: ``LM`` (an ``nn.Module``) and the reference's
public functions over it.  Entry points default to ``device="cuda"``.
"""

from .transformer import (
    LM,
    decode_step,
    init_cache,
    init_params,
    layer_kinds,
    loss_fn,
    prefill,
)

__all__ = ["LM", "decode_step", "init_cache", "init_params", "layer_kinds",
           "loss_fn", "prefill"]
