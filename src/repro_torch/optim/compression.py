"""Int8 gradient compression with error feedback.

The port of ``repro/optim/compression.py``.  At scale the data-parallel
gradient all-reduce rides the inter-pod fabric, the network the paper
studies; int8 blocks with a float32 absmax scale per block of 256 cut its
bytes 4x, and error feedback keeps SGD/Adam convergence (Karimireddy et
al., 2019).  In one process the round trip is numerically what would cross
the wire.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so
the int8 blocks and scales equal the reference's on the same inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .adamw import named

__all__ = ["compress", "decompress", "ef_roundtrip", "ef_init"]

BLOCK = 256


def _pad_to_block(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return F.pad(flat, (0, pad)), pad


def compress(g: torch.Tensor):
    """g -> (int8 blocks (n, 256), float32 per-block scales (n,))."""
    flat, _ = _pad_to_block(g)
    blocks = flat.reshape(-1, BLOCK).float()
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127)
    return q.to(torch.int8), scale[:, 0]


def decompress(q: torch.Tensor, scale: torch.Tensor, shape,
               dtype=torch.float32) -> torch.Tensor:
    flat = (q.float() * scale[:, None]).reshape(-1)
    n = math.prod(shape)
    return flat[:n].reshape(shape).to(dtype)


def ef_init(grads) -> dict:
    """Zero error memory (float32) under the names of ``grads`` (a mapping,
    or a module's parameters)."""
    return {n: torch.zeros_like(g, dtype=torch.float32, requires_grad=False)
            for n, g in named(grads).items()}


@torch.no_grad()
def ef_roundtrip(grads: dict, err: dict, groups=None):
    """Error-feedback compress -> decompress of the gradients.  Returns
    (decompressed grads in their dtypes, new error memory); what would
    cross the wire is the (int8, scale) pair per block.

    ``groups`` lists the names whose tensors are compressed as one, their
    flattened values concatenated in order; by default each tensor alone.
    The reference compresses each leaf of its tree, and its per-layer
    leaves are stacked over the layers, so its blocks of 256 run across
    layers: the train step passes ``convert.reference_groups(model)`` to
    block as it does."""
    groups = groups if groups is not None else [[n] for n in grads]
    out, new_err = {}, {}
    for names in groups:
        corrected = torch.cat([(grads[n].float() + err[n]).reshape(-1)
                               for n in names])
        q, s = compress(corrected)
        deq = decompress(q, s, corrected.shape)
        for n, c, d in zip(names,
                           corrected.split([grads[n].numel() for n in names]),
                           deq.split([grads[n].numel() for n in names])):
            shape = grads[n].shape
            out[n] = d.reshape(shape).to(grads[n].dtype)
            new_err[n] = (c - d).reshape(shape)
    return out, new_err
