"""STUB modality frontends: the transformer backbone is the assigned
architecture; the modality encoder stands in as precomputed embeddings.

The port of ``repro/models/frontends.py``.  The stubs draw from a
``torch.Generator`` (the reference draws from ``jax.random``), so the two
packages' stub embeddings differ; tests hand both sides the same
embeddings.
"""

from __future__ import annotations

import torch

__all__ = ["N_VIT_PATCHES", "encodec_stub_embeddings", "vit_stub_embeddings"]

N_VIT_PATCHES = 256  # InternVL2 448x448 @ pixel-shuffle -> 256 tokens


def vit_stub_embeddings(gen: torch.Generator, batch: int, d_model: int,
                        n_patches: int = N_VIT_PATCHES,
                        dtype=torch.bfloat16, device="cuda") -> torch.Tensor:
    """Stand-in for InternViT patch embeddings: (B, P, D)."""
    return torch.randn((batch, n_patches, d_model), generator=gen,
                       dtype=dtype, device=device) * 0.02


def encodec_stub_embeddings(gen: torch.Generator, batch: int, seq: int,
                            d_model: int, dtype=torch.bfloat16,
                            device="cuda") -> torch.Tensor:
    """Stand-in for summed EnCodec codebook embeddings: (B, S, D)."""
    return torch.randn((batch, seq, d_model), generator=gen, dtype=dtype,
                       device=device) * 0.02
