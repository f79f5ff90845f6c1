"""Data pipelines (the port's copy of ``repro.data``, numpy only)."""

from .pipeline import MemmapTokens, Prefetcher, SyntheticLM, make_batches

__all__ = ["SyntheticLM", "MemmapTokens", "Prefetcher", "make_batches"]
