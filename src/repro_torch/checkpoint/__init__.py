"""Checkpointing (the port of ``repro.checkpoint``, in its on-disk format)."""

from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
