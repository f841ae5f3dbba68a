"""Checkpointing: counterpart of `repro.ckpt`."""

from .checkpoint import CheckpointManager
__all__ = ["CheckpointManager"]
