"""Atomic, asynchronous checkpoints of trees of tensors (format 2 of
``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import CheckpointManager, restore, save

__all__ = ["CheckpointManager", "restore", "save"]
