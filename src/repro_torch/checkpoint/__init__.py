"""Atomic, asynchronous checkpoints of trees of tensors (format 2 of
``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (CheckpointManager, Rows, restore,
                                           save)

__all__ = ["CheckpointManager", "Rows", "restore", "save"]
