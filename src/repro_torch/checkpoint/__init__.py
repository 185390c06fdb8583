"""Atomic, resumable checkpoints: the port of ``repro.checkpoint``."""
from .manager import CheckpointManager, flatten_tree, unflatten_tree

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_tree"]
