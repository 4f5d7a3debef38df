"""Atomic, checksummed checkpoints in the reference's on-disk format."""
from .checkpoint import (FORMAT_VERSION, CheckpointError, Checkpointer, tree_flatten,
                         tree_unflatten)

__all__ = ["CheckpointError", "Checkpointer", "FORMAT_VERSION", "tree_flatten",
           "tree_unflatten"]
