"""Atomic, checksummed checkpoints in the reference's on-disk format."""
from .checkpoint import FORMAT_VERSION, CheckpointError, Checkpointer

__all__ = ["CheckpointError", "Checkpointer", "FORMAT_VERSION"]
