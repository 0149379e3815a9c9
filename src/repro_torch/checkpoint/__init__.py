"""Checkpointing: atomic, keep-k saves of a tree of tensors."""
from . import store

__all__ = ["store"]
