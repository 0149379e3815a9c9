"""Data: the deterministic synthetic LM stream and its prefetcher."""
from .pipeline import DataConfig, Prefetcher, SyntheticLM

__all__ = ["DataConfig", "Prefetcher", "SyntheticLM"]
