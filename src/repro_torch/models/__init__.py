"""Model stack: configs, layers, SSM, and the Model assembly."""
from .config import ArchConfig, reduced
from .transformer import Model

__all__ = ["ArchConfig", "Model", "reduced"]
