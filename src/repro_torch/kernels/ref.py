"""Plain PyTorch versions of the hand-written kernels (the ground truth).

Each kernel wrapper in this package runs its plain version here when it is
given CPU tensors; ``chip_smoke.py`` holds every kernel against its plain
version on the card.
"""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """C = A @ B computed in float32, returned in ``promote_types(a, b)``."""
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    return (a.float() @ b.float()).to(out_dtype)
