"""Hand-written Hopper kernels for the port's compute hot spots.

* ``matmul`` — K1, the hgemms per-device GEMM (``csrc/matmul.cu``)

Each kernel has a plain PyTorch version in ``ref.py``.  A wrapper runs the
plain version on CPU tensors and the kernel on CUDA tensors, and keeps a
count of kernel launches (``matmul.launches``).
"""
from .matmul import matmul
from . import ref

__all__ = ["matmul", "ref"]
