"""Hand-written Hopper kernels for the port's compute hot spots.

* ``matmul``          — K1, the hgemms per-device GEMM (``csrc/matmul.cu``):
                        float32 through 3xTF32 and bf16 on wgmma
* ``flash_attention`` — K2, causal / windowed GQA attention for prefill:
                        bf16 on the tensor cores
                        (``csrc/flash_attention_sm90.cu``), float32 on the
                        CUDA cores (``csrc/flash_attention.cu``), chosen by
                        ``flash_attention.route``
* ``ssd_chunk``       — K3, the Mamba-2 SSD intra-chunk part
                        (``csrc/ssd_chunk.cu``): its products and the
                        chunk state through 3xTF32 on wgmma

K1 and K3 share ``csrc/sm90_tf32x3.cuh``: the cp.async ring, the 128-byte
swizzle, wgmma descriptors and issue, and the hi/lo TF32 split that keeps
float32 accuracy on the tensor cores.

Each kernel has a plain PyTorch version in ``ref.py``.  A wrapper runs the
plain version on CPU tensors and the kernel on CUDA tensors, and keeps a
count of kernel launches (``matmul.launches``, ``flash_attention.launches``
with ``.launches_sm90`` and ``.launches_simt`` per route,
``ssd_chunk.launches``).  ``_nvcc`` builds every source at its first launch.
"""
from .flash_attention import flash_attention
from .matmul import matmul
from .ssd_chunk import ssd_chunk
from . import ref

__all__ = ["flash_attention", "matmul", "ssd_chunk", "ref"]
