"""Hand-written Hopper kernels for the port's compute hot spots.

* ``matmul``          — K1, the hgemms per-device GEMM (``csrc/matmul.cu``):
                        float32 through 3xTF32 and bf16 on wgmma
* ``flash_attention`` — K2, causal / windowed GQA attention for prefill:
                        bf16 on the tensor cores
                        (``csrc/flash_attention_sm90.cu``: a TMA producer
                        and two ping-pong consumer warpgroups), float32
                        through 3xTF32 on wgmma
                        (``csrc/flash_attention_tf32x3.cu``), bf16 at other
                        head dims on the CUDA cores
                        (``csrc/flash_attention.cu``), chosen by
                        ``flash_attention.route``
* ``ssd_chunk``       — K3, the Mamba-2 SSD intra-chunk part
                        (``csrc/ssd_chunk.cu``): its products and the
                        chunk state through 3xTF32 on wgmma
* ``flash_attention_bwd`` — K2's gradient: bf16 on the tensor cores at
                        head dims up to 256, as the forward
                        (``csrc/flash_attention_bwd_sm90.cu``: two
                        warpgroups a block above 128), float32 through
                        3xTF32 (``csrc/flash_attention_bwd_tf32x3.cu``),
                        bf16 at other head dims on the CUDA cores
                        (``csrc/flash_attention_bwd.cu``), chosen by
                        ``flash_attention.route_bwd``
* ``ssd_chunk_bwd``   — K3's gradient (``csrc/ssd_chunk_bwd.cu``): 3xTF32
                        on wgmma, C·Bᵀ, dC and dB once per group
  Both are the backward of the ``torch.autograd.Function`` that K2 and K3
  run as when autograd records them.

K1, K3, the two tensor-core backward sources, K2's bf16 source and its
float32 pair share ``csrc/sm90_tf32x3.cuh``: the cp.async ring, the
128-byte swizzle, wgmma descriptors and issue, and the hi/lo TF32 split
that keeps float32 accuracy on the tensor cores; K2's float32 pair adds
``csrc/flash_tf32x3.cuh`` (64 x 64 chunks split K-major or transposed).

Each kernel has a plain PyTorch version in ``ref.py``.  A wrapper runs the
plain version on CPU tensors and the kernel on CUDA tensors, and keeps a
count of kernel launches (``matmul.launches``, ``flash_attention.launches``
with ``.launches_sm90``, ``.launches_tf32x3`` and ``.launches_simt`` per
route, ``ssd_chunk.launches``, ``flash_attention_bwd.launches`` with the
same three, ``ssd_chunk_bwd.launches``).
``_nvcc`` builds every source at its first launch.
"""
from .flash_attention import flash_attention, flash_attention_bwd
from .matmul import matmul
from .ssd_chunk import ssd_chunk, ssd_chunk_bwd
from . import ref

__all__ = ["flash_attention", "flash_attention_bwd", "matmul", "ssd_chunk",
           "ssd_chunk_bwd", "ref"]
