"""K1: the hand-written Hopper GEMM — build, load, wrapper, launch count.

Replaces ``src/repro/kernels/matmul.py::matmul_pallas`` (the hgemms
per-device compute unit) and the "interpret off-TPU" dispatch of
``src/repro/kernels/ops.py``.  The kernel is ``csrc/matmul.cu`` (CUDA C++
for ``sm_90a``; its header says what bounds it on an H100 and what the
design does about it), on the tensor cores: float32 through 3xTF32
(three TF32 wgmma per product, ``csrc/sm90_tf32x3.cuh``), bfloat16 on bf16
wgmma.

Dispatch rule: CPU tensors take the plain version (``ref.matmul_ref``);
CUDA tensors launch the kernel or raise — there is no fallback.

The kernel is compiled with ``nvcc`` into ``_build/`` at its first CUDA
launch (never at import) by ``_nvcc``, which all the port's kernels share.
The entry is the operator ``torch.ops.repro_torch.matmul``
(``_nvcc.kernel_op``): a fake implementation and 2·M·N·K operations.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _nvcc
from .ref import matmul_ref

SOURCE = _nvcc.CSRC / "matmul.cu"

# C tile of one thread block (``BM`` x ``BN`` in csrc/matmul.cu); the grid
# is 1-D, one block per tile, so the tile count is what bounds a call.
TILE_M = 128
TILE_N = 128
MAX_BLOCKS = 2**31 - 1

_ENTRY = {torch.float32: "poas_matmul_f32",
          torch.bfloat16: "poas_matmul_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]

_count_lock = threading.Lock()


def build() -> _nvcc.BuildInfo:
    """Compile ``csrc/matmul.cu`` into ``_build/`` unless this exact source
    was built already.  Raises ``RuntimeError`` with nvcc's output on
    failure."""
    return _nvcc.build(SOURCE)


def _library() -> ctypes.CDLL:
    return _nvcc.load(SOURCE, {name: _ARGTYPES for name in _ENTRY.values()})


def _check_layout(x: torch.Tensor, name: str) -> None:
    """The kernel reads rows of ``x`` at stride ``x.stride(0)`` with unit
    column stride — a row slice of a C-contiguous matrix is taken in place."""
    rows, cols = x.shape
    if cols > 1 and x.stride(1) != 1:
        raise ValueError(f"matmul: {name} needs unit column stride, got "
                         f"strides {tuple(x.stride())}")
    if rows > 1 and x.stride(0) < max(cols, 1):
        raise ValueError(f"matmul: {name} rows overlap (strides "
                         f"{tuple(x.stride())} for shape {tuple(x.shape)})")


def entry(dtype: torch.dtype) -> str:
    """The C entry point a CUDA call in ``dtype`` launches:
    ``poas_matmul_f32`` (3xTF32 on wgmma) or ``poas_matmul_bf16`` (bf16
    wgmma)."""
    return _ENTRY[dtype]


def _ld(x: torch.Tensor) -> int:
    """Row stride to pass: a one-row operand's stride is never walked."""
    return x.stride(0) if x.shape[0] > 1 else 0


def grid_blocks(m: int, n: int) -> int:
    """Thread blocks of a launch at C (m, n); raises where the grid cannot
    hold them."""
    blocks = -(-m // TILE_M) * -(-n // TILE_N)
    if blocks > MAX_BLOCKS:
        raise ValueError(f"matmul: C ({m}, {n}) needs {blocks} tiles; the "
                         f"kernel's grid takes {MAX_BLOCKS}")
    return blocks


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B in ``promote_types(a, b)`` with float32 accumulation.

    Takes 2-D float32/bfloat16 operands (mixed inputs are cast to the
    promoted type first) with unit column stride.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream without
    synchronising, and raise if the kernel cannot be built or launched.
    The kernel reads rows that start on 16 bytes; an operand whose rows do
    not is copied into one whose rows do (``_nvcc.aligned_rows``).
    """
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)} do not chain")
    if a.device != b.device:
        raise ValueError(f"matmul: operands on {a.device} and {b.device}")
    out_dtype = torch.promote_types(a.dtype, b.dtype)
    if out_dtype not in _ENTRY:
        raise TypeError(f"matmul: {a.dtype} @ {b.dtype} promotes to "
                        f"{out_dtype}; the kernel takes float32 or bfloat16")
    a, b = a.to(out_dtype), b.to(out_dtype)
    _check_layout(a, "a")
    _check_layout(b, "b")
    return torch.ops.repro_torch.matmul(a, b)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain version on the CPU, the kernel on the card."""
    out_dtype = a.dtype
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {a.device}")

    m, k = a.shape
    n = b.shape[1]
    grid_blocks(m, n)
    lib = _library()   # built, or raises, before anything is allocated
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    a, b = _nvcc.aligned_rows(a), _nvcc.aligned_rows(b)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, entry(out_dtype))(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
            _ld(a), _ld(b), c.stride(0), stream)
    _nvcc.check(err, "matmul")
    with _count_lock:
        matmul.launches += 1
    return c


matmul.launches = 0


def matmul_flops(a_shape, b_shape) -> int:
    return 2 * a_shape[0] * a_shape[1] * b_shape[1]


_nvcc.kernel_op("matmul", _launch,
                fake=lambda a, b: a.new_empty((a.shape[0], b.shape[1])),
                flops=matmul_flops)
