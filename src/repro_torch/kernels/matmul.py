"""K1: the hand-written Hopper GEMM — build, load, wrapper, launch count.

Replaces ``src/repro/kernels/matmul.py::matmul_pallas`` (the hgemms
per-device compute unit) and the "interpret off-TPU" dispatch of
``src/repro/kernels/ops.py``.  The kernel is ``csrc/matmul.cu`` (CUDA C++
for ``sm_90a``; its header says what bounds it on an H100 and what the
design does about it).

Dispatch rule: CPU tensors take the plain version (``ref.matmul_ref``);
CUDA tensors launch the kernel or raise — there is no fallback.

The kernel is compiled with ``nvcc`` into ``_build/`` at its first CUDA
launch (never at import, so machines without a toolkit can import this
module), loaded with ``ctypes``, and rebuilt whenever the source's hash
changes.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from .ref import matmul_ref

SOURCE = Path(__file__).parent / "csrc" / "matmul.cu"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Rows of C per thread block (``BM`` in csrc/matmul.cu); with grid.y below
# 2**16 it bounds M.
TILE_M = 128
MAX_M = 65535 * TILE_M

_ENTRY = {torch.float32: "poas_matmul_f32",
          torch.bfloat16: "poas_matmul_bf16"}

_load_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float     # 0.0 when the library for this source already existed
    log: str           # nvcc's output (ptxas register/shared-memory report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                           "CUDA matmul kernel cannot be built")
    return path


def build() -> BuildInfo:
    """Compile ``csrc/matmul.cu`` into ``_build/`` unless this exact source
    was built already.  Raises ``RuntimeError`` with nvcc's output on
    failure."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    path = BUILD_DIR / f"matmul-{digest}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent build never sees half a file
    return BuildInfo(path, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


def _library() -> ctypes.CDLL:
    global _lib
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build().path))
            for name in _ENTRY.values():
                fn = getattr(lib, name)
                fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 6 \
                    + [ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B in ``promote_types(a, b)`` with float32 accumulation.

    Takes 2-D float32/bfloat16 operands (mixed inputs are cast to the
    promoted type first) with unit column stride.  CPU tensors run the plain
    version; CUDA tensors launch the kernel on the current stream without
    synchronising, and raise if the kernel cannot be built or launched.
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
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: unsupported device {a.device}")

    m, k = a.shape
    n = b.shape[1]
    if m > MAX_M:
        raise ValueError(f"matmul: m={m} exceeds the kernel's grid limit "
                         f"{MAX_M}")
    c = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = getattr(lib, _ENTRY[out_dtype])(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k,
            a.stride(0), b.stride(0), c.stride(0), stream)
    if err:
        raise RuntimeError(f"matmul: CUDA kernel launch failed with "
                           f"cudaError {err}")
    with _count_lock:
        matmul.launches += 1
    return c


matmul.launches = 0
