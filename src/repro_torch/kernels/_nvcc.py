"""Build and load the port's hand-written CUDA kernels.

Every kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
The build happens at a kernel's first CUDA launch (never at import, so
machines without a toolkit import the package), lands in ``_build/`` under
a name keyed by the hash of the source and the flags, and is reused while
that hash holds.  Headers under ``csrc/`` (``*.cuh``) are part of every
source's hash.

``kernel_op`` is the glue every kernel wrapper shares on the other side: it
makes a kernel's entry a ``torch.ops.repro_torch`` operator, so that
dispatch modes (``FakeTensorMode``, ``FlopCounterMode``,
``launch.hlo_costs``) see the kernel as one operator with a fake
implementation, a flop formula and the bytes it keeps on chip, where a
``ctypes`` launch through ``data_ptr()`` is invisible to them.
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
from typing import Any, Callable

import torch
from torch.utils.flop_counter import register_flop_formula

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
# Bytes of shared memory one block may use on the H100 (the sources'
# poas_sm90::kSmemLimit).
SMEM_LIMIT = 232_448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[Path, ctypes.CDLL] = {}


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
                           "CUDA kernels cannot be built")
    return path


def source_digest(source: Path) -> str:
    """Hash of ``source``, the headers beside it and the flags: the key of
    its built library."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    return hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()
                          ).hexdigest()[:16]


def build(source: Path) -> BuildInfo:
    """Compile ``source`` into ``_build/`` unless this exact source was
    built already.  Raises ``RuntimeError`` with nvcc's output on failure."""
    path = BUILD_DIR / f"{source.stem}-{source_digest(source)}.so"
    if path.exists():
        return BuildInfo(path, 0.0, "")
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)   # atomic: a concurrent build never sees half a file
    return BuildInfo(path, time.perf_counter() - t0,
                     proc.stdout + proc.stderr)


def load(source: Path, argtypes: dict[str, list]) -> ctypes.CDLL:
    """The library built from ``source``, built and loaded once per process;
    each entry point of ``argtypes`` gets its argument types and an ``int``
    (``cudaError_t``) result."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source).path))
            for name, types in argtypes.items():
                fn = getattr(lib, name)
                fn.argtypes = types
                fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def aligned_rows(x):
    """``x`` if every row (last dim) starts on 16 bytes, as the kernels'
    16-byte ``cp.async`` copies need, else a copy whose rows are padded to
    16 bytes, returned as a view of ``x``'s shape.  Dims of size 1 are
    not walked, so their strides do not matter."""
    step = 16 // x.element_size()
    if x.data_ptr() % 16 == 0 and all(
            st % step == 0 for st, n in zip(x.stride()[:-1], x.shape[:-1])
            if n > 1):
        return x
    last = x.shape[-1]
    buf = x.new_zeros((*x.shape[:-1], last + (-last) % step))
    buf[..., :last] = x
    return buf[..., :last]


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError {err}")


@dataclasses.dataclass(frozen=True)
class KernelOp:
    """What ``launch.hlo_costs`` reads of a kernel operator besides its
    own inputs and outputs (the bytes it moves): ``loop_bytes(*args)``,
    the bytes the plain version moves that the kernel keeps on chip (K2's
    scores and probabilities), or None."""
    name: str
    loop_bytes: Callable[..., int] | None = None


KERNEL_OPS: dict[Any, KernelOp] = {}


def kernel_op(name: str, impl: Callable, *, fake: Callable,
              flops: Callable[..., int],
              loop_bytes: Callable[..., int] | None = None):
    """Register ``impl`` (its annotations give the schema) as the operator
    ``torch.ops.repro_torch.<name>``: ``impl`` runs for real tensors (the
    plain version on the CPU, the launch on the card, a raise elsewhere),
    ``fake`` gives the outputs' shapes and dtypes (fake and ``meta``
    tensors), ``flops(*args)`` the operations, at the arguments' shapes
    (tensors as their shapes), for ``FlopCounterMode``.  Returns the
    operator."""
    torch.library.custom_op(f"repro_torch::{name}", impl,
                            mutates_args=()).register_fake(fake)
    op = getattr(torch.ops.repro_torch, name)

    def formula(*args, out_shape=None, **kwargs):
        return flops(*args, **kwargs)

    register_flop_formula(op)(formula)
    KERNEL_OPS[op] = KernelOp(name, loop_bytes)
    return op
