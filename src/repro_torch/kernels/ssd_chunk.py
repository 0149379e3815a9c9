"""K3: the hand-written Hopper Mamba-2 SSD intra-chunk kernel — wrapper and
launch count.

Replaces ``src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas``.  The kernel
is ``csrc/ssd_chunk.cu`` (CUDA C++ for ``sm_90a``; its header says what
bounds it on an H100 and what the design does about it), built at its first
CUDA launch by ``_nvcc``.

Dispatch rule: CPU tensors take the plain version (``ref.ssd_chunk_ref``);
CUDA tensors launch the kernel or raise — there is no fallback.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _nvcc
from .ref import ssd_chunk_ref

SOURCE = _nvcc.CSRC / "ssd_chunk.cu"
MAX_DIM = 128            # hp and ds: the kernel's per-thread register tiles
SMEM_LIMIT = 232_448     # bytes of shared memory one block may use (H100)
_TILE = 64               # score rows and columns per tile (TQ, TT)
_ENTRY = {torch.float32: "poas_ssd_chunk_f32",
          torch.bfloat16: "poas_ssd_chunk_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])

_count_lock = threading.Lock()


def build() -> _nvcc.BuildInfo:
    """Compile ``csrc/ssd_chunk.cu`` into ``_build/`` (see ``_nvcc``)."""
    return _nvcc.build(SOURCE)


def _smem_bytes(Q: int, hp: int, ds: int) -> int:
    return 4 * (Q + 2 * _TILE * (ds + 1) + _TILE * hp + _TILE * (_TILE + 1))


def _check(xdt, B, C, cum) -> None:
    if xdt.dim() != 5 or B.dim() != 5 or C.dim() != 5 or cum.dim() != 4:
        raise ValueError("ssd_chunk: xdt, B, C must be 5-D and cum 4-D")
    b, nc, Q, nh, _ = xdt.shape
    if tuple(B.shape) != tuple(C.shape) or tuple(B.shape[:3]) != (b, nc, Q):
        raise ValueError(f"ssd_chunk: B {tuple(B.shape)} and C "
                         f"{tuple(C.shape)} do not match xdt "
                         f"{tuple(xdt.shape)}")
    if tuple(cum.shape) != (b, nc, Q, nh):
        raise ValueError(f"ssd_chunk: cum {tuple(cum.shape)} is not "
                         f"{(b, nc, Q, nh)}")
    G = B.shape[3]
    if G == 0 or nh % G:
        raise ValueError(f"ssd_chunk: {nh} heads do not group over {G}")
    if not (xdt.device == B.device == C.device == cum.device):
        raise ValueError("ssd_chunk: inputs on different devices")
    if not (xdt.dtype == B.dtype == C.dtype) or xdt.dtype not in _ENTRY:
        raise TypeError(f"ssd_chunk: xdt, B, C are {xdt.dtype}, {B.dtype}, "
                        f"{C.dtype}; the kernel takes one of float32 or "
                        f"bfloat16 for all three")
    if cum.dtype != torch.float32:
        raise TypeError(f"ssd_chunk: cum must be float32, got {cum.dtype}")


def ssd_chunk(xdt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
              cum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Intra-chunk SSD for every (batch, chunk, head).

    xdt: (b, NC, Q, nh, hp); B, C: (b, NC, Q, G, ds); cum: (b, NC, Q, nh)
    float32.  xdt, B and C are float32 or bfloat16 with unit stride on the
    last dim (other strides are read as they are).  Returns y_intra
    (b, NC, Q, nh, hp) in xdt's dtype and states (b, NC, nh, ds, hp) in
    float32.  CPU tensors run the plain version; CUDA tensors launch the
    kernel on the current stream without synchronising, and raise if the
    kernel cannot be built or launched.
    """
    _check(xdt, B, C, cum)
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, B, C, cum)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {xdt.device}")
    b, nc, Q, nh, hp = xdt.shape
    G, ds = B.shape[3], B.shape[4]
    if not (1 <= hp <= MAX_DIM and 1 <= ds <= MAX_DIM):
        raise ValueError(f"ssd_chunk: hp={hp}, ds={ds}; the kernel takes "
                         f"1..{MAX_DIM}")
    if _smem_bytes(Q, hp, ds) > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk: chunk length Q={Q} needs more shared "
                         f"memory than a block has")
    for name, x in (("xdt", xdt), ("B", B), ("C", C)):
        if x.stride(-1) != 1:
            raise ValueError(f"ssd_chunk: {name} needs unit stride on its "
                             f"last dim, got {tuple(x.stride())}")
    if nc > 65535 or b > 65535:
        raise ValueError(f"ssd_chunk: b={b}, NC={nc} exceed the grid")
    y = torch.empty((b, nc, Q, nh, hp), dtype=xdt.dtype, device=xdt.device)
    states = torch.empty((b, nc, nh, ds, hp), dtype=torch.float32,
                         device=xdt.device)
    if y.numel() == 0:
        return y, states.zero_()
    strides = (ctypes.c_int64 * 20)(*(s for x in (xdt, B, C, cum, y)
                                      for s in x.stride()[:4]))
    lib = _nvcc.load(SOURCE, {name: _ARGTYPES for name in _ENTRY.values()})
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = getattr(lib, _ENTRY[xdt.dtype])(
            xdt.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(),
            y.data_ptr(), states.data_ptr(), b, nc, Q, nh, G, hp, ds,
            strides, stream)
    _nvcc.check(err, "ssd_chunk")
    with _count_lock:
        ssd_chunk.launches += 1
    return y, states


ssd_chunk.launches = 0
