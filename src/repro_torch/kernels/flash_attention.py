"""K2: the hand-written Hopper flash attention — wrapper and launch count.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``.
The kernel is ``csrc/flash_attention.cu`` (CUDA C++ for ``sm_90a``; its
header says what bounds it on an H100 and what the design does about it),
built at its first CUDA launch by ``_nvcc``.

Dispatch rule: CPU tensors take the plain version
(``ref.flash_attention_ref``); CUDA tensors launch the kernel or raise —
there is no fallback.
"""
from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _nvcc
from .ref import flash_attention_ref

SOURCE = _nvcc.CSRC / "flash_attention.cu"
MAX_HEAD_DIM = 256       # the kernel's shared-memory budget at BQ = BK = 64
_ENTRY = {torch.float32: "poas_flash_f32",
          torch.bfloat16: "poas_flash_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int64] * 7
             + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 2
             + [ctypes.c_float, ctypes.c_void_p])

_count_lock = threading.Lock()


def build() -> _nvcc.BuildInfo:
    """Compile ``csrc/flash_attention.cu`` into ``_build/`` (see ``_nvcc``)."""
    return _nvcc.build(SOURCE)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, S, H, D)")
    B, _, H, Dk = q.shape
    Bk, Skv, KH, Dk2 = k.shape
    if (Bk, Skv, KH) != tuple(v.shape[:3]) or B != Bk or Dk != Dk2:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if KH == 0 or H % KH:
        raise ValueError(f"flash_attention: {H} query heads do not group "
                         f"over {KH} KV heads")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _ENTRY:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes one of float32 or "
                        f"bfloat16 for all three")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Softmax attention with f32 accumulation; (B, Sq, H, Dv) in q's dtype.

    q: (B, Sq, H, Dk); k: (B, Skv, KH, Dk); v: (B, Skv, KH, Dv), float32 or
    bfloat16, unit stride on the last dim (other strides are read as they
    are).  GQA: query head h reads KV head h // (H / KH).  ``window`` > 0
    keeps the last ``window`` keys of each query; 0 is full attention.
    CPU tensors run the plain version; CUDA tensors launch the kernel on
    the current stream without synchronising, and raise if the kernel
    cannot be built or launched.
    """
    _check(q, k, v)
    window = int(window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, Dk = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    if not (1 <= Dk <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head dims Dk={Dk}, Dv={Dv}; the "
                         f"kernel takes 1..{MAX_HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride on "
                             f"its last dim, got {tuple(x.stride())}")
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H} exceed the grid")
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, o)
                                      for s in x.stride()[:3]))
    lib = _nvcc.load(SOURCE, {name: _ARGTYPES for name in _ENTRY.values()})
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, _ENTRY[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            Skv, H, KH, Dk, Dv, strides, int(causal), window, scale, stream)
    _nvcc.check(err, "flash_attention")
    with _count_lock:
        flash_attention.launches += 1
    return o


flash_attention.launches = 0
