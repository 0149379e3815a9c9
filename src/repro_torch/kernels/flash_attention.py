"""K2: the hand-written Hopper flash attention — wrappers and launch counts.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``
with three CUDA C++ kernels for ``sm_90a`` (each source's header says what
bounds it on an H100 and what its design does about it), built at their
first CUDA launch by ``_nvcc``:

* ``csrc/flash_attention_sm90.cu`` — bf16 on the tensor cores (wgmma): a
  TMA producer warpgroup and two consumer warpgroups in ping-pong on
  128-row query tiles, its K/V tile and ring depth planned here by
  ``sm90_plan(dk, dv)``; route ``"sm90"``.
* ``csrc/flash_attention_tf32x3.cu`` — float32 on the tensor cores, each
  product as three TF32 products (3xTF32, f32 accuracy for the 2e-5 gate
  that one TF32 product cannot meet), K and V streamed in 64 x 64 chunks;
  route ``"tf32x3"``.
* ``csrc/flash_attention.cu`` — IEEE f32 arithmetic on the CUDA cores, for
  bf16 at head dims the tensor-core kernel does not take; route
  ``"simt"``.  Its float32 entry is reached only by a caller that names
  ``"simt"`` (``_launch``), to time it beside ``"tf32x3"``.

``route(dtype, dk, dv)`` is the whole rule.  CPU tensors take the plain
version (``ref.flash_attention_ref``); CUDA tensors launch the kernel of
their route or raise — there is no fallback from one kernel to another.

Gradients: when autograd records the call, ``flash_attention`` runs as a
``torch.autograd.Function`` whose forward also writes each row's
log-sum-exp (an optional output of the forward kernels, null on the
serving path) and whose backward is ``flash_attention_bwd``.  It has three
kernels too, and ``route_bwd(dtype, dk, dv)`` is their rule, the same as
``route``'s:

* ``csrc/flash_attention_bwd_sm90.cu`` — bf16 on the tensor cores (every
  product on wgmma; P and dS rounded to bf16 only as MMA operands), one
  warpgroup per dK/dV block up to head dim 128 and two above; route
  ``"sm90"``.
* ``csrc/flash_attention_bwd_tf32x3.cu`` — float32 on the tensor cores,
  every product as 3xTF32 (for the 1e-4 gate), deterministic; route
  ``"tf32x3"``.
* ``csrc/flash_attention_bwd.cu`` — f32 arithmetic on the CUDA cores, for
  bf16 at other head dims; route ``"simt"``.  Its float32 entry is
  reached only by a caller that names ``"simt"`` (``_launch_bwd``).

CPU tensors take ``ref.flash_attention_bwd_ref``.  It is the gradient of
the reference model's ``flash_attention`` (``src/repro/models/layers.py:90``),
which the reference differentiates with ``jax.value_and_grad``; the Pallas
kernel has no backward.

Query row i sits at position ``q_offset + i`` (0 by default; the
reference model stack's ``q_offset``, the absolute position of q[0] in
chunked prefill) and keys at 0..Skv-1, in every entry and both plain
versions.  A row that keeps no key is 0 on both routes and in the plain
versions; the reference model stack gives it a mean of V instead (ROADMAP
C0d).

Each entry is an operator (``_nvcc.kernel_op``):
``torch.ops.repro_torch.flash_attention`` (o),
``flash_attention_lse`` (o and the rows' log-sum-exp) and
``flash_attention_bwd`` (dq, dk, dv), with fake implementations and flop
formulas over the band's kept (query, key) pairs (``band_pairs``): 2 (Dk +
Dv) a pair and query head forward, the seven products of the backward
kernels (S and dP recomputed by both of their passes) 2 (4 Dk + 3 Dv).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import _nvcc
from .ref import flash_attention_bwd_ref, flash_attention_ref

SOURCE = _nvcc.CSRC / "flash_attention.cu"
SOURCE_SM90 = _nvcc.CSRC / "flash_attention_sm90.cu"
SOURCE_BWD = _nvcc.CSRC / "flash_attention_bwd.cu"
SOURCE_BWD_SM90 = _nvcc.CSRC / "flash_attention_bwd_sm90.cu"
SOURCE_TF32X3 = _nvcc.CSRC / "flash_attention_tf32x3.cu"
SOURCE_BWD_TF32X3 = _nvcc.CSRC / "flash_attention_bwd_tf32x3.cu"
MAX_HEAD_DIM = 256       # the kernels' shared-memory budget at BQ = BK = 64
ROUTES = ("sm90", "tf32x3", "simt")
_ENTRY = {torch.float32: "poas_flash_f32",
          torch.bfloat16: "poas_flash_bf16"}
_ENTRY_SM90 = "poas_flash_sm90_bf16"
# q, k, v, o, lse (null: not written), then shapes, strides, mask, scale,
# q_offset, stream.
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 7
             + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 2
             + [ctypes.c_float, ctypes.c_int64, ctypes.c_void_p])
_ENTRIES = {n: _ARGTYPES for n in _ENTRY.values()}
# The sm90 entry takes the plan's keys a tile and stages first.
_ENTRIES_SM90 = {_ENTRY_SM90: [ctypes.c_int64] * 2 + _ARGTYPES}
_ENTRY_TF32X3 = "poas_flash_tf32x3_f32"
_ENTRIES_TF32X3 = {_ENTRY_TF32X3: _ARGTYPES,
                   "poas_flash_tf32x3_smem": [ctypes.c_int64] * 2}
_ENTRY_BWD = {torch.float32: "poas_flash_bwd_f32",
              torch.bfloat16: "poas_flash_bwd_bf16"}
# q, k, v, o, do, lse, dq, dk, dv, D (scratch), shapes, strides of
# q, k, v, o, do, mask, scale, q_offset, stream.
_ARGTYPES_BWD = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 7
                 + [ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int64] * 2
                 + [ctypes.c_float, ctypes.c_int64, ctypes.c_void_p])
_ENTRIES_BWD = {n: _ARGTYPES_BWD for n in _ENTRY_BWD.values()}
# The same arguments; dq, dk, dv in bf16.
_ENTRY_BWD_SM90 = "poas_flash_bwd_sm90_bf16"
_ENTRIES_BWD_SM90 = {_ENTRY_BWD_SM90: _ARGTYPES_BWD,
                     "poas_flash_bwd_sm90_smem": [ctypes.c_int64] * 2}
# The same arguments; float32 only, dq, dk, dv in float32.
_ENTRY_BWD_TF32X3 = "poas_flash_bwd_tf32x3_f32"
_ENTRIES_BWD_TF32X3 = {_ENTRY_BWD_TF32X3: _ARGTYPES_BWD,
                       "poas_flash_bwd_tf32x3_smem": [ctypes.c_int64] * 2}

_count_lock = threading.Lock()


def build() -> _nvcc.BuildInfo:
    """Compile ``csrc/flash_attention.cu`` into ``_build/`` (see ``_nvcc``)."""
    return _nvcc.build(SOURCE)


def build_sm90() -> _nvcc.BuildInfo:
    """Compile ``csrc/flash_attention_sm90.cu`` into ``_build/``."""
    return _nvcc.build(SOURCE_SM90)


def build_bwd() -> _nvcc.BuildInfo:
    """Compile ``csrc/flash_attention_bwd.cu`` into ``_build/``."""
    return _nvcc.build(SOURCE_BWD)


def build_bwd_sm90() -> _nvcc.BuildInfo:
    """Compile ``csrc/flash_attention_bwd_sm90.cu`` into ``_build/``."""
    return _nvcc.build(SOURCE_BWD_SM90)


def build_tf32x3() -> _nvcc.BuildInfo:
    """Compile ``csrc/flash_attention_tf32x3.cu`` into ``_build/``."""
    return _nvcc.build(SOURCE_TF32X3)


def build_bwd_tf32x3() -> _nvcc.BuildInfo:
    """Compile ``csrc/flash_attention_bwd_tf32x3.cu`` into ``_build/``."""
    return _nvcc.build(SOURCE_BWD_TF32X3)


def tf32x3_smem_bytes(dk: int, dv: int) -> int:
    """Dynamic shared memory a ``tf32x3`` forward launch at head dims
    ``dk``, ``dv`` requests, by the rule its source states: 1024 bytes of
    alignment, Q's hi and lo (32 KiB per 64-column block of Dk) and a ring
    of two 32 KiB slots that K's and V's 64 x 64 chunks stream through;
    the same at every ``dv``."""
    return 1024 + 32768 * -(-dk // 64) + 2 * 32768


def bwd_tf32x3_smem_bytes(dk: int, dv: int) -> int:
    """Dynamic shared memory the larger (dK/dV) kernel of the ``tf32x3``
    backward requests, by the rule its source states: 1024 bytes of
    alignment, then, where Dk and Dv take at most four 64-column blocks
    together, the block's own K and V kept split (32 KiB a block) and a
    ring of two 32 KiB slots (the walked chunk, hi and lo), else a ring of
    two 64 KiB slots (a chunk pair); and two stages of the walked tile's
    lse and D."""
    res = -(-dk // 64) + -(-dv // 64)
    if res > 4:
        res = 0
    return 1024 + 32768 * res + 2 * (32768 if res else 65536) + 2 * 2 * 64 * 4


def tf32x3_kernel_smem_bytes(dk: int, dv: int) -> tuple[int, int]:
    """(forward, backward) shared memory as the two ``tf32x3`` sources
    compute it (builds them)."""
    fwd = _nvcc.load(SOURCE_TF32X3, _ENTRIES_TF32X3)
    bwd = _nvcc.load(SOURCE_BWD_TF32X3, _ENTRIES_BWD_TF32X3)
    return (fwd.poas_flash_tf32x3_smem(dk, dv),
            bwd.poas_flash_bwd_tf32x3_smem(dk, dv))


def bwd_sm90_smem_bytes(dk: int, dv: int) -> int:
    """Dynamic shared memory the larger of the sm90 backward's two main
    kernels requests at head dims ``dk``, ``dv``, by the rule its source
    states: 1024 bytes of alignment and an 8 KiB bf16 block of 64 x 64 per
    64-column block of the fixed tiles and of the two ring stages (K, V, Q,
    dO), which the dK/dV kernel tops with its stages' lse and D.  Above two
    blocks both dims take the larger count NB, the two-warpgroup dK/dV
    kernel adds a 16 KiB f32 P exchange and at NB = 4 the two-warpgroup dQ
    kernel, the larger there, adds two (P and dS)."""
    dkb, dvb = -(-dk // 64), -(-dv // 64)
    nb = max(dkb, dvb)
    if nb == 4:
        return 1024 + 8192 * 2 * nb * 3 + 2 * 64 * 64 * 4
    if nb == 3:
        dkb = dvb = nb
    return (1024 + 8192 * (dkb + dvb) * 3 + 2 * 2 * 64 * 4
            + (64 * 64 * 4 if nb == 3 else 0))


def bwd_sm90_kernel_smem_bytes(dk: int, dv: int) -> int:
    """``bwd_sm90_smem_bytes`` as the kernel's source computes it (builds
    it)."""
    return _nvcc.load(SOURCE_BWD_SM90,
                      _ENTRIES_BWD_SM90).poas_flash_bwd_sm90_smem(dk, dv)


class Sm90Plan(NamedTuple):
    """An sm90 launch: keys a K/V tile, stages of its ring and bytes of
    dynamic shared memory."""
    keys: int
    stages: int
    smem: int


@functools.lru_cache(maxsize=None)
def sm90_plan(dk: int, dv: int) -> Sm90Plan:
    """The sm90 launch at head dims ``dk``, ``dv``, the only place its
    rule lives (the source takes keys and stages from the call and refuses
    what a block cannot hold): 128 keys a tile where both head dims are at
    most 128 (where registers and shared memory allow it), else 64;
    as many ring stages of K and V (up to 4) as fit a block's shared
    memory beside 1024 bytes of alignment, Q's 128 rows (16 KiB per
    64-column block of Dk) and 256 bytes of mbarriers."""
    dkb, dvb = -(-dk // 64), -(-dv // 64)
    keys = 128 if dk <= 128 and dv <= 128 else 64
    fixed = 1024 + dkb * 128 * 128 + 256
    stage = (dkb + dvb) * keys * 128
    stages = min(4, (_nvcc.SMEM_LIMIT - fixed) // stage)
    return Sm90Plan(keys, stages, fixed + stages * stage)


def route(dtype: torch.dtype, dk: int, dv: int) -> str:
    """Which kernel a CUDA call runs: ``"tf32x3"`` (3xTF32 on the tensor
    cores) for float32 at every head dim; ``"sm90"`` (bf16 on the tensor
    cores) for bfloat16 with Dk and Dv multiples of 16 up to 256; else
    ``"simt"`` (f32 arithmetic on the CUDA cores): bf16 at other head
    dims."""
    if dtype == torch.float32:
        return "tf32x3"
    if dtype == torch.bfloat16 and all(
            0 < d <= MAX_HEAD_DIM and d % 16 == 0 for d in (dk, dv)):
        return "sm90"
    return "simt"


def route_bwd(dtype: torch.dtype, dk: int, dv: int) -> str:
    """Which backward kernel a CUDA call runs, by ``route``'s rule:
    ``"tf32x3"`` for float32; ``"sm90"`` (bf16 on the tensor cores; one
    warpgroup per dK/dV block up to 128, two above) for bfloat16 with Dk
    and Dv multiples of 16 up to 256; else ``"simt"`` (f32 on the CUDA
    cores): bf16 at other head dims."""
    return route(dtype, dk, dv)


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` if its rows start on 16-byte boundaries and no dimension
    repeats its rows with stride 0 (what the tensor-core kernels' 16-byte
    copies and tensor maps need), else a contiguous copy of it whose rows
    are padded to 16 bytes, returned as a view of ``x``'s shape."""
    step = 16 // x.element_size()
    st = x.stride()[:3]
    if x.data_ptr() % 16 or any(s % step for s in st) or (
            0 in st and any(n > 1 for s, n in zip(st, x.shape) if s == 0)):
        last = x.shape[-1]
        buf = x.new_empty((*x.shape[:-1], last + (-last) % step))
        buf[..., :last] = x
        return buf[..., :last]
    return x


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_offset: int) -> None:
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
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
    Dv = v.shape[3]
    if not (1 <= Dk <= MAX_HEAD_DIM and 1 <= Dv <= MAX_HEAD_DIM):
        raise ValueError(f"flash_attention: head dims Dk={Dk}, Dv={Dv}; the "
                         f"kernels take 1..{MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Softmax attention with f32 accumulation; (B, Sq, H, Dv) in q's dtype.

    q: (B, Sq, H, Dk); k: (B, Skv, KH, Dk); v: (B, Skv, KH, Dv), float32 or
    bfloat16, unit stride on the last dim (other strides are read as they
    are).  GQA: query head h reads KV head h // (H / KH).  ``window`` > 0
    keeps the last ``window`` keys of each query; 0 is full attention.
    ``q_offset`` >= 0 is the absolute position of q[0] (query row i sits at
    ``q_offset + i``, keys at 0..Skv-1); a row that keeps no key is 0.
    CPU tensors run the plain version; CUDA tensors launch the kernel that
    ``route`` names on the current stream without synchronising, and raise
    if it cannot be built or launched.  When autograd records the call
    (grad mode on and an input requiring grad) the rows' log-sum-exp is
    kept for the backward, ``flash_attention_bwd``; otherwise nothing extra
    is written or saved.
    """
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, q_offset)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale,
                                     q_offset)
    return torch.ops.repro_torch.flash_attention(q, k, v, causal, window,
                                                 scale, q_offset)


def _forward(q, k, v, causal: bool, window: int, scale, with_lse: bool,
             q_offset: int = 0):
    """(o, lse or None): the plain version on the CPU, the route's kernel on
    the card; lse (B, H, Sq) float32 when ``with_lse``."""
    if q.device.type == "cpu":
        if with_lse:
            return flash_attention_ref(q, k, v, causal=causal, window=window,
                                       scale=scale, return_lse=True,
                                       q_offset=q_offset)
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   scale=scale, q_offset=q_offset), None
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(route(q.dtype, q.shape[3], v.shape[3]), q, k, v, causal,
                   window, scale, with_lse, q_offset)


def _launch(kind: str, q, k, v, causal: bool, window: int, scale,
            with_lse: bool, q_offset: int = 0):
    """(o, lse or None) from the forward kernel ``kind`` ("sm90", "tf32x3"
    or "simt") on CUDA tensors: ``_forward`` passes ``route``'s; a caller
    may name ``"simt"`` at a shape the rule sends elsewhere (to time the
    two)."""
    B, Sq, H, Dk = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    _check_strides("flash_attention", q=q, k=k, v=v)
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention: B={B}, H={H} exceed the grid")
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    plan = ()
    if kind == "sm90":   # built, or raises, before anything is allocated
        entry = getattr(_nvcc.load(SOURCE_SM90, _ENTRIES_SM90), _ENTRY_SM90)
        plan = sm90_plan(Dk, Dv)[:2]
    elif kind == "tf32x3":
        entry = getattr(_nvcc.load(SOURCE_TF32X3, _ENTRIES_TF32X3),
                        _ENTRY_TF32X3)
    else:
        entry = getattr(_nvcc.load(SOURCE, _ENTRIES), _ENTRY[q.dtype])
    o = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return o, lse
    if kind != "simt":
        q, k, v = _aligned16(q), _aligned16(k), _aligned16(v)
    strides = (ctypes.c_int64 * 12)(*(s for x in (q, k, v, o)
                                      for s in x.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            0 if lse is None else lse.data_ptr(), B, Sq, Skv, H, KH, Dk, Dv,
            strides, int(causal), window, scale, q_offset)
    with torch.cuda.device(q.device):
        err = entry(*plan, *args,
                    torch.cuda.current_stream(q.device).cuda_stream)
    _nvcc.check(err, f"flash_attention ({kind})")
    with _count_lock:
        flash_attention.launches += 1
        setattr(flash_attention, f"launches_{kind}",
                getattr(flash_attention, f"launches_{kind}") + 1)
    return o, lse


def _check_strides(what: str, **xs: torch.Tensor) -> None:
    for name, x in xs.items():
        if x.stride(3) != 1:
            raise ValueError(f"{what}: {name} needs unit stride on its "
                             f"last dim, got {tuple(x.stride())}")


class _FlashAttention(torch.autograd.Function):
    """K2 with its gradient: the forward keeps q, k, v, o and the rows'
    log-sum-exp; the backward is ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, q_offset):
        o, lse = torch.ops.repro_torch.flash_attention_lse(
            q, k, v, causal, window, scale, q_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, scale, q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, scale, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window, scale=scale,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        scale: float | None = None, q_offset: int = 0):
    """Gradients (dq, dk, dv) of ``flash_attention`` in q's, k's and v's
    dtypes, from its inputs, its output ``o``, the output's gradient ``do``
    and the rows' log-sum-exp ``lse`` (B, H, Sq) float32.  CPU tensors run
    ``ref.flash_attention_bwd_ref``; CUDA tensors launch the kernel that
    ``route_bwd`` names on the current stream, or raise: ``sm90`` writes
    bf16 gradients straight from its accumulators, ``tf32x3`` and ``simt``
    write float32 ones that are rounded to the inputs' dtypes here."""
    window, q_offset = int(window), int(q_offset)
    _check(q, k, v, q_offset)
    B, Sq, H, Dk = q.shape
    if tuple(o.shape) != (B, Sq, H, v.shape[3]) or do.shape != o.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do "
                         f"{tuple(do.shape)} are not (B, Sq, H, Dv)")
    if tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} "
                         f"{lse.dtype} is not ({B}, {H}, {Sq}) float32")
    return torch.ops.repro_torch.flash_attention_bwd(q, k, v, o, do, lse,
                                                     causal, window, scale,
                                                     q_offset)


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
              causal: bool, window: int, scale: Optional[float],
              q_offset: int = 0
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv): the plain backward on the CPU, the route's kernel on
    the card (the operator ``flash_attention_bwd``)."""
    B, Sq, H, Dk = q.shape
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, lse, causal=causal,
                                       window=window, scale=scale,
                                       q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: unsupported device "
                         f"{q.device}")
    return _launch_bwd(route_bwd(q.dtype, Dk, v.shape[3]), q, k, v, o, do,
                       lse, causal, window, scale, q_offset)


def _launch_bwd(kind: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, o: torch.Tensor, do: torch.Tensor,
                lse: torch.Tensor, causal: bool, window: int,
                scale: Optional[float], q_offset: int = 0
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the backward kernel ``kind`` ("sm90", "tf32x3" or
    "simt") on CUDA tensors: ``_backward`` passes ``route_bwd``'s; a caller
    may name ``"simt"`` at a shape the rule sends elsewhere (to time the
    two)."""
    B, Sq, H, Dk = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[3]
    o, do = o.to(q.dtype), do.to(q.dtype)
    if do.stride(3) != 1:
        do = do.contiguous()
    _check_strides("flash_attention_bwd", q=q, k=k, v=v, o=o, do=do)
    if B > 65535 or H > 65535:
        raise ValueError(f"flash_attention_bwd: B={B}, H={H} exceed the "
                         f"grid")
    if scale is None:
        scale = 1.0 / math.sqrt(Dk)
    if kind == "sm90":   # built, or raises, before anything is allocated
        entry = getattr(_nvcc.load(SOURCE_BWD_SM90, _ENTRIES_BWD_SM90),
                        _ENTRY_BWD_SM90)
        out = dict(dtype=q.dtype, device=q.device)
        q, k, v, o, do = (_aligned16(x) for x in (q, k, v, o, do))
    elif kind == "tf32x3":
        entry = getattr(_nvcc.load(SOURCE_BWD_TF32X3, _ENTRIES_BWD_TF32X3),
                        _ENTRY_BWD_TF32X3)
        out = dict(dtype=torch.float32, device=q.device)
        q, k, v, do = (_aligned16(x) for x in (q, k, v, do))
    else:
        entry = getattr(_nvcc.load(SOURCE_BWD, _ENTRIES_BWD),
                        _ENTRY_BWD[q.dtype])
        out = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Sq, H, Dk), **out)   # the kernels write every
    dk = torch.empty((B, Skv, KH, Dk), **out)  # element of dq, dk, dv
    dv = torch.empty((B, Skv, KH, Dv), **out)
    if dq.numel() == 0 or dk.numel() == 0:
        return (dq.zero_().to(q.dtype), dk.zero_().to(k.dtype),
                dv.zero_().to(v.dtype))
    scratch = torch.empty((B, H, Sq), dtype=torch.float32,
                          device=q.device)   # D = rowsum(dO o O)
    lse = lse.contiguous()
    strides = (ctypes.c_int64 * 15)(*(s for x in (q, k, v, o, do)
                                      for s in x.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), B, Sq, Skv, H, KH, Dk, Dv,
            strides, int(causal), window, scale, q_offset)
    with torch.cuda.device(q.device):
        err = entry(*args, torch.cuda.current_stream(q.device).cuda_stream)
    _nvcc.check(err, f"flash_attention_bwd ({kind})")
    with _count_lock:
        flash_attention_bwd.launches += 1
        setattr(flash_attention_bwd, f"launches_{kind}",
                getattr(flash_attention_bwd, f"launches_{kind}") + 1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def reset_counts() -> None:
    """Set the four launch counts of ``flash_attention`` and of
    ``flash_attention_bwd`` to 0: per route (``launches_sm90``,
    ``launches_tf32x3``, ``launches_simt``) and ``launches``, their sum."""
    with _count_lock:
        for fn in (flash_attention, flash_attention_bwd):
            fn.launches = 0
            for kind in ROUTES:
                setattr(fn, f"launches_{kind}", 0)


# Kernel launches, forward and backward: per route, and ``launches`` =
# their sum (reset all eight together).
reset_counts()


def band_pairs(sq: int, skv: int, causal: bool, window: int,
               q_offset: int = 0) -> int:
    """(query, key) pairs the mask keeps: key kept iff ``k_pos <= q_pos``
    (causal) and ``k_pos > q_pos - window`` (window > 0), query row i at
    ``q_pos = q_offset + i`` and keys at 0..Skv-1, as ``ref._band``."""
    q = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(q, skv - 1) if causal else np.full(sq, skv - 1)
    lo = np.maximum(0, q - window + 1) if window > 0 else np.zeros(sq, int)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_flops(q_shape, k_shape, v_shape, causal: bool, window: int,
                    scale=None, q_offset: int = 0) -> int:
    """K2's operations: S = QKᵀ and O = PV over the kept pairs, 2 (Dk + Dv)
    a pair per query head."""
    B, Sq, H, Dk = q_shape
    return (2 * B * H * (Dk + v_shape[3])
            * band_pairs(Sq, k_shape[1], causal, window, q_offset))


def attention_bwd_flops(q_shape, k_shape, v_shape, o_shape, do_shape,
                        lse_shape, causal: bool, window: int, scale=None,
                        q_offset: int = 0) -> int:
    """K2-bwd's operations: the dK/dV pass's S, dP, dV, dK and the dQ
    pass's S, dP, dQ over the kept pairs, 2 (4 Dk + 3 Dv) a pair per query
    head."""
    B, Sq, H, Dk = q_shape
    return (2 * B * H * (4 * Dk + 3 * v_shape[3])
            * band_pairs(Sq, k_shape[1], causal, window, q_offset))


def _score_bytes(matrices: int):
    """Bytes of ``matrices`` float32 (B, H, Sq, Skv) score-shaped tensors
    each written once and read once: what the plain version moves and the
    kernel keeps on chip."""
    def loop_bytes(q, k, *_):
        B, Sq, H, _ = q.shape
        return 2 * matrices * 4 * B * H * Sq * k.shape[1]
    return loop_bytes


def _op_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool, window: int, scale: Optional[float],
                q_offset: int = 0) -> torch.Tensor:
    return _forward(q, k, v, causal, window, scale, False, q_offset)[0]


def _op_forward_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, window: int, scale: Optional[float],
                    q_offset: int = 0
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    return _forward(q, k, v, causal, window, scale, True, q_offset)


def _fake_o(q, k, v, *_):
    B, Sq, H, _ = q.shape
    return q.new_empty((B, Sq, H, v.shape[3]))


def _fake_o_lse(q, k, v, *_):
    B, Sq, H, _ = q.shape
    return (_fake_o(q, k, v),
            q.new_empty((B, H, Sq), dtype=torch.float32))


def _fake_grads(q, k, v, *_):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_nvcc.kernel_op("flash_attention", _op_forward, fake=_fake_o,
                flops=attention_flops, loop_bytes=_score_bytes(2))
_nvcc.kernel_op("flash_attention_lse", _op_forward_lse, fake=_fake_o_lse,
                flops=attention_flops, loop_bytes=_score_bytes(2))
_nvcc.kernel_op("flash_attention_bwd", _backward, fake=_fake_grads,
                flops=attention_bwd_flops, loop_bytes=_score_bytes(4))
