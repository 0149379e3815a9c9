"""K3: the hand-written Hopper Mamba-2 SSD intra-chunk kernel — wrapper and
launch count.

Replaces ``src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas``.  The kernel
is ``csrc/ssd_chunk.cu`` (CUDA C++ for ``sm_90a``; its header says what
bounds it on an H100 and what the design does about it): C·Bᵀ,
(C·Bᵀ∘L)·xdt and the chunk state on the tensor cores through 3xTF32 (three
TF32 wgmma per product, ``csrc/sm90_tf32x3.cuh``).  It is built at its
first CUDA launch by ``_nvcc``.

Dispatch rule: CPU tensors take the plain version (``ref.ssd_chunk_ref``);
CUDA tensors launch the kernel or raise — there is no fallback.  The kernel
computes in float32: bfloat16 inputs are widened to float32 on the card
before the launch and y is rounded back to bfloat16 after it.

Gradients: when autograd records the call, ``ssd_chunk`` runs as a
``torch.autograd.Function`` whose backward is ``ssd_chunk_bwd``: the kernels
of ``csrc/ssd_chunk_bwd.cu`` (3xTF32 on wgmma; C·Bᵀ, dC and dB once per
group) on CUDA tensors, ``ref.ssd_chunk_bwd_ref`` on CPU tensors.  It is the gradient of the
intra-chunk part of the reference model's ``ssd_scan``
(``src/repro/models/ssm.py:67``), which the reference differentiates with
``jax.value_and_grad``; the Pallas kernel has no backward.  Both forms take
exp only of kept (q >= t) decay differences, so their gradient stays
finite where the reference's turns NaN (ROADMAP, C3).

Both entries are operators (``_nvcc.kernel_op``):
``torch.ops.repro_torch.ssd_chunk`` and ``ssd_chunk_bwd``, with fake
implementations and flop formulas (``chunk_flops``, ``chunk_bwd_flops``)
over each chunk's Q(Q+1)/2 kept (q, t) pairs.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import _nvcc
from .ref import ssd_chunk_bwd_ref, ssd_chunk_ref

SOURCE = _nvcc.CSRC / "ssd_chunk.cu"
SOURCE_BWD = _nvcc.CSRC / "ssd_chunk_bwd.cu"
# hp and ds: hp is padded to the wgmma width 16, 32, 64 or 128 of the y
# product, ds to the 8-deep k steps of C·Bᵀ; 128 bounds both.
MAX_DIM = 128
SMEM_LIMIT = _nvcc.SMEM_LIMIT
_TILE = 64               # q rows of a y block, t of a tile (TQ, TT)
_ATOM = _TILE * 128      # a 64-row K-major tile over 32 of ds (8 KiB)
_DTYPES = (torch.float32, torch.bfloat16)
_ENTRY = "poas_ssd_chunk_f32"
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 7
             + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p])
_ENTRIES = {_ENTRY: _ARGTYPES, "poas_ssd_chunk_smem": [ctypes.c_int64] * 2}
_ENTRY_BWD = "poas_ssd_chunk_bwd_f32"
# xdt, B, C, cum, dy, dstates, dxdt, dB, dC, dcum, scratch, then b, NC, Q,
# nh, G, hp, ds, heads per slice, 24 strides, the stream.
_ENTRIES_BWD = {
    _ENTRY_BWD: ([ctypes.c_void_p] * 11 + [ctypes.c_int64] * 8
                 + [ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p]),
    "poas_ssd_chunk_bwd_smem": [ctypes.c_int64] * 3,
    "poas_ssd_chunk_bwd_scratch": [ctypes.c_int64] * 8}
_THREADS = 128           # one warpgroup a block (every K3-bwd kernel)

_count_lock = threading.Lock()


def build() -> _nvcc.BuildInfo:
    """Compile ``csrc/ssd_chunk.cu`` into ``_build/`` (see ``_nvcc``)."""
    return _nvcc.build(SOURCE)


def build_bwd() -> _nvcc.BuildInfo:
    """Compile ``csrc/ssd_chunk_bwd.cu`` into ``_build/``."""
    return _nvcc.build(SOURCE_BWD)


def _padded_hp(hp: int) -> int:
    return 16 if hp <= 16 else 32 if hp <= 32 else 64 if hp <= 64 else 128


def _items(hp: int) -> int:
    """Work items a block takes (``kItems`` in csrc/ssd_chunk.cu): two at
    hp <= 64 (q tiles k and nq-1-k, or two 64-row tiles of the state), one
    above."""
    return 1 if hp > 64 else 2


def blocks_per_head(Q: int, hp: int, ds: int) -> int:
    """Blocks the kernel launches per (batch, chunk, head)."""
    nq, nsm = -(-Q // _TILE), -(-ds // 64)
    if _items(hp) == 1:
        return nq + nsm
    return (nq + 1) // 2 + (nsm + 1) // 2


def smem_bytes(hp: int, ds: int) -> int:
    """Dynamic shared memory of one block, as ``layout`` in
    csrc/ssd_chunk.cu lays it out: C of each item a block takes (two at
    hp <= 64, one above) and B, K-major (hi in place of the raw tile, lo
    beside it), xdt's hi/lo (``_padded_hp(hp)`` rows x 64 t each; raw xdt
    lands in lo), a tile of cum, and 1024 bytes of alignment.  The chunk
    length Q does not enter."""
    kt = _ATOM * -(-ds // 32)
    c_slots = 1 if _items(hp) == 1 else 2
    return 1024 + (2 * c_slots + 2) * kt + 2 * _padded_hp(hp) * 256 + 4 * _TILE


def entry(dtype: torch.dtype) -> str:
    """The C entry point a CUDA call with inputs in ``dtype`` launches: the
    float32 kernel for both types (bf16 inputs are widened first)."""
    if dtype not in _DTYPES:
        raise TypeError(f"ssd_chunk: no kernel for {dtype}")
    return _ENTRY


def kernel_smem_bytes(hp: int, ds: int) -> int:
    """The kernel's own figure for ``smem_bytes`` (builds it if needed)."""
    return _nvcc.load(SOURCE, _ENTRIES).poas_ssd_chunk_smem(hp, ds)


def _tiles(Q: int) -> int:
    return -(-Q // _TILE)


def bwd_smem_bytes(Q: int, hp: int, ds: int) -> int:
    """Dynamic shared memory of K3-bwd's main kernel (the largest of its
    three), as ``main_layout`` in csrc/ssd_chunk_bwd.cu lays it out: xdt's
    t tile and the dy tile K-major (hi, lo), dy transposed (hi, lo, hp
    padded to 16/32/64/128 rows), two raw dy tiles, the slice's dCB^T
    (16 KiB a q tile), two stages of cum and of the column sums, 32 raw
    rows of dstates and 32 columns of B, and 1024 bytes of alignment.  ds
    does not enter."""
    xk = _ATOM * -(-hp // 32)
    hpp = _padded_hp(hp)
    xp = 16 * -(-hp // 4)
    end = 4 * xk + 2 * hpp * 256 + 2 * _TILE * xp
    dcb = _tiles(Q) * 32 * _THREADS * 4
    state = 32 * xp + _TILE * 128      # 32 rows of dstates, 32 of B
    return 1024 + end + dcb + 2 * _TILE * 4 + 2 * 8 * 32 * 4 + state


def bwd_heads_per_slice(b: int, nc: int, Q: int, nh: int, G: int,
                        sms: int) -> int:
    """Heads of a group that one K3-bwd main block walks: the group is cut
    into as few slices as give the grid (64-row t tiles x slices x groups x
    batch-chunks) two blocks per SM of a card with ``sms`` SMs.  Each slice
    adds its own dCB partial, which the post kernel sums in slice order."""
    hg = nh // G
    base = _tiles(Q) * G * b * nc
    slices = min(hg, max(1, -(-2 * sms // base)))
    return -(-hg // slices)


def bwd_scratch_floats(b: int, nc: int, Q: int, nh: int, G: int, ds: int,
                       hs: int) -> int:
    """Floats of scratch K3-bwd takes (``scratch`` in
    csrc/ssd_chunk_bwd.cu): C·Bᵀ per (t tile <= q tile) pair and group, the
    slices' dCB partials, the slices' state-term dB, dcum's q parts per t
    tile, its t part, and F."""
    nt = _tiles(Q)
    slices = -(-(nh // G) // hs)
    rows = b * nc * Q
    pair_tiles = b * nc * G * nt * (nt + 1) // 2 * _TILE * _TILE
    return ((1 + slices) * pair_tiles + slices * rows * G * ds
            + (nt + 2) * rows * nh)


def bwd_kernel_figures(Q: int, hp: int, ds: int, b: int, nc: int, nh: int,
                       G: int, hs: int) -> tuple[int, int]:
    """The kernel's own (shared memory, scratch floats) for these dims
    (builds it if needed)."""
    lib = _nvcc.load(SOURCE_BWD, _ENTRIES_BWD)
    return (lib.poas_ssd_chunk_bwd_smem(Q, hp, ds),
            lib.poas_ssd_chunk_bwd_scratch(b, nc, Q, nh, G, hp, ds, hs))


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
    if not (xdt.dtype == B.dtype == C.dtype) or xdt.dtype not in _DTYPES:
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
    kernel cannot be built or launched.  When autograd records the call the
    inputs are kept for the backward, ``ssd_chunk_bwd``.
    """
    _check(xdt, B, C, cum)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (xdt, B, C, cum)):
        return _SsdChunk.apply(xdt, B, C, cum)
    return torch.ops.repro_torch.ssd_chunk(xdt, B, C, cum)


def _forward(xdt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
             cum: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, states): the plain version on the CPU, the kernel on the card
    (the operator ``ssd_chunk``)."""
    if xdt.device.type == "cpu":
        return ssd_chunk_ref(xdt, B, C, cum)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {xdt.device}")
    b, nc, Q, nh, hp = xdt.shape
    G, ds = B.shape[3], B.shape[4]
    if not (1 <= hp <= MAX_DIM and 1 <= ds <= MAX_DIM):
        raise ValueError(f"ssd_chunk: hp={hp}, ds={ds}; the kernel takes "
                         f"1..{MAX_DIM}")
    if smem_bytes(hp, ds) > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk: hp={hp}, ds={ds} need more shared "
                         f"memory than a block has")
    for name, x in (("xdt", xdt), ("B", B), ("C", C)):
        if x.stride(-1) != 1:
            raise ValueError(f"ssd_chunk: {name} needs unit stride on its "
                             f"last dim, got {tuple(x.stride())}")
    if nc > 65535 or b > 65535 or nh * blocks_per_head(Q, hp, ds) >= 2**31:
        raise ValueError(f"ssd_chunk: b={b}, NC={nc}, nh={nh}, Q={Q} exceed "
                         f"the grid")
    fn = getattr(_nvcc.load(SOURCE, _ENTRIES), entry(xdt.dtype))   # or raises
    out_dtype = xdt.dtype
    y = torch.empty((b, nc, Q, nh, hp), dtype=torch.float32,
                    device=xdt.device)
    states = torch.empty((b, nc, nh, ds, hp), dtype=torch.float32,
                         device=xdt.device)
    if y.numel() == 0:
        return y.to(out_dtype), states.zero_()
    xdt, B, C = (_nvcc.aligned_rows(x.float()) for x in (xdt, B, C))
    strides = (ctypes.c_int64 * 20)(*(
        st if n > 1 else 0 for x in (xdt, B, C, cum, y)
        for st, n in zip(x.stride()[:4], x.shape[:4])))
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(xdt.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(),
                 y.data_ptr(), states.data_ptr(), b, nc, Q, nh, G, hp, ds,
                 strides, stream)
    _nvcc.check(err, "ssd_chunk")
    with _count_lock:
        ssd_chunk.launches += 1
    return y.to(out_dtype), states


class _SsdChunk(torch.autograd.Function):
    """K3 with its gradient: the forward keeps its inputs; the backward is
    ``ssd_chunk_bwd``."""

    @staticmethod
    def forward(ctx, xdt, B, C, cum):
        y, states = torch.ops.repro_torch.ssd_chunk(xdt, B, C, cum)
        ctx.save_for_backward(xdt, B, C, cum)
        return y, states

    @staticmethod
    def backward(ctx, dy, dstates):
        # An output that did not reach the loss gets a zero gradient here
        # (autograd materialises it), never None.
        return ssd_chunk_bwd(*ctx.saved_tensors, dy, dstates)


def ssd_chunk_bwd(xdt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  cum: torch.Tensor, dy: torch.Tensor,
                  dstates: torch.Tensor):
    """Gradients (dxdt, dB, dC, dcum) of ``ssd_chunk`` in the inputs'
    dtypes, given the gradients ``dy`` (b, NC, Q, nh, hp) of y and
    ``dstates`` (b, NC, nh, ds, hp) of the states.  CPU tensors run
    ``ref.ssd_chunk_bwd_ref``; CUDA tensors launch the kernels of
    ``csrc/ssd_chunk_bwd.cu`` on the current stream, or raise.  The kernels
    compute in float32 (bf16 inputs are widened here) and write every
    output whole: dB and dC per group, dcum with all its parts, in an order
    that does not depend on the order blocks run in."""
    _check(xdt, B, C, cum)
    b, nc, Q, nh, hp = xdt.shape
    G, ds = B.shape[3], B.shape[4]
    if tuple(dy.shape) != tuple(xdt.shape) or tuple(dstates.shape) != (
            b, nc, nh, ds, hp):
        raise ValueError(f"ssd_chunk_bwd: dy {tuple(dy.shape)} / dstates "
                         f"{tuple(dstates.shape)} do not match the inputs")
    return torch.ops.repro_torch.ssd_chunk_bwd(xdt, B, C, cum, dy, dstates)


def _backward(xdt: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
              cum: torch.Tensor, dy: torch.Tensor, dstates: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """The plain backward on the CPU, the kernels on the card (the
    operator ``ssd_chunk_bwd``)."""
    b, nc, Q, nh, hp = xdt.shape
    G, ds = B.shape[3], B.shape[4]
    if xdt.device.type == "cpu":
        return ssd_chunk_bwd_ref(xdt, B, C, cum, dy, dstates)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_chunk_bwd: unsupported device {xdt.device}")
    if not (1 <= hp <= MAX_DIM and 1 <= ds <= MAX_DIM):
        raise ValueError(f"ssd_chunk_bwd: hp={hp}, ds={ds}; the kernel "
                         f"takes 1..{MAX_DIM}")
    if bwd_smem_bytes(Q, hp, ds) > SMEM_LIMIT:
        raise ValueError(f"ssd_chunk_bwd: Q={Q}, hp={hp}, ds={ds} need more "
                         f"shared memory than a block has")
    if b * nc > 65535 or G > 65535:
        raise ValueError(f"ssd_chunk_bwd: b={b}, NC={nc}, G={G} exceed the "
                         f"grid")
    fn = getattr(_nvcc.load(SOURCE_BWD, _ENTRIES_BWD), _ENTRY_BWD)
    sms = torch.cuda.get_device_properties(xdt.device).multi_processor_count
    hs = bwd_heads_per_slice(b, nc, Q, nh, G, sms)
    f32 = dict(dtype=torch.float32, device=xdt.device)
    dxdt = torch.empty((b, nc, Q, nh, hp), **f32)
    dB = torch.empty((b, nc, Q, G, ds), **f32)
    dC = torch.empty((b, nc, Q, G, ds), **f32)
    dcum = torch.empty((b, nc, Q, nh), **f32)
    if dxdt.numel() == 0:
        return (dxdt.zero_().to(xdt.dtype), B.new_zeros(B.shape),
                C.new_zeros(C.shape), torch.zeros_like(cum))
    scratch = torch.empty(bwd_scratch_floats(b, nc, Q, nh, G, ds, hs), **f32)
    ins = []
    for x in (xdt, B, C, cum, dy, dstates):
        x = x.float()
        if x.stride(-1) != 1:
            x = x.contiguous()
        ins.append(x if x.dim() == 4 else _nvcc.aligned_rows(x))
    # (b, NC, Q-or-ds, head-or-group) per input; dstates is (b, NC, nh, ds,
    # hp), so its ds stride comes third.  Size-1 dims get stride 0.
    order = ((0, 1, 2, 3),) * 5 + ((0, 1, 3, 2),)
    strides = (ctypes.c_int64 * 24)(*(
        x.stride(d) if x.shape[d] > 1 else 0
        for x, dims in zip(ins, order) for d in dims))
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(*(x.data_ptr() for x in ins), dxdt.data_ptr(),
                 dB.data_ptr(), dC.data_ptr(), dcum.data_ptr(),
                 scratch.data_ptr(), b, nc, Q, nh, G, hp, ds, hs, strides,
                 stream)
    _nvcc.check(err, "ssd_chunk_bwd")
    with _count_lock:
        ssd_chunk_bwd.launches += 1
    return dxdt.to(xdt.dtype), dB.to(B.dtype), dC.to(C.dtype), dcum


ssd_chunk.launches = 0
ssd_chunk_bwd.launches = 0


def chunk_flops(xdt_shape, B_shape, *_) -> int:
    """K3's operations per (batch, chunk, head), over the Q(Q+1)/2 kept
    (q, t) pairs: C·Bᵀ (ds a pair) and (C·Bᵀ∘L)·xdt (hp a pair), and the
    chunk state (Q ds hp), 2 operations a product."""
    b, nc, Q, nh, hp = xdt_shape
    ds = B_shape[4]
    pairs = Q * (Q + 1) // 2
    return 2 * b * nc * nh * (pairs * (ds + hp) + Q * ds * hp)


def chunk_bwd_flops(xdt_shape, B_shape, *_) -> int:
    """K3-bwd's operations per (batch, chunk), over the kept pairs: dM =
    dy xdtᵀ and dxdt = Mᵀ dy per head (hp a pair each), C·Bᵀ, dC and dB
    once per group (ds a pair each), and the two state terms per head
    (Q ds hp each)."""
    b, nc, Q, nh, hp = xdt_shape
    G, ds = B_shape[3], B_shape[4]
    pairs = Q * (Q + 1) // 2
    return 2 * b * nc * (pairs * (nh * 2 * hp + G * 3 * ds)
                         + nh * 2 * Q * ds * hp)


def _fake_forward(xdt, B, C, cum):
    b, nc, Q, nh, hp = xdt.shape
    return (torch.empty_like(xdt),
            xdt.new_empty((b, nc, nh, B.shape[4], hp), dtype=torch.float32))


def _fake_backward(xdt, B, C, cum, dy, dstates):
    return (torch.empty_like(xdt), torch.empty_like(B), torch.empty_like(C),
            torch.empty_like(cum))


_nvcc.kernel_op("ssd_chunk", _forward, fake=_fake_forward,
                flops=chunk_flops)
_nvcc.kernel_op("ssd_chunk_bwd", _backward, fake=_fake_backward,
                flops=chunk_bwd_flops)
