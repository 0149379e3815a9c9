// K3: the Mamba-2 SSD intra-chunk part on Hopper's tensor cores (sm_90a),
// f32 through 3xTF32 on wgmma.
//
// Replaces src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas (body
// _ssd_chunk_kernel).  For each (batch, chunk, head), with cum the
// within-chunk cumulative sum of dt*A (falling along the chunk):
//   CB     = C . B^T                                   (Q x Q)
//   L[q,t] = exp(cum_q - cum_t) if q >= t else 0
//   y      = (CB o L) . xdt                            (Q x hp)
//   state  = (B o exp(cum_end - cum))^T . xdt          (ds x hp, f32)
// Head h reads B/C group h // (nh / G).  The Pallas kernel holds the whole
// Q x Q score tile in VMEM; at ssm_chunk = 256 an f32 tile is 256 KiB, more
// than the 227 KB of shared memory a block may use here.  The model calls
// it in f32 (ssd_scan upcasts); the wrapper widens bf16 inputs to f32.
//
// What bounds it on this card.  At hymba-1.5B's prefill (b 5, NC 11,
// Q 256, nh 50, hp 64, ds 16) the call reads xdt, B, C and cum and writes y
// and the states: ~376 MB, 0.112 ms at 3.35 TB/s.  Its 15.9 GFLOP (causal
// half of the scores) take 0.096 ms even as three TF32 products at 495
// TFLOP/s: bytes bound.  On the CUDA cores' 67 TFLOP/s the operations
// alone would take 0.24 ms.
//
// What the design does about it:
//  * Blocks of one warpgroup, each with a list of work items that share
//    one walk over the 64-wide t tiles: a q tile's y (64 rows), or 64 rows
//    of ds of the chunk state.  At hp <= 64 a block takes two q tiles, k
//    and nq-1-k (nq+1 tiles of work for every pair), and the state's rows
//    go two tiles a block; above hp = 64 (registers) one item a block.  A
//    tile of B, xdt and cum is loaded once per block by 16-byte cp.async
//    (zero-filled past Q) and serves every item still at or below its
//    diagonal; tiles above every item's diagonal are never loaded.
//  * CB = C . B^T on 3xTF32 wgmma.m64n64k8: C and B are K-major as stored;
//    they land in the 128-byte-swizzle layout and are split in place (hi
//    over the raw tile, lo beside it).
//  * The decay is selected, not multiplied: for q < t, cum_q - cum_t > 0
//    and exp may overflow to inf, and inf * 0 would be NaN.  It is one
//    FMA and one ex2.approx on log2(e)-scaled cum.
//  * y += (CB o L) . xdt on 3xTF32 wgmma with A from registers: CB o L is
//    split into hi/lo in the accumulator's registers.  The accumulator
//    holds columns 2c, 2c+1 of each 8-wide k step where the tf32 A operand
//    wants c, c+4, so instead of moving the scores the split pass of xdt
//    permutes t the same way (logical k c -> t 2c, k c + 4 -> t 2c + 1)
//    while it transposes xdt's tile into the K-major layout that tf32
//    wgmma needs for B.  Raw xdt lands in the lo buffer and is split
//    through registers.
//  * The state is y for query rows C = I at cum_end, with no causal mask:
//    its P is B[t][s] exp(cum_end - cum_t), built straight into A
//    fragments from the split B tile, on the same wgmma path.
//  * xdt, B, C, cum, y and the states are read and written through their
//    strides; rows of xdt, B and C start on 16 bytes (the wrapper copies
//    what does not).  Any Q (ragged tiles are zero-filled and masked);
//    hp, ds <= 128.
//
// Measured no faster at hymba's shape, so not kept: a second stage of raw
// tiles in flight; the state's rows in the same block as q tiles k = 0
// and nq-1 (three items: more registers, spills); building each k step's
// A fragments just before its products.  The state on the CUDA cores (one
// block per head and chunk) cost more than the tensor-core path here.
#include <cstdint>

#include <cuda_runtime.h>

#include "sm90_tf32x3.cuh"

namespace {

using namespace poas_sm90;

constexpr int TQ = 64;            // q rows per y block (one wgmma M)
constexpr int TT = 64;            // t per tile
constexpr int THREADS = 128;      // one warpgroup
constexpr int ATOM = 64 * 128;    // 64 rows x 128 bytes (32 f32 of K)

struct Strides {   // element strides of (b, NC, Q, heads or groups)
  int64_t b, c, q, h;
};

struct Dims {
  int q, nh, groups, hp, ds;
};

// Work items per block (see the header): two at hp <= 64, one above.
template <int HPP> constexpr int kItems = HPP > 64 ? 1 : 2;

// Byte offsets of one block's shared memory, past the 1024-byte alignment.
// Raw B lands in B hi and is split in place; raw xdt lands in xdt lo and
// is split through registers.
struct Layout {
  uint32_t kt;       // a 64-row K-major tile over ds: 8 KiB per 32 of ds
  uint32_t xp;       // bytes per raw xdt row
  uint32_t c, b_hi, b_lo, x_hi, x_lo, cum, bytes;   // c: hi, lo per slot
};

__host__ __device__ inline int padded_hp(int hp) {
  return hp <= 16 ? 16 : hp <= 32 ? 32 : hp <= 64 ? 64 : 128;
}

__host__ __device__ inline Layout layout(int hp, int ds) {
  Layout l;
  const int slots = hp > 64 ? 1 : 2;   // C tiles: one per item
  l.kt = ATOM * ((ds + 31) / 32);
  l.xp = 16 * ((hp + 3) / 4);
  const uint32_t xb = padded_hp(hp) * 256;   // HPP rows x 64 t
  l.c = 0;
  l.b_hi = 2 * slots * l.kt;
  l.b_lo = l.b_hi + l.kt;
  l.x_hi = l.b_lo + l.kt;
  l.x_lo = l.x_hi + xb;
  l.cum = l.x_lo + xb;
  l.bytes = 1024 + l.cum + TT * 4;
  return l;
}

// Blocks per (batch, chunk, head) and the items of block `slot`.
struct Items {
  int n, kind[2], idx[2], last;   // kind 0: q tile idx; 1: state rows 64 idx
};

__host__ __device__ inline int blocks_per_head(int items, int nq, int ds) {
  const int nsm = (ds + 63) / 64;
  return items == 1 ? nq + nsm : (nq + 1) / 2 + (nsm + 1) / 2;
}

__device__ __forceinline__ Items items_of(int items, int slot, int nq,
                                          int ds) {
  const int nsm = (ds + 63) / 64, np = (nq + 1) / 2;
  Items it;
  it.n = 0;
  auto add = [&](int kind, int idx) {
    it.kind[it.n] = kind;
    it.idx[it.n] = idx;
    ++it.n;
  };
  if (items == 1) {
    if (slot < nq) add(0, nq - 1 - slot);   // the longest rows first
    else add(1, slot - nq);
  } else if (slot < np) {   // q tiles k and nq-1-k: nq+1 tiles of work
    add(0, nq - 1 - slot);
    if (slot != nq - 1 - slot) add(0, slot);
  } else {                  // the state's rows, two 64-row tiles a block
    for (int m = 2 * (slot - np); m < nsm && m < 2 * (slot - np + 1); ++m)
      add(1, m);
  }
  it.last = 0;
  for (int k = 0; k < it.n; ++k) {
    const int last = it.kind[k] == 0 ? it.idx[k] : nq - 1;
    it.last = last > it.last ? last : it.last;
  }
  return it;
}

// 64 rows [row0, row0 + 64) of a (Q, ds) operand into a K-major swizzled
// tile; 16-byte chunks up to ds rounded to 8 (zero-filled past ds and Q).
__device__ __forceinline__ void load_kmajor(uint32_t dst, const float* src,
                                            int64_t stride, int Q, int ds,
                                            int64_t row0, int tid) {
  const int nch = 2 * ((ds + 7) / 8);
  for (int e = tid; e < TT * nch; e += THREADS) {
    const int r = e / nch, c = e - r * nch;
    const int bytes = row0 + r < Q ? chunk_bytes(4 * c, ds, 4) : 0;
    cp_async16(dst + (c >> 3) * ATOM + sw128(r, c & 7),
               bytes ? src + (row0 + r) * stride + 4 * c : src, bytes);
  }
}

// 64 rows of xdt from t0 as they lie (hp contiguous), `xp` bytes a row.
__device__ __forceinline__ void load_x(uint32_t dst, const float* src,
                                       int64_t stride, int Q, int hp,
                                       uint32_t xp, int64_t t0, int tid) {
  const int nch = static_cast<int>(xp / 16);
  for (int e = tid; e < TT * nch; e += THREADS) {
    const int r = e / nch, c = e - r * nch;
    const int bytes = t0 + r < Q ? chunk_bytes(4 * c, hp, 4) : 0;
    cp_async16(dst + r * xp + c * 16,
               bytes ? src + (t0 + r) * stride + 4 * c : src, bytes);
  }
}

// A K-major tile split in place: hi over the raw values, lo beside them.
__device__ __forceinline__ void split_kmajor(uint8_t* hi, uint8_t* lo,
                                             int ds, int tid) {
  const int nch = 2 * ((ds + 7) / 8);
  for (int e = tid; e < TT * nch; e += THREADS) {
    const int r = e / nch, c = e - r * nch;
    const uint32_t off = (c >> 3) * ATOM + sw128(r, c & 7);
    float4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(hi + off), h, l);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// xdt's raw tile [t][p], landed in `lo`, -> hi/lo [p][k], K-major,
// swizzled, with k in wgmma's A order: 16-byte chunk cc of row p holds
// logical k 4cc .. 4cc+3, i.e. t = 8 (cc / 2) + 2j + cc % 2 for j = 0..3
// (k c -> t 2c and k c + 4 -> t 2c + 1 in each group of 8).  Rows p >= hp
// are zero.  Every thread reads its raw values into registers before any
// thread writes over them.
template <int HPP>
__device__ __forceinline__ void split_x(uint8_t* hi, uint8_t* lo, int hp,
                                        uint32_t xp, int tid) {
  constexpr int PER = HPP * 16 / THREADS;   // chunks per thread
  float4 x[PER];
  const int row = static_cast<int>(xp / 4);
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS, p = e % HPP, cc = e / HPP;
    const int t = 8 * (cc >> 1) + (cc & 1);
    const float* col = reinterpret_cast<const float*>(lo + t * xp) + p;
    x[m] = p < hp ? make_float4(col[0], col[2 * row], col[4 * row],
                                col[6 * row])
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS, p = e % HPP, cc = e / HPP;
    float4 h, l;
    split_tf32(x[m], h, l);
    const uint32_t off = (cc >> 3) * (HPP * 128) + sw128(p, cc & 7);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU, denormal results flushed to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cum of rows [t0, t0 + 64) (strided by `stride`), zero past Q.
__device__ __forceinline__ void load_cum(uint32_t dst, const float* src,
                                         int64_t stride, int Q, int64_t t0,
                                         int tid) {
  if (tid < TT) {
    const bool ok = t0 + tid < Q;
    cp_async4(dst + tid * 4, ok ? src + (t0 + tid) * stride : src, ok);
  }
}

template <int HPP>
__global__ void __launch_bounds__(THREADS, HPP > 64 ? 1 : 2)
ssd_chunk_tf32x3(const float* __restrict__ xdt, const float* __restrict__ bmat,
                 const float* __restrict__ cmat, const float* __restrict__ cum,
                 float* __restrict__ y, float* __restrict__ states, Dims dm,
                 Strides xs, Strides bs, Strides cs, Strides ms, Strides ys) {
  constexpr int ITEMS = kItems<HPP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw0);
  const Layout L = layout(dm.hp, dm.ds);
  const int Q = dm.q, hp = dm.hp, ds = dm.ds;
  const int nq = (Q + TQ - 1) / TQ;
  const int nblk = blocks_per_head(ITEMS, nq, ds);
  const int slot = static_cast<int>(blockIdx.x % nblk);
  const int64_t h = blockIdx.x / nblk, c = blockIdx.y, b = blockIdx.z;
  const int64_t g = h / (dm.nh / dm.groups);
  const float* xb = xdt + b * xs.b + c * xs.c + h * xs.h;
  const float* bb = bmat + b * bs.b + c * bs.c + g * bs.h;
  const float* cb = cmat + b * cs.b + c * cs.c + g * cs.h;
  const float* mb = cum + b * ms.b + c * ms.c + h * ms.h;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, cq = lane % 4;
  const int row_a = warp * 16 + lane / 4;   // and row_a + 8, within the item
  const Items it = items_of(ITEMS, slot, nq, ds);
  const float* cum_t = reinterpret_cast<const float*>(sm + L.cum);
  const float end2 = mb[(Q - 1) * ms.q] * LOG2E;

  // Per item: the q tile's C (K-major, in its slot), this thread's two
  // rows' cum * log2(e) (cum_end for the state), and the rows that exist.
  float cum_r[ITEMS][2];
  int rows[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    rows[k] = 0;
    cum_r[k][0] = cum_r[k][1] = end2;
    if (k >= it.n) continue;
    if (it.kind[k] == 0) {
      const int64_t q0 = static_cast<int64_t>(it.idx[k]) * TQ;
      rows[k] = Q - q0 < TQ ? static_cast<int>(Q - q0) : TQ;
      load_kmajor(base + L.c + 2 * k * L.kt, cb, cs.q, Q, ds, q0, tid);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        cum_r[k][r] = row_a + 8 * r < rows[k]
                          ? mb[(q0 + row_a + 8 * r) * ms.q] * LOG2E
                          : 0.f;
    } else {
      rows[k] = ds - 64 * it.idx[k] < 64 ? ds - 64 * it.idx[k] : 64;
    }
  }

  float acc[ITEMS][HPP / 2], s[32];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
#pragma unroll
    for (int e = 0; e < HPP / 2; ++e) acc[k][e] = 0.f;
  const int dsk = (ds + 7) / 8;   // k8 steps of CB

  for (int j = 0; j <= it.last; ++j) {
    // Tile j of B, xdt and cum (with the C tiles at j = 0), once every
    // reader of tile j-1 is done.
    const int64_t t0 = static_cast<int64_t>(j) * TT;
    __syncthreads();
    load_kmajor(base + L.b_hi, bb, bs.q, Q, ds, t0, tid);
    load_x(base + L.x_lo, xb, xs.q, Q, hp, L.xp, t0, tid);
    load_cum(base + L.cum, mb, ms.q, Q, t0, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (j == 0)
      for (int k = 0; k < it.n; ++k)
        if (it.kind[k] == 0)
          split_kmajor(sm + L.c + 2 * k * L.kt, sm + L.c + (2 * k + 1) * L.kt,
                       ds, tid);
    split_kmajor(sm + L.b_hi, sm + L.b_lo, ds, tid);
    split_x<HPP>(sm + L.x_hi, sm + L.x_lo, hp, L.xp, tid);
    fence_proxy_async();
    __syncthreads();

#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (k >= it.n) continue;
      const bool is_y = it.kind[k] == 0;
      if (is_y && j > it.idx[k]) continue;   // past this q tile's diagonal
      if (is_y) {   // CB tile: C (64 x ds) . B_j^T, 3xTF32
        const uint32_t c_hi = base + L.c + 2 * k * L.kt;
        // The first product overwrites s: zeroing it here ends its live
        // range at the last P of the previous item (the asm reads it).
#pragma unroll
        for (int e = 0; e < 32; ++e) s[e] = 0.f;
        fence_regs(s);
        wg_fence();
        for (int kk = 0; kk < dsk; ++kk)
          tf32x3_ss<64>(s, kmajor_desc(c_hi, kk, ATOM),
                        kmajor_desc(c_hi + L.kt, kk, ATOM),
                        kmajor_desc(base + L.b_hi, kk, ATOM),
                        kmajor_desc(base + L.b_lo, kk, ATOM), kk > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
      }
      // P, split into the tf32 A fragments of 8 k8 steps.  Register x of
      // step kk is row row_a + 8 (x & 1) of the item and t = 8kk + 2cq +
      // (x >> 1) of the tile (split_x's order).  A q tile's P is CB o L,
      // taken from accumulator register 4kk + 2 (x & 1) + (x >> 1), kept
      // where t <= q (tile-relative: t - row <= 64 (i - j)) and q < Q; the
      // state's is B[t][s] exp(cum_end - cum_t), kept where s < ds.
      const int diag = is_y ? TQ * (it.idx[k] - j) : 0;
      const int s0 = is_y ? 0 : 64 * it.idx[k];
      uint32_t ph[8][4], pl[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int row = row_a + 8 * (x & 1);
          const int tl = 8 * kk + 2 * cq + (x >> 1);
          const float decay =
              exp2_ftz(fmaf(cum_t[tl], -LOG2E, cum_r[k][x & 1]));
          float v;
          if (is_y) {
            v = tl - row <= diag && row < rows[k]
                    ? s[4 * kk + 2 * (x & 1) + (x >> 1)] * decay
                    : 0.f;
          } else {
            const int sc = s0 + row;
            const uint32_t off = (sc >> 5) * ATOM +
                                 sw128(tl, (sc & 31) >> 2) + (sc & 3) * 4;
            v = row < rows[k]
                    ? (*reinterpret_cast<const float*>(sm + L.b_hi + off) +
                       *reinterpret_cast<const float*>(sm + L.b_lo + off)) *
                          decay
                    : 0.f;
          }
          float hi, lo;
          split_tf32(v, hi, lo);
          ph[kk][x] = __float_as_uint(hi);
          pl[kk][x] = __float_as_uint(lo);
        }
      // acc[k] += P . xdt_j, 3xTF32, A from registers.
      fence_regs(acc[k]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        tf32x3_rs<HPP>(acc[k], ph[kk], pl[kk],
                       kmajor_desc(base + L.x_hi, kk, HPP * 128),
                       kmajor_desc(base + L.x_lo, kk, HPP * 128), 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(acc[k]);
    }
  }

  // y rows of the q tiles; state rows s (b, NC, nh, ds, hp).
  float* yb = y + b * ys.b + c * ys.c + h * ys.h;
  float* sb = states + ((b * gridDim.y + c) * dm.nh + h) *
                           static_cast<int64_t>(ds) * hp;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (k >= it.n) continue;
    const bool is_y = it.kind[k] == 0;
    const int64_t r0 = 64 * static_cast<int64_t>(it.idx[k]);
#pragma unroll
    for (int n = 0; n < HPP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + 8 * (e >> 1);
        const int p = 8 * n + 2 * cq + (e & 1);
        if (row >= rows[k] || p >= hp) continue;
        if (is_y) yb[(r0 + row) * ys.q + p] = acc[k][4 * n + e];
        else sb[(r0 + row) * hp + p] = acc[k][4 * n + e];
      }
  }
}

template <int HPP>
int launch(const float* xdt, const float* bm, const float* cm,
           const float* cum, float* y, float* states, int64_t batch,
           int64_t nc, Dims dm, const Strides* st, cudaStream_t stream) {
  const Layout l = layout(dm.hp, dm.ds);
  if (l.bytes > static_cast<uint32_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tf32x3<HPP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (dm.q + TQ - 1) / TQ;
  const dim3 grid(static_cast<unsigned>(
                      dm.nh * blocks_per_head(kItems<HPP>, nq, dm.ds)),
                  static_cast<unsigned>(nc), static_cast<unsigned>(batch));
  ssd_chunk_tf32x3<HPP><<<grid, THREADS, l.bytes, stream>>>(
      xdt, bm, cm, cum, y, states, dm, st[0], st[1], st[2], st[3], st[4]);
  return static_cast<int>(cudaGetLastError());
}

bool rows16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.c % 4 == 0 && s.q % 4 == 0 && s.h % 4 == 0;
}

}  // namespace

// Bytes of dynamic shared memory a launch at (hp, ds) requests (the
// wrapper's check mirrors this).
extern "C" int poas_ssd_chunk_smem(int64_t hp, int64_t ds) {
  return static_cast<int>(
      layout(static_cast<int>(hp), static_cast<int>(ds)).bytes);
}

// Plain C entry point for ctypes.  xdt and y (b, NC, Q, nh, hp); B and C
// (b, NC, Q, G, ds); cum (b, NC, Q, nh); all f32.  states (b, NC, nh, ds,
// hp) f32, contiguous.  Every other tensor has unit stride on its last dim
// and `strides` holds 20 element strides, (b, NC, Q, head-or-group) of
// xdt, B, C, cum and y in that order (cum's head stride is its last).
// xdt, B and C start on 16 bytes with strides that are multiples of 4
// elements (else cudaErrorInvalidValue, nothing launched).  The caller
// checks 1 <= hp, ds <= 128 and nh % G == 0.  The launch is queued on
// `stream` and not synchronised; the return value is cudaGetLastError().
extern "C" int poas_ssd_chunk_f32(const void* xdt, const void* bm,
                                  const void* cm, const void* cum, void* y,
                                  void* states, int64_t batch, int64_t nc,
                                  int64_t q, int64_t nh, int64_t groups,
                                  int64_t hp, int64_t ds,
                                  const int64_t* strides, void* stream) {
  const Dims dm{static_cast<int>(q), static_cast<int>(nh),
                static_cast<int>(groups), static_cast<int>(hp),
                static_cast<int>(ds)};
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
  if (!rows16(xdt, st[0]) || !rows16(bm, st[1]) || !rows16(cm, st[2]))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xdt);
  auto b = static_cast<const float*>(bm);
  auto c = static_cast<const float*>(cm);
  auto m = static_cast<const float*>(cum);
  auto yo = static_cast<float*>(y);
  auto so = static_cast<float*>(states);
  switch (padded_hp(dm.hp)) {
    case 16: return launch<16>(x, b, c, m, yo, so, batch, nc, dm, st, s);
    case 32: return launch<32>(x, b, c, m, yo, so, batch, nc, dm, st, s);
    case 64: return launch<64>(x, b, c, m, yo, so, batch, nc, dm, st, s);
    default: return launch<128>(x, b, c, m, yo, so, batch, nc, dm, st, s);
  }
}
