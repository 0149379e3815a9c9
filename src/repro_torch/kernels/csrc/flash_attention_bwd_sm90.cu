// K2 backward on Hopper's tensor cores: the gradient (dQ, dK, dV) of causal
// / sliding-window GQA flash attention in bf16, every product on wgmma, for
// sm_90a.
//
// Replaces the gradient of src/repro/models/layers.py:90 (flash_attention,
// the model stack's attention), which the reference takes with
// jax.value_and_grad (src/repro/training/step.py:30); the Pallas kernel
// src/repro/kernels/flash_attention.py:70 has no backward.  Inputs: q
// (B, Sq, H, Dk), k (B, Skv, KH, Dk), v (B, Skv, KH, Dv), the forward's
// output o and its gradient dO (B, Sq, H, Dv), all bf16, and each row's
// log-sum-exp of its scaled scores, lse (B, H, Sq) f32, written by the
// forward kernels.  Masks as the forward: causal (q_pos >= k_pos), window
// (k_pos > q_pos - window, 0 = full), padding (k_pos < Skv, q_pos < Sq),
// query row i at position q_offset + i; query head h reads KV head
// h // (H / KH).  Outputs dq, dk, dv in bf16,
// contiguous, written straight from the f32 accumulators.
//
//   P = exp(S * scale - lse) on kept pairs, dV = P^T dO, dP = dO V^T,
//   D = rowsum(dO o O), dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q
//
// This source takes bf16 with Dk, Dv multiples of 16 up to 256, as the
// forward's csrc/flash_attention_sm90.cu does; float32, whose 1e-4 gate
// bf16 operands cannot meet, runs as 3xTF32 in
// csrc/flash_attention_bwd_tf32x3.cu, and bf16 at other head dims on the CUDA
// cores in csrc/flash_attention_bwd.cu.  The wrapper's route_bwd() says
// which, by that rule and nothing else.
//
// What bounds it on this card.  At hymba-1.5B's training shape (4 x 2048
// tokens, 25 / 5 heads of 64) the band holds 1.573e8 (query, key) pairs at
// window 1024 and 2.101e8 at window 0.  The five products need
// 2 * pairs * (3 Dk + 2 Dv) operations: 0.1018 ms and 0.1358 ms at the
// 989 TFLOP/s bf16 tensor-core peak, against ~100 MB of q, k, v, o, dO, dq,
// dk, dv (0.03 ms at 3.35 TB/s) -- operation bound.  This design does seven
// products (the dQ pass recomputes S and dP), 2 * pairs * (4 Dk + 3 Dv):
// 0.1425 ms and 0.1901 ms.  Each pair also takes one exp on the SFU twice
// (once per pass), 16 a clock per SM: ~0.04 ms per pass at window 1024.
// At stablelm-12b's (4 x 2048, 32 / 8 heads of 160, window 0) the five
// products bound it at 0.4345 ms and the seven at 0.6083 ms; the tensor
// work per pair grows with the head dim while the exps do not.
//
// What the design does about it:
//  * Every product on wgmma.m64n64k16, bf16 in, f32 accumulate:
//      S^T = K Q^T and dP^T = V dO^T (dK/dV pass), S = Q K^T and
//      dP = dO V^T (dQ pass): both operands K-major over Dk or Dv, as they
//      lie in memory;
//      dV += P^T dO, dK += dS^T Q, dQ += dS K: P^T, dS^T, dS are the
//      register A operand (the accumulator layout of m64n64 is the A layout
//      of m64k16, exactly as the forward feeds P), dO, Q, K the MN-major B
//      (wgmma's transposed B for 16-bit types) read from the same swizzled
//      tiles the K-major products read.
//  * P and dS are rounded to bf16 only as MMA operands, as every FA2/FA3
//    backward does and as the reference's flash rounds P before P V
//    (src/repro/models/layers.py:143-146); exp, the masks and
//    dS = P o (dP - D) stay in f32 registers.
//  * Deterministic, no atomics.  A pre-pass writes D = rowsum(dO o O).  The
//    dK/dV kernel has one block per (64-key tile, KV head, batch): it walks
//    the H/KH query heads of its KV head and the 64-query tiles of the
//    band, holding dK and dV in registers, so the GQA sum is in-block.  The
//    dQ kernel has one block per (64-query tile, head, batch) and walks the
//    key tiles of the band, holding dQ.  The split costs seven products for
//    five (bound above) and buys the absence of float atomics, so two runs
//    give bit-equal gradients.
//  * The walked tiles (Q, dO, lse and D for dK/dV; K and V for dQ) stream
//    through a two-stage ring of 16-byte cp.async copies in the 128-byte
//    swizzle (zero-filled past Sq / Skv): tile t+1 loads while tile t is in
//    the tensor cores.  No tile is restaged.  A step queues the next
//    tile's copies after its first products are issued, so the copies'
//    issue (which stalls while the L2 is busy) overlaps tensor work, and
//    each thread steps its copies' (row, chunk) without a division.
//  * Tiles wholly outside the causal/window band are skipped (exact);
//    masks are selects on tiles that cross the diagonal, the window edge,
//    Sq or Skv.  by_edge compiles the softmax loop twice, with and without
//    the mask test, so interior tiles do no mask arithmetic: one loop with
//    a run-time edge flag paid the 64-bit position tests on every tile.
//    exp is ex2.approx on log2(e)-scaled scores, as the forward.
//  * Dk and Dv are templates of 64-wide blocks; columns of a block past Dk
//    or Dv are computed and dropped.  Up to two blocks each (Dk, Dv <= 128)
//    the dK/dV kernel is one warpgroup holding dK, dV, S^T and dP^T.
//  * Wider heads (a 64-column count NB = 3 or 4, Dk or Dv in (128, 256]):
//    one warpgroup would hold 32 (2 NB + 2) f32 accumulators a thread, 256
//    at NB = 3 and 320 at NB = 4, past the 255 registers a thread may have.
//    So the wide dK/dV kernel runs two warpgroups (256 threads) on the same
//    64-key tile and splits the products by operand: the first computes
//    S^T = K Q^T and P^T and holds dV += P^T dO, the second computes
//    dP^T = V dO^T and holds dK += dS^T Q, each 32 (NB + 1) accumulators
//    (160 at NB = 4) and each its A operand in its own registers.  P^T
//    crosses from the first to the second once a tile, in f32 through 16 KiB
//    of shared memory (a named barrier the first arrives at and the second
//    waits on), so dS^T = P^T o (dP^T - D) is formed from f32 P as before.
//    The two warpgroups' wgmma work is alike, Dk/16 + 4 NB and Dv/16 +
//    4 NB products a tile.  P^T and dS^T are held in arrays of their own,
//    not written over the S^T and dP^T accumulators: a non-wgmma write to
//    an accumulator makes ptxas serialise the warpgroup's wgmmas (C7515).
//    The dQ kernel
//    stays one warpgroup at NB = 3 (32 (NB + 2) accumulators, 242
//    registers).  At NB = 4 that spills, so there dQ is two warpgroups
//    too: the first computes S and P, the second dP and dS = P o (dP - D),
//    P and dS cross in f32 through shared memory, and each holds two of
//    dQ's column blocks.  The two hops make a step longer than one
//    warpgroup's, which is why NB = 3 keeps the one-warpgroup kernel.
//    Both dims take NB blocks (NB = the larger count), so two kernels a
//    count are built, not one a (Dk, Dv) pair.
//  * Shared memory (poas_flash_bwd_sm90_smem; the wrapper mirrors it):
//    1024 for alignment + 8 KiB a 64 x 64 bf16 block x (Dk + Dv blocks) x
//    (1 + 2 stages), + 2 stages of lse and D (dK/dV), + the 16 KiB f32
//    exchange tiles of the wide kernels (P^T; P and dS).  The larger
//    kernel takes 100,352 B at Dk = Dv = 128 and 165,888 at NB = 3 (dK/dV),
//    230,400 at NB = 4 (dQ), of the 232,448 a block may use.
//
// Later work: one pass with a split dQ reduction (FA2's deterministic
// form), a producer warp with TMA, ping-pong of the two warpgroups.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_tf32x3.cuh"

namespace {

using namespace poas_sm90;

constexpr int BT = 64;            // rows of a query or key tile (one M)
constexpr int THREADS = 128;      // one warpgroup
constexpr int WIDE_THREADS = 256; // the wide dK/dV kernel: two warpgroups
constexpr int ATOM = 64 * 128;    // 64 rows x 128 bytes: 64 bf16 of D
constexpr int STAGES = 2;         // ring depth of the walked tiles
constexpr float LOG2E = 1.4426950408889634f;
constexpr int DOT_THREADS = 256;

using bf16 = __nv_bfloat16;

struct Strides {   // element strides of a (B, S, H, D) tensor; D is unit
  int64_t b, s, h;
};

struct Shape {
  int64_t sq, skv, heads, kv_heads;
  int dk, dv;
  int causal;
  int64_t window;
  float scale;
  int64_t q_offset;   // position of query row 0
};

// 2^x on the SFU, denormal results flushed to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Query row qp (from 0) sits at position q_offset + qp.
__device__ __forceinline__ bool kept(int64_t qp, int64_t kp, const Shape& sh) {
  const int64_t qa = sh.q_offset + qp;
  return qp < sh.sq && kp < sh.skv && (!sh.causal || kp <= qa) &&
         (sh.window <= 0 || kp > qa - sh.window);
}

// f(EdgeTag<true>) on a tile with masked pairs, f(EdgeTag<false>) on an
// interior one: the mask test is compiled only into the first.
template <bool E> struct EdgeTag {
  __device__ constexpr operator bool() const { return E; }
};
template <typename F>
__device__ __forceinline__ void by_edge(bool edge, F&& f) {
  if (edge)
    f(EdgeTag<true>{});
  else
    f(EdgeTag<false>{});
}

// True when some pair of the (rows q0.., keys k0..) 64 x 64 tile is masked.
__device__ __forceinline__ bool edge_tile(int64_t q0, int64_t k0,
                                          const Shape& sh) {
  const int64_t qa0 = sh.q_offset + q0;
  return q0 + BT > sh.sq || k0 + BT > sh.skv ||
         (sh.causal && k0 + BT - 1 > qa0) ||
         (sh.window > 0 && k0 <= qa0 + BT - 1 - sh.window);
}

// Named barrier `id` (1..15; 0 is __syncthreads) over `n` threads: sync
// waits for all n, arrive counts this thread and goes on.  Shared-memory
// writes before an arrive are visible after the matching sync.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// 64 rows x d columns (d a multiple of 8) of a strided bf16 tensor into
// 64-column blocks of ATOM bytes in the 128-byte swizzle; rows past `limit`
// zero-filled.  NT threads share the copies.
template <int NT = THREADS>
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int64_t row0, int64_t limit,
                                          int64_t stride, int d, int tid) {
  // Chunk c of row r for e = r * chunks + c = tid, tid + NT, ...: r and c
  // stepped without a division.
  const int chunks = d / 8;
  const int dr = NT / chunks, dc = NT - dr * chunks;
  int r = tid / chunks, c = tid - r * chunks;
  const bf16* g = src + (row0 + r) * stride + c * 8;
  while (r < BT) {
    const bool ok = row0 + r < limit;
    cp_async16(dst + (c >> 3) * ATOM + sw128(r, c & 7), ok ? g : src,
               ok ? 16 : 0);
    r += dr;
    c += dc;
    g += dr * stride + dc * 8;
    if (c >= chunks) {
      c -= chunks;
      ++r;
      g += stride - chunks * 8;
    }
  }
}

// 64 f32 values from `src` (contiguous) into shared memory, zero past
// `limit`.
__device__ __forceinline__ void load_row_values(uint32_t dst,
                                                const float* src, int64_t r0,
                                                int64_t limit, int tid) {
  if (tid < BT) {
    const bool ok = r0 + tid < limit;
    cp_async4(dst + tid * 4, ok ? src + r0 + tid : src, ok);
  }
}

// The K-major descriptor of k16 step kk of a tile of 64-column blocks.
__device__ __forceinline__ uint64_t kdesc(uint32_t base, int kk) {
  return kmajor_desc(base, kk, ATOM);
}
// The MN-major descriptor of k16 step kk (16 tile rows) of 64-column block
// n: rows are the K of the product, columns its N.
__device__ __forceinline__ uint64_t mndesc(uint32_t base, int n, int kk) {
  return sw128_desc(base + n * ATOM + kk * 2048, ATOM, 1024);
}

// D[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d]: eight lanes a row,
// 16-byte loads (Dv is a multiple of 16, rows start on 16 bytes).
__global__ void __launch_bounds__(DOT_THREADS)
flash_bwd_sm90_dot(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                   float* __restrict__ D, int64_t rows, Shape sh, Strides os,
                   Strides dos) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (DOT_THREADS / 8) +
                      threadIdx.x / 8;
  const int lane = threadIdx.x % 8;
  const bool in = row < rows;
  float acc = 0.f;
  if (in) {
    const int64_t h = row % sh.heads;
    const int64_t q = (row / sh.heads) % sh.sq;
    const int64_t b = row / (sh.heads * sh.sq);
    const uint4* ob = reinterpret_cast<const uint4*>(
        o + b * os.b + q * os.s + h * os.h);
    const uint4* db = reinterpret_cast<const uint4*>(
        dout + b * dos.b + q * dos.s + h * dos.h);
    for (int d = lane; d < sh.dv / 8; d += 8) {
      const uint4 x = ob[d], y = db[d];
      const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yp = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float2 a = __bfloat1622float2(xp[k]);
        const float2 c = __bfloat1622float2(yp[k]);
        acc += a.x * c.x + a.y * c.y;
      }
    }
  }
#pragma unroll
  for (int off = 4; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane == 0) {
    const int64_t h = row % sh.heads;
    const int64_t q = (row / sh.heads) % sh.sq;
    const int64_t b = row / (sh.heads * sh.sq);
    D[(b * sh.heads + h) * sh.sq + q] = acc;
  }
}

// The bf16 A fragments of k16 step kk from an accumulator: registers
// s[8kk + 2x], s[8kk + 2x + 1] (see flash_attention_sm90.cu).
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// bf16_wgmma_n64_rs with an accumulate flag: 0 overwrites d, so the first
// product into an accumulator defines it and no other instruction does.
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{" POAS_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : POAS_D32(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                 "r"(accumulate));
}

template <int NB>
__device__ __forceinline__ void zero(float (&acc)[NB][32]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[n][j] = 0.f;
}

// Rows [r0, r0 + 64) of an accumulator set (NB blocks of 64 columns from
// column c0) times `mul` into a contiguous (rows, heads, d) bf16 tensor at
// head `hd`.
template <int NB>
__device__ __forceinline__ void store_rows(bf16* out, const float (&acc)[NB][32],
                                           float mul, int64_t r0,
                                           int64_t rows, int64_t heads,
                                           int64_t hd, int d, int row,
                                           int cq, int c0 = 0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t p = r0 + row + 8 * r;
    if (p >= rows) continue;
    bf16* o = out + (p * heads + hd) * d;
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = c0 + n * 64 + 8 * i + cq;
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
              acc[n][4 * i + 2 * r] * mul, acc[n][4 * i + 2 * r + 1] * mul);
      }
  }
}

// dK/dV kernel: one block per (64-key tile, KV head, batch).  Its K and V
// tiles stay in shared memory; (Q, dO, lse, D) of each (query head of the
// group, query tile of the band) pass through the ring.  Per step, in the
// accumulator layout with keys as rows and queries as columns:
// S^T = K Q^T, dP^T = V dO^T, P^T = exp(S^T scale - lse), dS^T =
// P^T o (dP^T - D); dV += P^T dO, dK += dS^T Q.
template <int DKB, int DVB>
__global__ void __launch_bounds__(THREADS, DKB + DVB <= 2 ? 2 : 1)
flash_bwd_sm90_dkdv(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Shape sh, Strides qs, Strides ks,
                    Strides vs, Strides dos) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_smem = k_smem + DKB * ATOM;
  const uint32_t ring = v_smem + DVB * ATOM;   // stage: Q, then dO
  constexpr uint32_t kStage = (DKB + DVB) * ATOM;
  const uint32_t vals = ring + STAGES * kStage;   // stage: lse, then D
  const float* vals_ptr = reinterpret_cast<const float*>(
      smem_raw + (vals - smem_addr(smem_raw)));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4;   // and row + 8: keys of the tile
  const int cq = 2 * (lane % 4);
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kh = blockIdx.y, b = blockIdx.z;
  const int64_t group = sh.heads / sh.kv_heads;

  // The query rows of this key tile's band (row i at position q_offset +
  // i); tiles outside it are skipped.
  const int64_t k_last = (k0 + BT < sh.skv ? k0 + BT : sh.skv) - 1;
  int64_t q_begin = sh.causal && k0 > sh.q_offset ? k0 - sh.q_offset : 0;
  q_begin -= q_begin % BT;
  int64_t q_end = sh.sq;
  if (sh.window > 0 && k_last + sh.window - sh.q_offset < q_end)
    q_end = k_last + sh.window - sh.q_offset;
  const int nqt = q_end > q_begin
      ? static_cast<int>((q_end - q_begin + BT - 1) / BT) : 0;
  const int n_it = static_cast<int>(group) * nqt;

  auto load_it = [&](int it) {
    const int64_t h = kh * group + it / nqt;
    const int64_t q0 = q_begin + static_cast<int64_t>(it % nqt) * BT;
    const uint32_t st = ring + (it % STAGES) * kStage;
    load_rows(st, q + b * qs.b + h * qs.h, q0, sh.sq, qs.s, sh.dk, tid);
    load_rows(st + DKB * ATOM, dout + b * dos.b + h * dos.h, q0, sh.sq,
              dos.s, sh.dv, tid);
    const uint32_t vs_ = vals + (it % STAGES) * 2 * BT * 4;
    const int64_t base = (b * sh.heads + h) * sh.sq;
    load_row_values(vs_, lse + base, q0, sh.sq, tid);
    load_row_values(vs_ + BT * 4, D + base, q0, sh.sq, tid);
  };
  load_rows(k_smem, k + b * ks.b + kh * ks.h, k0, sh.skv, ks.s, sh.dk, tid);
  load_rows(v_smem, v + b * vs.b + kh * vs.h, k0, sh.skv, vs.s, sh.dv, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_it) load_it(t);
    cp_async_commit();   // one group per step, empty or not
  }

  float acc_k[DKB][32], acc_v[DVB][32], s[32], dp[32];
  zero(acc_k);
  zero(acc_v);
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
  const float sl2 = sh.scale * LOG2E;
  const int ksteps = sh.dk / 16, vsteps = sh.dv / 16;

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of step it landed
    fence_proxy_async();
    __syncthreads();   // everyone's landed; step it-1's stage is free

    const uint32_t q_st = ring + (it % STAGES) * kStage;
    const uint32_t do_st = q_st + DKB * ATOM;
    const float* lse_t = vals_ptr + (it % STAGES) * 2 * BT;
    const float* d_t = lse_t + BT;
    const int64_t q0 = q_begin + static_cast<int64_t>(it % nqt) * BT;

    // S^T = K Q^T and dP^T = V dO^T, K-major over Dk and Dv.
    wg_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      bf16_wgmma_n64_ss(s, kdesc(k_smem, kk), kdesc(q_st, kk), kk > 0);
    for (int kk = 0; kk < vsteps; ++kk)
      bf16_wgmma_n64_ss(dp, kdesc(v_smem, kk), kdesc(do_st, kk), kk > 0);
    wg_commit();
    // The next tile's copies, queued while the tensor cores work.
    if (it + STAGES - 1 < n_it) load_it(it + STAGES - 1);
    cp_async_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T in place; column j of register 4i + e is query
    // q0 + 8i + cq + (e & 1), its row key k0 + row + 8 (e >> 1).
    by_edge(edge_tile(q0, k0, sh), [&](auto edge) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + 8 * i + cq);
        const float2 dd = *reinterpret_cast<const float2*>(d_t + 8 * i + cq);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * i + e;
          float p = exp2_ftz(fmaf(s[j], sl2, -(e & 1 ? l2.y : l2.x) * LOG2E));
          if (edge && !kept(q0 + 8 * i + cq + (e & 1), k0 + row + 8 * (e >> 1),
                            sh))
            p = 0.f;
          s[j] = p;
          dp[j] = p * (dp[j] - (e & 1 ? dd.y : dd.x));
        }
      }
    });
    uint32_t pa[4][4], da[4][4];
    to_a(pa, s);
    to_a(da, dp);

    // dV += P^T dO, dK += dS^T Q: dO and Q read MN-major, 16 queries a step.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < DVB; ++n)
        bf16_wgmma_n64_rs(acc_v[n], pa[kk], mndesc(do_st, n, kk));
#pragma unroll
      for (int n = 0; n < DKB; ++n)
        bf16_wgmma_n64_rs(acc_k[n], da[kk], mndesc(q_st, n, kk));
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < DVB; ++n) fence_regs(acc_v[n]);
#pragma unroll
    for (int n = 0; n < DKB; ++n) fence_regs(acc_k[n]);
  }
  cp_async_wait<0>();

  // Every key row of the tile is written, zero where no query sees it.
  store_rows(dk + b * sh.skv * sh.kv_heads * sh.dk, acc_k, sh.scale, k0,
             sh.skv, sh.kv_heads, kh, sh.dk, row, cq);
  store_rows(dv + b * sh.skv * sh.kv_heads * sh.dv, acc_v, 1.f, k0, sh.skv,
             sh.kv_heads, kh, sh.dv, row, cq);
}

// The wide dK/dV kernel (Dk or Dv in (128, 256], NB 64-column blocks of
// each): one block of two warpgroups per (64-key tile, KV head, batch),
// walking the band as flash_bwd_sm90_dkdv does.  Warpgroup 0 computes
// S^T = K Q^T, P^T = exp(S^T scale - lse), hands P^T to warpgroup 1 in f32
// through shared memory and holds dV += P^T dO; warpgroup 1 computes
// dP^T = V dO^T, dS^T = P^T o (dP^T - D) and holds dK += dS^T Q.  Named
// barrier 1 (all 256 threads) opens each step of the ring; barrier 2 passes
// P^T (warpgroup 0 arrives, warpgroup 1 waits).  Each role is its own loop,
// so each thread keeps only its own accumulators live, and only wgmma
// writes an accumulator (the first product into dV or dK overwrites it;
// P^T and dS^T get arrays of their own).
template <int NB>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_sm90_dkdv_wide(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ D, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Shape sh, Strides qs,
                         Strides ks, Strides vs, Strides dos) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t k_smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t v_smem = k_smem + NB * ATOM;
  const uint32_t ring = v_smem + NB * ATOM;   // stage: Q, then dO
  constexpr uint32_t kStage = 2 * NB * ATOM;
  const uint32_t vals = ring + STAGES * kStage;   // stage: lse, then D
  const uint32_t pex = vals + STAGES * 2 * BT * 4;   // P^T, 64 x 64 f32
  const float* vals_ptr = reinterpret_cast<const float*>(
      smem_raw + (vals - smem_addr(smem_raw)));
  float4* pex_ptr = reinterpret_cast<float4*>(
      smem_raw + (pex - smem_addr(smem_raw)));

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int row = warp * 16 + lane / 4;   // and row + 8: keys of the tile
  const int cq = 2 * (lane % 4);
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kh = blockIdx.y, b = blockIdx.z;
  const int64_t group = sh.heads / sh.kv_heads;

  const int64_t k_last = (k0 + BT < sh.skv ? k0 + BT : sh.skv) - 1;
  int64_t q_begin = sh.causal && k0 > sh.q_offset ? k0 - sh.q_offset : 0;
  q_begin -= q_begin % BT;
  int64_t q_end = sh.sq;
  if (sh.window > 0 && k_last + sh.window - sh.q_offset < q_end)
    q_end = k_last + sh.window - sh.q_offset;
  const int nqt = q_end > q_begin
      ? static_cast<int>((q_end - q_begin + BT - 1) / BT) : 0;
  const int n_it = static_cast<int>(group) * nqt;

  // Both warpgroups share every copy; each commits one group a step.
  auto load_it = [&](int it) {
    const int64_t h = kh * group + it / nqt;
    const int64_t q0 = q_begin + static_cast<int64_t>(it % nqt) * BT;
    const uint32_t st = ring + (it % STAGES) * kStage;
    load_rows<WIDE_THREADS>(st, q + b * qs.b + h * qs.h, q0, sh.sq, qs.s,
                            sh.dk, tid);
    load_rows<WIDE_THREADS>(st + NB * ATOM, dout + b * dos.b + h * dos.h, q0,
                            sh.sq, dos.s, sh.dv, tid);
    const uint32_t vs_ = vals + (it % STAGES) * 2 * BT * 4;
    const int64_t base = (b * sh.heads + h) * sh.sq;
    load_row_values(vs_, lse + base, q0, sh.sq, tid);
    load_row_values(vs_ + BT * 4, D + base, q0, sh.sq, tid);
  };
  // Step it's tile landed for every thread, the previous step's stage and
  // P^T free.
  auto open_step = [&]() {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    bar_sync(1, WIDE_THREADS);
  };
  // The next tile's copies, queued once a step's first products are in the
  // tensor cores.
  auto queue_next = [&](int it) {
    if (it + STAGES - 1 < n_it) load_it(it + STAGES - 1);
    cp_async_commit();
  };
  load_rows<WIDE_THREADS>(k_smem, k + b * ks.b + kh * ks.h, k0, sh.skv, ks.s,
                          sh.dk, tid);
  load_rows<WIDE_THREADS>(v_smem, v + b * vs.b + kh * vs.h, k0, sh.skv, vs.s,
                          sh.dv, tid);
#pragma unroll
  for (int s0 = 0; s0 < STAGES - 1; ++s0) {
    if (s0 < n_it) load_it(s0);
    cp_async_commit();
  }
  const float sl2 = sh.scale * LOG2E;

  if (wg == 0) {
    // S^T, P^T; dV += P^T dO.
    float acc[NB][32], s[32], pv[32];
    const int ksteps = sh.dk / 16;
    for (int it = 0; it < n_it; ++it) {
      open_step();
      const uint32_t q_st = ring + (it % STAGES) * kStage;
      const uint32_t do_st = q_st + NB * ATOM;
      const float* lse_t = vals_ptr + (it % STAGES) * 2 * BT;
      const int64_t q0 = q_begin + static_cast<int64_t>(it % nqt) * BT;

      wg_fence();
      for (int kk = 0; kk < ksteps; ++kk)
        bf16_wgmma_n64_ss(s, kdesc(k_smem, kk), kdesc(q_st, kk), kk > 0);
      wg_commit();
      queue_next(it);
      wg_wait<0>();
      fence_regs(s);

      // P^T in place; column j of register 4i + e is query
      // q0 + 8i + cq + (e & 1), its row key k0 + row + 8 (e >> 1).
      by_edge(edge_tile(q0, k0, sh), [&](auto edge) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float2 l2 =
              *reinterpret_cast<const float2*>(lse_t + 8 * i + cq);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * i + e;
            float p =
                exp2_ftz(fmaf(s[j], sl2, -(e & 1 ? l2.y : l2.x) * LOG2E));
            if (edge && !kept(q0 + 8 * i + cq + (e & 1),
                              k0 + row + 8 * (e >> 1), sh))
              p = 0.f;
            pv[j] = p;
          }
          pex_ptr[i * 128 + t] = make_float4(pv[4 * i], pv[4 * i + 1],
                                             pv[4 * i + 2], pv[4 * i + 3]);
        }
      });
      bar_arrive(2, WIDE_THREADS);
      uint32_t pa[4][4];
      to_a(pa, pv);

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          wgmma_rs(acc[n], pa[kk], mndesc(do_st, n, kk), it > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
    }
    cp_async_wait<0>();
    if (n_it == 0) zero(acc);
    store_rows(dv + b * sh.skv * sh.kv_heads * sh.dv, acc, 1.f, k0, sh.skv,
               sh.kv_heads, kh, sh.dv, row, cq);
  } else {
    // dP^T, dS^T; dK += dS^T Q.
    float acc[NB][32], dp[32], ds[32];
    const int vsteps = sh.dv / 16;
    for (int it = 0; it < n_it; ++it) {
      open_step();
      const uint32_t q_st = ring + (it % STAGES) * kStage;
      const uint32_t do_st = q_st + NB * ATOM;
      const float* d_t = vals_ptr + (it % STAGES) * 2 * BT + BT;

      wg_fence();
      for (int kk = 0; kk < vsteps; ++kk)
        bf16_wgmma_n64_ss(dp, kdesc(v_smem, kk), kdesc(do_st, kk), kk > 0);
      wg_commit();
      queue_next(it);
      wg_wait<0>();
      fence_regs(dp);

      bar_sync(2, WIDE_THREADS);   // P^T of this step is in pex
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p = pex_ptr[i * 128 + t];
        const float2 dd = *reinterpret_cast<const float2*>(d_t + 8 * i + cq);
        ds[4 * i] = p.x * (dp[4 * i] - dd.x);
        ds[4 * i + 1] = p.y * (dp[4 * i + 1] - dd.y);
        ds[4 * i + 2] = p.z * (dp[4 * i + 2] - dd.x);
        ds[4 * i + 3] = p.w * (dp[4 * i + 3] - dd.y);
      }
      uint32_t da[4][4];
      to_a(da, ds);

      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          wgmma_rs(acc[n], da[kk], mndesc(q_st, n, kk), it > 0 || kk > 0);
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int n = 0; n < NB; ++n) fence_regs(acc[n]);
    }
    cp_async_wait<0>();
    if (n_it == 0) zero(acc);
    store_rows(dk + b * sh.skv * sh.kv_heads * sh.dk, acc, sh.scale, k0,
               sh.skv, sh.kv_heads, kh, sh.dk, row, cq);
  }
}

// dQ kernel: one block per (64-query tile, head, batch).  Q, dO stay in
// shared memory, lse and D of the block's rows in registers; the K and V
// tiles of the band pass through the ring.  Per tile, queries as rows:
// S = Q K^T, dP = dO V^T, P = exp(S scale - lse), dS = P o (dP - D);
// dQ += dS K.
template <int DKB, int DVB>
__global__ void __launch_bounds__(THREADS, 2)
flash_bwd_sm90_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ D,
                  bf16* __restrict__ dq, Shape sh, Strides qs, Strides ks,
                  Strides vs, Strides dos) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_smem = q_smem + DKB * ATOM;
  const uint32_t ring = do_smem + DVB * ATOM;   // stage: K, then V
  constexpr uint32_t kStage = (DKB + DVB) * ATOM;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4;   // and row + 8: queries of the tile
  const int cq = 2 * (lane % 4);
  // The latest query tiles (the longest causal rows) first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BT;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / (sh.heads / sh.kv_heads);
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  // The key band of this query tile (positions qa0..qa_last); tiles
  // outside it are skipped.
  const int64_t qa0 = sh.q_offset + q0;
  const int64_t qa_last = sh.q_offset + (q0 + BT < sh.sq ? q0 + BT : sh.sq) - 1;
  int64_t kv_end = sh.skv;
  if (sh.causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (sh.window > 0 && qa0 - sh.window + 1 > 0) kv_begin = qa0 - sh.window + 1;
  kv_begin -= kv_begin % BT;
  const int n_tiles = kv_end > kv_begin
      ? static_cast<int>((kv_end - kv_begin + BT - 1) / BT) : 0;

  auto load_kv = [&](int t) {
    const uint32_t st = ring + (t % STAGES) * kStage;
    const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BT;
    load_rows(st, kb, k0, sh.skv, ks.s, sh.dk, tid);
    load_rows(st + DKB * ATOM, vb, k0, sh.skv, vs.s, sh.dv, tid);
  };
  load_rows(q_smem, q + b * qs.b + h * qs.h, q0, sh.sq, qs.s, sh.dk, tid);
  load_rows(do_smem, dout + b * dos.b + h * dos.h, q0, sh.sq, dos.s, sh.dv,
            tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();
  }

  // lse (log2-scaled) and D of this thread's two rows.
  float l2[2], dr[2];
  const int64_t base = (b * sh.heads + h) * sh.sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = q0 + row + 8 * r;
    l2[r] = qp < sh.sq ? lse[base + qp] * LOG2E : 0.f;
    dr[r] = qp < sh.sq ? D[base + qp] : 0.f;
  }

  float acc[DKB][32], s[32], dp[32];
  zero(acc);
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = dp[j] = 0.f;
  const float sl2 = sh.scale * LOG2E;
  const int ksteps = sh.dk / 16, vsteps = sh.dv / 16;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();

    const uint32_t k_st = ring + (t % STAGES) * kStage;
    const uint32_t v_st = k_st + DKB * ATOM;
    const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BT;

    // S = Q K^T and dP = dO V^T, K-major over Dk and Dv.
    wg_fence();
    for (int kk = 0; kk < ksteps; ++kk)
      bf16_wgmma_n64_ss(s, kdesc(q_smem, kk), kdesc(k_st, kk), kk > 0);
    for (int kk = 0; kk < vsteps; ++kk)
      bf16_wgmma_n64_ss(dp, kdesc(do_smem, kk), kdesc(v_st, kk), kk > 0);
    wg_commit();
    // The next tile's copies, queued while the tensor cores work.
    if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1);
    cp_async_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS in place of dP; register 4i + e is query q0 + row + 8 (e >> 1),
    // key k0 + 8i + cq + (e & 1).
    by_edge(edge_tile(q0, k0, sh), [&](auto edge) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j & 3) >> 1;
        float p = exp2_ftz(fmaf(s[j], sl2, -l2[r]));
        if (edge && !kept(q0 + row + 8 * r, k0 + 8 * (j >> 2) + cq + (j & 1),
                          sh))
          p = 0.f;
        dp[j] = p * (dp[j] - dr[r]);
      }
    });
    uint32_t da[4][4];
    to_a(da, dp);

    // dQ += dS K: K read MN-major, 16 keys a step.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < DKB; ++n)
        bf16_wgmma_n64_rs(acc[n], da[kk], mndesc(k_st, n, kk));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < DKB; ++n) fence_regs(acc[n]);
  }
  cp_async_wait<0>();

  store_rows(dq + b * sh.sq * sh.heads * sh.dk, acc, sh.scale, q0, sh.sq,
             sh.heads, h, sh.dk, row, cq);
}

// The wide dQ kernel (NB = 4 blocks): one block of two warpgroups per
// (64-query tile, head, batch), walking the key band as flash_bwd_sm90_dq
// does.  Warpgroup 0 computes S = Q K^T and P, warpgroup 1 dP = dO V^T and
// dS = P o (dP - D), both in f32 through shared memory (P over barrier 2,
// dS back over barrier 3); then each rounds dS to bf16 and holds its share
// of dQ += dS K: warpgroup 0 the first H0 = ceil(NB / 2) column blocks,
// warpgroup 1 the rest.  One warpgroup holding all of dQ beside S and dP
// needs 32 (NB + 2) accumulators, which spills at NB = 4.  The same sums in
// the same order as flash_bwd_sm90_dq, so its gradients are that kernel's
// bit for bit.
template <int NB>
__global__ void __launch_bounds__(WIDE_THREADS, 1)
flash_bwd_sm90_dq_wide(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ D, bf16* __restrict__ dq,
                       Shape sh, Strides qs, Strides ks, Strides vs,
                       Strides dos) {
  constexpr int H0 = (NB + 1) / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t do_smem = q_smem + NB * ATOM;
  const uint32_t ring = do_smem + NB * ATOM;   // stage: K, then V
  constexpr uint32_t kStage = 2 * NB * ATOM;
  const uint32_t pex = ring + STAGES * kStage;   // P, 64 x 64 f32
  const uint32_t dsx = pex + BT * BT * 4;        // dS, 64 x 64 f32
  float4* pex_ptr = reinterpret_cast<float4*>(
      smem_raw + (pex - smem_addr(smem_raw)));
  float4* dsx_ptr = reinterpret_cast<float4*>(
      smem_raw + (dsx - smem_addr(smem_raw)));

  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  const int row = warp * 16 + lane / 4;   // and row + 8: queries of the tile
  const int cq = 2 * (lane % 4);
  // The latest query tiles (the longest causal rows) first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BT;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / (sh.heads / sh.kv_heads);
  const bf16* kb = k + b * ks.b + kh * ks.h;
  const bf16* vb = v + b * vs.b + kh * vs.h;

  const int64_t qa0 = sh.q_offset + q0;
  const int64_t qa_last = sh.q_offset + (q0 + BT < sh.sq ? q0 + BT : sh.sq) - 1;
  int64_t kv_end = sh.skv;
  if (sh.causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (sh.window > 0 && qa0 - sh.window + 1 > 0) kv_begin = qa0 - sh.window + 1;
  kv_begin -= kv_begin % BT;
  const int n_tiles = kv_end > kv_begin
      ? static_cast<int>((kv_end - kv_begin + BT - 1) / BT) : 0;

  auto load_kv = [&](int it) {
    const uint32_t st = ring + (it % STAGES) * kStage;
    const int64_t k0 = kv_begin + static_cast<int64_t>(it) * BT;
    load_rows<WIDE_THREADS>(st, kb, k0, sh.skv, ks.s, sh.dk, tid);
    load_rows<WIDE_THREADS>(st + NB * ATOM, vb, k0, sh.skv, vs.s, sh.dv,
                            tid);
  };
  auto open_step = [&]() {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    bar_sync(1, WIDE_THREADS);
  };
  auto queue_next = [&](int it) {
    if (it + STAGES - 1 < n_tiles) load_kv(it + STAGES - 1);
    cp_async_commit();
  };
  load_rows<WIDE_THREADS>(q_smem, q + b * qs.b + h * qs.h, q0, sh.sq, qs.s,
                          sh.dk, tid);
  load_rows<WIDE_THREADS>(do_smem, dout + b * dos.b + h * dos.h, q0, sh.sq,
                          dos.s, sh.dv, tid);
#pragma unroll
  for (int s0 = 0; s0 < STAGES - 1; ++s0) {
    if (s0 < n_tiles) load_kv(s0);
    cp_async_commit();
  }
  const int64_t base = (b * sh.heads + h) * sh.sq;

  // dQ += dS K over this warpgroup's column blocks nb0 .. nb0 + NW - 1,
  // with dS read back from shared memory.
  auto dq_step = [&](auto& acc, int it, uint32_t k_st, int nb0) {
    float dsr[32];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 x = dsx_ptr[i * 128 + t];
      dsr[4 * i] = x.x;
      dsr[4 * i + 1] = x.y;
      dsr[4 * i + 2] = x.z;
      dsr[4 * i + 3] = x.w;
    }
    uint32_t da[4][4];
    to_a(da, dsr);
    constexpr int NW = sizeof(acc) / sizeof(acc[0]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NW; ++n)
        wgmma_rs(acc[n], da[kk], mndesc(k_st, nb0 + n, kk), it > 0 || kk > 0);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < NW; ++n) fence_regs(acc[n]);
  };

  if (wg == 0) {
    // S, P; dQ's first H0 blocks.
    float l2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t qp = q0 + row + 8 * r;
      l2[r] = qp < sh.sq ? lse[base + qp] * LOG2E : 0.f;
    }
    float acc[H0][32], s[32];
    const float sl2 = sh.scale * LOG2E;
    const int ksteps = sh.dk / 16;
    for (int it = 0; it < n_tiles; ++it) {
      open_step();
      const uint32_t k_st = ring + (it % STAGES) * kStage;
      const int64_t k0 = kv_begin + static_cast<int64_t>(it) * BT;
      wg_fence();
      for (int kk = 0; kk < ksteps; ++kk)
        bf16_wgmma_n64_ss(s, kdesc(q_smem, kk), kdesc(k_st, kk), kk > 0);
      wg_commit();
      queue_next(it);
      wg_wait<0>();
      fence_regs(s);
      // Register 4i + e is query q0 + row + 8 (e >> 1), key
      // k0 + 8i + cq + (e & 1).
      by_edge(edge_tile(q0, k0, sh), [&](auto edge) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float pv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * i + e, r = e >> 1;
            float p = exp2_ftz(fmaf(s[j], sl2, -l2[r]));
            if (edge && !kept(q0 + row + 8 * r, k0 + 8 * i + cq + (e & 1),
                              sh))
              p = 0.f;
            pv[e] = p;
          }
          pex_ptr[i * 128 + t] = make_float4(pv[0], pv[1], pv[2], pv[3]);
        }
      });
      bar_arrive(2, WIDE_THREADS);
      bar_sync(3, WIDE_THREADS);   // dS of this tile is in dsx
      dq_step(acc, it, k_st, 0);
    }
    cp_async_wait<0>();
    if (n_tiles == 0) zero(acc);
    store_rows(dq + b * sh.sq * sh.heads * sh.dk, acc, sh.scale, q0, sh.sq,
               sh.heads, h, sh.dk, row, cq);
  } else {
    // dP, dS; dQ's last NB - H0 blocks.
    float dr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t qp = q0 + row + 8 * r;
      dr[r] = qp < sh.sq ? D[base + qp] : 0.f;
    }
    float acc[NB - H0][32], dp[32];
    const int vsteps = sh.dv / 16;
    for (int it = 0; it < n_tiles; ++it) {
      open_step();
      const uint32_t k_st = ring + (it % STAGES) * kStage;
      const uint32_t v_st = k_st + NB * ATOM;
      wg_fence();
      for (int kk = 0; kk < vsteps; ++kk)
        bf16_wgmma_n64_ss(dp, kdesc(do_smem, kk), kdesc(v_st, kk), kk > 0);
      wg_commit();
      queue_next(it);
      wg_wait<0>();
      fence_regs(dp);
      bar_sync(2, WIDE_THREADS);   // P of this tile is in pex
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 p = pex_ptr[i * 128 + t];
        dsx_ptr[i * 128 + t] = make_float4(
            p.x * (dp[4 * i] - dr[0]), p.y * (dp[4 * i + 1] - dr[0]),
            p.z * (dp[4 * i + 2] - dr[1]), p.w * (dp[4 * i + 3] - dr[1]));
      }
      bar_arrive(3, WIDE_THREADS);
      dq_step(acc, it, k_st, H0);
    }
    cp_async_wait<0>();
    if (n_tiles == 0) zero(acc);
    store_rows(dq + b * sh.sq * sh.heads * sh.dk, acc, sh.scale, q0, sh.sq,
               sh.heads, h, sh.dk, row, cq, H0 * 64);
  }
}

// Dynamic shared memory of the dK/dV block (the larger of the two): K and
// V, the ring of Q and dO, the ring's lse and D; + 1024 for the swizzle's
// alignment.
size_t smem_dkdv(int dkb, int dvb) {
  return 1024 + static_cast<size_t>(ATOM) * (dkb + dvb) * (1 + STAGES) +
         STAGES * 2 * BT * 4;
}
size_t smem_dq(int dkb, int dvb) {
  return 1024 + static_cast<size_t>(ATOM) * (dkb + dvb) * (1 + STAGES);
}
// The wide blocks: as above at NB blocks each, + the f32 exchange tiles
// (P^T for dK/dV; P and dS for dQ).
size_t smem_dkdv_wide(int nb) {
  return smem_dkdv(nb, nb) + BT * BT * 4;
}
size_t smem_dq_wide(int nb) {
  return smem_dq(nb, nb) + 2 * BT * BT * 4;
}

// DKB, DVB <= 2: the one-warpgroup kernels; WIDE: the two-warpgroup dK/dV
// kernel at NB = DKB = DVB blocks, with the one-warpgroup dQ kernel at
// NB = 3 and the two-warpgroup one at NB = 4.
template <int DKB, int DVB, bool WIDE = false>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
           const bf16* dout, const float* lse, bf16* dq, bf16* dk, bf16* dv,
           float* D, int64_t batch, const Shape& sh, const int64_t* st,
           cudaStream_t stream) {
  static_assert(!WIDE || DKB == DVB, "the wide kernel takes NB blocks each");
  constexpr bool kWideDq = WIDE && DKB == 4;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  const int sa = static_cast<int>(WIDE ? smem_dkdv_wide(DKB)
                                       : smem_dkdv(DKB, DVB));
  const int sb = static_cast<int>(kWideDq ? smem_dq_wide(DKB)
                                          : smem_dq(DKB, DVB));
  cudaError_t err;
  if constexpr (WIDE)
    err = cudaFuncSetAttribute(flash_bwd_sm90_dkdv_wide<DKB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sa);
  else
    err = cudaFuncSetAttribute(flash_bwd_sm90_dkdv<DKB, DVB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sa);
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kWideDq)
    err = cudaFuncSetAttribute(flash_bwd_sm90_dq_wide<DKB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sb);
  else
    err = cudaFuncSetAttribute(flash_bwd_sm90_dq<DKB, DVB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               sb);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = batch * sh.sq * sh.heads;
  const int per_block = DOT_THREADS / 8;
  flash_bwd_sm90_dot<<<static_cast<unsigned>(
      (rows + per_block - 1) / per_block), DOT_THREADS, 0, stream>>>(
      o, dout, D, rows, sh, os, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a(static_cast<unsigned>((sh.skv + BT - 1) / BT),
                    static_cast<unsigned>(sh.kv_heads),
                    static_cast<unsigned>(batch));
  if constexpr (WIDE)
    flash_bwd_sm90_dkdv_wide<DKB><<<grid_a, WIDE_THREADS, sa, stream>>>(
        q, k, v, dout, lse, D, dk, dv, sh, qs, ks, vs, dos);
  else
    flash_bwd_sm90_dkdv<DKB, DVB><<<grid_a, THREADS, sa, stream>>>(
        q, k, v, dout, lse, D, dk, dv, sh, qs, ks, vs, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(static_cast<unsigned>((sh.sq + BT - 1) / BT),
                    static_cast<unsigned>(sh.heads),
                    static_cast<unsigned>(batch));
  if constexpr (kWideDq)
    flash_bwd_sm90_dq_wide<DKB><<<grid_b, WIDE_THREADS, sb, stream>>>(
        q, k, v, dout, lse, D, dq, sh, qs, ks, vs, dos);
  else
    flash_bwd_sm90_dq<DKB, DVB><<<grid_b, THREADS, sb, stream>>>(
        q, k, v, dout, lse, D, dq, sh, qs, ks, vs, dos);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, const int64_t* st, int n) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < n; ++i)
    if (st[i] % 8) return false;
  return true;
}

}  // namespace

// Bytes of dynamic shared memory the larger of the two main kernels
// requests at head dims dk, dv, as launch() picks them: the dK/dV kernel up
// to NB = 3, the two-warpgroup dQ kernel at NB = 4.
extern "C" int poas_flash_bwd_sm90_smem(int64_t dk, int64_t dv) {
  const int dkb = static_cast<int>((dk + 63) / 64);
  const int dvb = static_cast<int>((dv + 63) / 64);
  const int nb = dkb > dvb ? dkb : dvb;
  const size_t a = nb > 2 ? smem_dkdv_wide(nb) : smem_dkdv(dkb, dvb);
  const size_t b = nb == 4 ? smem_dq_wide(nb)
                           : smem_dq(nb > 2 ? nb : dkb, nb > 2 ? nb : dvb);
  return static_cast<int>(a > b ? a : b);
}

// Plain C entry point for ctypes.  q (B, Sq, H, Dk), k (B, Skv, KH, Dk),
// v (B, Skv, KH, Dv), o and dout (B, Sq, H, Dv), bf16, each with unit
// stride on its last dim, 16-byte aligned base and (batch, seq, head)
// strides that are multiples of 8 elements; lse (B, H, Sq) f32
// contiguous; dq (B, Sq, H, Dk), dk (B, Skv, KH, Dk), dv (B, Skv, KH, Dv)
// bf16 contiguous outputs (every element written); D (B, H, Sq) f32
// scratch.  `strides` holds 15 element strides: (batch, seq, head) of q,
// k, v, o, dout in that order; q_offset >= 0 is the position of query row
// 0.  The caller checks H % KH == 0.  Three kernels are queued on
// `stream` and not synchronised; the return value is the first launch
// error, or cudaErrorInvalidValue for head dims other than 16, 32, ...,
// 256 or unaligned operands (nothing launched).
extern "C" int poas_flash_bwd_sm90_bf16(const void* q, const void* k,
                                        const void* v, const void* o,
                                        const void* dout, const void* lse,
                                        void* dq, void* dk, void* dv, void* D,
                                        int64_t batch, int64_t sq,
                                        int64_t skv, int64_t heads,
                                        int64_t kv_heads, int64_t dk_dim,
                                        int64_t dv_dim,
                                        const int64_t* strides,
                                        int64_t causal, int64_t window,
                                        float scale, int64_t q_offset,
                                        void* stream) {
  if (dk_dim < 16 || dk_dim > 256 || dk_dim % 16 || dv_dim < 16 ||
      dv_dim > 256 || dv_dim % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* ptrs[5] = {q, k, v, o, dout};
  for (int i = 0; i < 5; ++i)
    if (!aligned(ptrs[i], strides + 3 * i, 3))
      return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, skv, heads, kv_heads, static_cast<int>(dk_dim),
                 static_cast<int>(dv_dim), static_cast<int>(causal), window,
                 scale, q_offset};
  auto s = static_cast<cudaStream_t>(stream);
  auto cq = static_cast<const bf16*>(q);
  auto ck = static_cast<const bf16*>(k);
  auto cv = static_cast<const bf16*>(v);
  auto co = static_cast<const bf16*>(o);
  auto cd = static_cast<const bf16*>(dout);
  auto cl = static_cast<const float*>(lse);
  auto gq = static_cast<bf16*>(dq);
  auto gk = static_cast<bf16*>(dk);
  auto gv = static_cast<bf16*>(dv);
  auto fD = static_cast<float*>(D);
  const int dkb = static_cast<int>((dk_dim + 63) / 64);
  const int dvb = static_cast<int>((dv_dim + 63) / 64);
  if (dkb > 2 || dvb > 2) {
    if (dkb == 4 || dvb == 4)
      return launch<4, 4, true>(cq, ck, cv, co, cd, cl, gq, gk, gv, fD, batch,
                                sh, strides, s);
    return launch<3, 3, true>(cq, ck, cv, co, cd, cl, gq, gk, gv, fD, batch,
                              sh, strides, s);
  }
  if (dkb == 1 && dvb == 1)
    return launch<1, 1>(cq, ck, cv, co, cd, cl, gq, gk, gv, fD, batch, sh,
                        strides, s);
  if (dkb == 1)
    return launch<1, 2>(cq, ck, cv, co, cd, cl, gq, gk, gv, fD, batch, sh,
                        strides, s);
  if (dvb == 1)
    return launch<2, 1>(cq, ck, cv, co, cd, cl, gq, gk, gv, fD, batch, sh,
                        strides, s);
  return launch<2, 2>(cq, ck, cv, co, cd, cl, gq, gk, gv, fD, batch, sh,
                      strides, s);
}
