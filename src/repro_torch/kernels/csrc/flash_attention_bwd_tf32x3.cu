// K2 backward on Hopper's tensor cores in float32: the gradient (dQ, dK, dV)
// of causal / sliding-window GQA flash attention, every product as 3xTF32
// wgmma, for sm_90a.
//
// Replaces the gradient of src/repro/models/layers.py:90 (flash_attention,
// the model stack's attention), which the reference takes with
// jax.value_and_grad (src/repro/training/step.py:30); the Pallas kernel
// src/repro/kernels/flash_attention.py:70 has no backward.  Inputs: q
// (B, Sq, H, Dk), k (B, Skv, KH, Dk), v (B, Skv, KH, Dv), the forward's
// output o and its gradient dO (B, Sq, H, Dv), all float32, and each row's
// log-sum-exp of its scaled scores, lse (B, H, Sq), written by the forward
// kernels.  Masks as the forward: causal (q_pos >= k_pos), window (k_pos >
// q_pos - window, 0 = full), padding (k_pos < Skv, q_pos < Sq), query row
// i at position q_offset + i; query head h reads KV head h // (H / KH).
// Outputs dq, dk, dv in f32, contiguous.  The wrapper's route_bwd() sends
// every float32 call here; bf16 runs in flash_attention_bwd_sm90.cu (or, at
// head dims that are not multiples of 16, flash_attention_bwd.cu).
//
//   P = exp(S * scale - lse) on kept pairs, dV = P^T dO, dP = dO V^T,
//   D = rowsum(dO o O), dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q
//
// What bounds it on this card.  At hymba-1.5B's training shape (4 x 2048
// tokens, 25 / 5 heads of 64, window 1024) the band holds 1.573e8 (query,
// key) pairs: the five products, 2 * pairs * (3 Dk + 2 Dv) = 100.7 GFLOP,
// take 1.503 ms at the 67 TFLOP/s f32 CUDA-core peak and 0.610 ms as three
// TF32 products at 495 TFLOP/s, against ~60 MB read and written (0.02 ms
// at 3.35 TB/s) -- operation bound.  Its 1e-4 gate rules out bf16 or one
// TF32 product as operands; 3xTF32 (sm90_tf32x3.cuh) keeps each product
// within ~2^-20.
//
// What the design does about it:
//  * Every product on wgmma.m64n64k8 tf32 as tf32x3, small terms first:
//      S^T = K Q^T and dP^T = V dO^T (dK/dV kernel), S = Q K^T and
//      dP = dO V^T (dQ kernel): both operands K-major over Dk or Dv, as
//      they lie in memory;
//      dV += P^T dO, dK += dS^T Q, dQ += dS K: P^T, dS^T and dS are the
//      register A operand, split into hi and lo in registers; dO, Q and K
//      are the B operand, whose K (queries or keys) is their rows, so the
//      split pass writes them transposed, rows permuted to the A
//      fragment's order (flash_tf32x3.cuh).
//    exp, the masks (selects, on edge tiles only) and dS = P o (dP - D)
//    stay in f32 registers.
//  * Deterministic, no atomics, as the CUDA-core backward: a pre-pass
//    writes D; the dK/dV kernel has one block per (64-key tile, KV head,
//    batch, 64-column block j), walks the H/KH query heads of its KV head
//    and the 64-query tiles of the band, and holds column block j of dK and
//    of dV, so the GQA sum is in-block; the dQ kernel has one block per
//    (64-query tile, head, batch, column block j of dQ) and walks the key
//    tiles of the band.
//  * Operands stream in 64 x 64 chunks (a 64-column block of a head dim)
//    through a ring of two slots: 16-byte cp.async copies, zero-filled past
//    Sq, Skv and the head dims, land step i + 1 while step i is split and
//    in the tensor cores.  Where Dk and Dv take at most four 64-column
//    blocks together (resident_chunks; every head dim the zoo runs but 160
//    and 256), the block's own tiles (K and V for dK/dV, Q and dO for dQ)
//    are loaded and split once and stay, and a step is one walked chunk
//    (32 KiB slots): Q's or dO's for S^T or dP^T, split in place, or the
//    transposed chunk of dV's, dK's or dQ's B operand.  Wider, a step of S
//    or dP is a chunk pair (64 KiB slots): the own tile's chunk again and
//    the walked one.  Shared memory (poas_flash_bwd_tf32x3_smem; the
//    wrapper's bwd_tf32x3_smem_bytes mirrors it), dK/dV kernel: 1024
//    (alignment) + 32,768 a resident block + the ring + 1,024 (the walked
//    tiles' lse and D, two stages): 133,120 bytes at Dk = Dv = 64, 165,888
//    at 96/64, 198,656 at 128, and 133,120 at 160 and 256 (pairs); the dQ
//    kernel 1,024 less; one block an SM.
//  * A block holds one 64-column block of its outputs (32 f32 accumulators a
//    thread each, dK and dV or dQ), so registers do not grow with the head
//    dim: any Dk, Dv in 1..256.  The price is that a block with more than
//    one column block recomputes S and dP for each: at Dk = Dv = 64 none,
//    at 128 twice and at 256 four times.
//  * dV, dK and dQ are summed in f32 registers from one 64-deep panel a
//    step (chunk_rs), not in the wgmma accumulator across the walk.
//
// Later work: each step's wgmma is waited for before the next step's split,
// so the split and the tensor cores take turns; a ring of three slots with
// the wgmma left running across the next split made nvcc 12.9's ptxas
// crash (segmentation fault) and is not here.  Then one pass with a split
// dQ reduction, a producer warp with TMA.
#include <cstdint>

#include <cuda_runtime.h>

#include "flash_tf32x3.cuh"

namespace {

using namespace poas_flash_tf32x3;

constexpr int SLOT = 4 * CHUNK;    // a chunk pair: A (hi, lo), B (hi, lo)
constexpr int DOT_THREADS = 256;

struct Shape {
  int64_t sq, skv, heads, kv_heads;
  int dk, dv;
  int causal;
  int64_t window;
  float scale;
  int64_t q_offset;   // position of query row 0
};

// Query row qp (from 0) sits at position q_offset + qp.
__device__ __forceinline__ bool kept_pair(int64_t qp, int64_t kp,
                                          const Shape& sh) {
  return qp < sh.sq && kept(sh.q_offset + qp, kp, sh.skv, sh.causal,
                            sh.window);
}

// True when some pair of the (rows q0.., keys k0..) 64 x 64 tile is masked.
__device__ __forceinline__ bool edge_tile(int64_t q0, int64_t k0,
                                          const Shape& sh) {
  const int64_t qa0 = sh.q_offset + q0;
  return q0 + BT > sh.sq || k0 + BT > sh.skv ||
         (sh.causal && k0 + BT - 1 > qa0) ||
         (sh.window > 0 && k0 <= qa0 + BT - 1 - sh.window);
}

// The block's own chunks kept split in shared memory (K and V for dK/dV,
// Q and dO for dQ) where they fit beside the ring, else 0: every step
// loads and splits them again with the walked chunk.
__host__ __device__ inline int resident_chunks(int dk, int dv) {
  const int n = (dk + 63) / 64 + (dv + 63) / 64;
  return n <= 4 ? n : 0;
}

// Dynamic shared memory: the resident chunks, the ring (slots of one
// chunk's hi and lo with resident chunks, of a pair without), then (dK/dV
// only) two stages of the walked query tile's lse and D.
__host__ __device__ inline size_t smem_bytes(bool dkdv, int res) {
  return 1024 + static_cast<size_t>(res) * 2 * CHUNK +
         2 * static_cast<size_t>(res ? 2 * CHUNK : SLOT) +
         (dkdv ? 4 * BT * 4 : 0);
}

// D[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d]: one warp per row.
__global__ void __launch_bounds__(DOT_THREADS)
flash_bwd_tf32x3_dot(const float* __restrict__ o,
                     const float* __restrict__ dout, float* __restrict__ D,
                     int64_t rows, Shape sh, Strides os, Strides dos) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (DOT_THREADS / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int64_t h = row % sh.heads;
  const int64_t q = (row / sh.heads) % sh.sq;
  const int64_t b = row / (sh.heads * sh.sq);
  const float* ob = o + b * os.b + q * os.s + h * os.h;
  const float* db = dout + b * dos.b + q * dos.s + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < sh.dv; d += 32) acc = fmaf(ob[d], db[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[(b * sh.heads + h) * sh.sq + q] = acc;
}

// Column block j of dK and dV for one 64-key tile of one KV head.  Per
// walked (query head, query tile), in the accumulator layout with keys as
// rows and queries as columns: S^T = K Q^T (Dk chunk pairs), dP^T = V dO^T
// (Dv chunk pairs), P^T = exp(S^T scale - lse), dS^T = P^T o (dP^T - D);
// dV_j += P^T dO_j and dK_j += dS^T Q_j (one transposed chunk each).
template <bool RES>
__global__ void __launch_bounds__(THREADS)
flash_bwd_tf32x3_dkdv(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, Shape sh, Strides qs,
                      Strides ks, Strides vs, Strides dos) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw0);
  const int nkc = (sh.dk + 63) / 64, nvc = (sh.dv + 63) / 64;
  // RES: K's chunks at 2 c CHUNK, then V's, split once; a slot holds the
  // walked chunk.  Else a slot holds the pair: own chunk, walked chunk.
  constexpr uint32_t kSlot = RES ? 2 * CHUNK : SLOT;
  constexpr uint32_t kWalk = RES ? 0 : 2 * CHUNK;   // walked chunk in a slot
  const uint32_t ring = RES ? static_cast<uint32_t>(nkc + nvc) * 2 * CHUNK
                            : 0;
  const float* vals = reinterpret_cast<const float*>(sm + ring + 2 * kSlot);
  const uint32_t vals_s = base + ring + 2 * kSlot;   // stage x: lse, then D

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4;   // and row + 8: keys of the tile
  const int cq = 2 * (lane % 4);
  const int ncol = nkc > nvc ? nkc : nvc;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kh = blockIdx.y / ncol, b = blockIdx.z;
  const int j = static_cast<int>(blockIdx.y % ncol);
  const int64_t group = sh.heads / sh.kv_heads;
  const bool has_v = j < nvc, has_k = j < nkc;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

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
  // Steps of one walked tile: the S^T pairs, the dP^T pairs, dO_j^T, Q_j^T.
  const int per_it = nkc + nvc + has_v + has_k;
  const int n_steps = n_it * per_it;

  auto slot_of = [&](int i) { return ring + (i & 1) * kSlot; };
  // Own chunk c of S^T (K's) or, past nkc, of dP^T (V's).
  auto own = [&](int i, int c) {
    return RES ? base + c * 2 * CHUNK : base + slot_of(i);
  };
  auto issue = [&](int i) {
    if (i < n_steps) {
      const int it = i / per_it, r = i - it * per_it;
      const int64_t h = kh * group + it / nqt;
      const int64_t q0 = q_begin + static_cast<int64_t>(it % nqt) * BT;
      const float* qb = q + b * qs.b + h * qs.h;
      const float* db = dout + b * dos.b + h * dos.h;
      const uint32_t st = base + slot_of(i);
      if (r < nkc) {
        if (!RES) load_k(st, kb, k0, sh.skv, ks.s, 64 * r, sh.dk, tid);
        load_k(st + kWalk, qb, q0, sh.sq, qs.s, 64 * r, sh.dk, tid);
        if (r == 0 && tid < BT) {   // the tile's lse and D
          const int64_t at = (b * sh.heads + h) * sh.sq + q0 + tid;
          const bool ok = q0 + tid < sh.sq;
          const uint32_t vs_ = vals_s + (it & 1) * 2 * BT * 4 + tid * 4;
          cp_async4(vs_, ok ? lse + at : lse, ok);
          cp_async4(vs_ + BT * 4, ok ? D + at : D, ok);
        }
      } else if (r < nkc + nvc) {
        const int c = r - nkc;
        if (!RES) load_k(st, vb, k0, sh.skv, vs.s, 64 * c, sh.dv, tid);
        load_k(st + kWalk, db, q0, sh.sq, dos.s, 64 * c, sh.dv, tid);
      } else if (r == nkc + nvc && has_v) {
        load_plain(st + CHUNK, db, q0, sh.sq, dos.s, 64 * j, sh.dv, tid);
      } else {
        load_plain(st + CHUNK, qb, q0, sh.sq, qs.s, 64 * j, sh.dk, tid);
      }
    }
    cp_async_commit();   // one group a step, empty or not
  };
  // Open step i: landed, split (pairs in place, else transposed), visible;
  // the resident chunks land with step 0 and are split there.
  auto open = [&](int i, bool pair, int cols) {
    ring_wait();
    issue(i + 1);
    if (RES && i == 0)
      for (int c = 0; c < nkc + nvc; ++c) split_k(sm + c * 2 * CHUNK, tid);
    if (pair) {
      if (!RES) split_k(sm + slot_of(i), tid);
      split_k(sm + slot_of(i) + kWalk, tid);
    } else {
      split_t(sm + slot_of(i), cols, tid);
    }
    ring_ready();
  };
  if (RES) {
    for (int c = 0; c < nkc; ++c)
      load_k(base + c * 2 * CHUNK, kb, k0, sh.skv, ks.s, 64 * c, sh.dk, tid);
    for (int c = 0; c < nvc; ++c)
      load_k(base + (nkc + c) * 2 * CHUNK, vb, k0, sh.skv, vs.s, 64 * c,
             sh.dv, tid);
  }
  issue(0);

  float acc_k[32], acc_v[32], s[32], dp[32];
  zero(acc_k);
  zero(acc_v);
  zero(s);
  zero(dp);
  const float sl2 = sh.scale * LOG2E;
  int i = 0;
  for (int it = 0; it < n_it; ++it) {
    const int64_t q0 = q_begin + static_cast<int64_t>(it % nqt) * BT;
    for (int c = 0; c < nkc; ++c, ++i) {   // S^T = K Q^T
      open(i, true, 0);
      wg_fence();
      chunk_ss(s, own(i, c), base + slot_of(i) + kWalk, ksteps(sh.dk, c),
               c == 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
    }
    for (int c = 0; c < nvc; ++c, ++i) {   // dP^T = V dO^T
      open(i, true, 0);
      wg_fence();
      chunk_ss(dp, own(i, nkc + c), base + slot_of(i) + kWalk,
               ksteps(sh.dv, c), c == 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(dp);
    }

    // P^T as the A operand (hi, lo); register x of step kk is query
    // q0 + frag_col, key k0 + row + frag_row.
    const float* lse_t = vals + (it & 1) * 2 * BT;
    const float* d_t = lse_t + BT;
    const bool edge = edge_tile(q0, k0, sh);
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int col = frag_col(kk, x, cq);
        float p = exp2_ftz(fmaf(s[frag_reg(kk, x)], sl2,
                                -lse_t[col] * LOG2E));
        if (edge && !kept_pair(q0 + col, k0 + row + frag_row(x), sh))
          p = 0.f;
        float hi, lo;
        split_tf32(p, hi, lo);
        ah[kk][x] = __float_as_uint(hi);
        al[kk][x] = __float_as_uint(lo);
      }
    if (has_v) {   // dV_j += P^T dO_j, a panel in s (dead since P^T)
      open(i, false, sh.dv - 64 * j);
      wg_fence();
      chunk_rs(s, ah, al, base + slot_of(i));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_v[e] += s[e];
      ++i;
    }
    // dS^T = P^T o (dP^T - D), P^T = hi + lo exactly.
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p =
            __uint_as_float(ah[kk][x]) + __uint_as_float(al[kk][x]);
        const float ds = p * (dp[frag_reg(kk, x)] - d_t[frag_col(kk, x, cq)]);
        float hi, lo;
        split_tf32(ds, hi, lo);
        ah[kk][x] = __float_as_uint(hi);
        al[kk][x] = __float_as_uint(lo);
      }
    if (has_k) {   // dK_j += dS^T Q_j, a panel in s
      open(i, false, sh.dk - 64 * j);
      wg_fence();
      chunk_rs(s, ah, al, base + slot_of(i));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc_k[e] += s[e];
      ++i;
    }
  }
  cp_async_wait<0>();

  // Every key row of the tile is written, zero where no query sees it.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t kp = k0 + row + 8 * r;
    if (kp >= sh.skv) continue;
    float* dkr = dk + ((b * sh.skv + kp) * sh.kv_heads + kh) * sh.dk;
    float* dvr = dv + ((b * sh.skv + kp) * sh.kv_heads + kh) * sh.dv;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 64 * j + 8 * n + cq + e;
        if (has_k && col < sh.dk)
          dkr[col] = sh.scale * acc_k[4 * n + 2 * r + e];
        if (has_v && col < sh.dv) dvr[col] = acc_v[4 * n + 2 * r + e];
      }
  }
}

// Column block j of dQ for one 64-query tile of one head: per key tile of
// the band, S = Q K^T (Dk chunk pairs), dP = dO V^T (Dv chunk pairs), dS =
// P o (dP - D), dQ_j += dS K_j (one transposed chunk).
template <bool RES>
__global__ void __launch_bounds__(THREADS)
flash_bwd_tf32x3_dq(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dq,
                    Shape sh, Strides qs, Strides ks, Strides vs,
                    Strides dos) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw0);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row = warp * 16 + lane / 4;   // and row + 8: queries of the tile
  const int cq = 2 * (lane % 4);
  const int nkc = (sh.dk + 63) / 64, nvc = (sh.dv + 63) / 64;
  // RES: Q's chunks at 2 c CHUNK, then dO's, split once (as dK/dV's K, V).
  constexpr uint32_t kSlot = RES ? 2 * CHUNK : SLOT;
  constexpr uint32_t kWalk = RES ? 0 : 2 * CHUNK;
  const uint32_t ring = RES ? static_cast<uint32_t>(nkc + nvc) * 2 * CHUNK
                            : 0;
  // Launch the latest query tiles (the longest causal rows) first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BT;
  const int64_t h = blockIdx.y / nkc, b = blockIdx.z;
  const int j = static_cast<int>(blockIdx.y % nkc);
  const int64_t kh = h / (sh.heads / sh.kv_heads);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* db = dout + b * dos.b + h * dos.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  // This thread's two rows' lse and D (0 past Sq: those rows are masked).
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = q0 + row + 8 * r;
    const int64_t at = (b * sh.heads + h) * sh.sq + qp;
    lr[r] = qp < sh.sq ? lse[at] * LOG2E : 0.f;
    dr[r] = qp < sh.sq ? D[at] : 0.f;
  }

  // The key band of this query tile; tiles outside it are skipped.
  const int64_t qa0 = sh.q_offset + q0;
  const int64_t qa_last =
      sh.q_offset + (q0 + BT < sh.sq ? q0 + BT : sh.sq) - 1;
  int64_t kv_end = sh.skv;
  if (sh.causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (sh.window > 0 && qa0 - sh.window + 1 > 0)
    kv_begin = qa0 - sh.window + 1;
  kv_begin -= kv_begin % BT;
  const int n_tiles = kv_end > kv_begin
      ? static_cast<int>((kv_end - kv_begin + BT - 1) / BT) : 0;
  const int per_tile = nkc + nvc + 1;   // S pairs, dP pairs, K_j^T
  const int n_steps = n_tiles * per_tile;

  auto slot_of = [&](int i) { return ring + (i & 1) * kSlot; };
  auto own = [&](int i, int c) {
    return RES ? base + c * 2 * CHUNK : base + slot_of(i);
  };
  auto issue = [&](int i) {
    if (i < n_steps) {
      const int t = i / per_tile, r = i - t * per_tile;
      const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BT;
      const uint32_t st = base + slot_of(i);
      if (r < nkc) {
        if (!RES) load_k(st, qb, q0, sh.sq, qs.s, 64 * r, sh.dk, tid);
        load_k(st + kWalk, kb, k0, sh.skv, ks.s, 64 * r, sh.dk, tid);
      } else if (r < nkc + nvc) {
        const int c = r - nkc;
        if (!RES) load_k(st, db, q0, sh.sq, dos.s, 64 * c, sh.dv, tid);
        load_k(st + kWalk, vb, k0, sh.skv, vs.s, 64 * c, sh.dv, tid);
      } else {
        load_plain(st + CHUNK, kb, k0, sh.skv, ks.s, 64 * j, sh.dk, tid);
      }
    }
    cp_async_commit();
  };
  auto open = [&](int i, bool pair, int cols) {
    ring_wait();
    issue(i + 1);
    if (RES && i == 0)
      for (int c = 0; c < nkc + nvc; ++c) split_k(sm + c * 2 * CHUNK, tid);
    if (pair) {
      if (!RES) split_k(sm + slot_of(i), tid);
      split_k(sm + slot_of(i) + kWalk, tid);
    } else {
      split_t(sm + slot_of(i), cols, tid);
    }
    ring_ready();
  };
  if (RES) {
    for (int c = 0; c < nkc; ++c)
      load_k(base + c * 2 * CHUNK, qb, q0, sh.sq, qs.s, 64 * c, sh.dk, tid);
    for (int c = 0; c < nvc; ++c)
      load_k(base + (nkc + c) * 2 * CHUNK, db, q0, sh.sq, dos.s, 64 * c,
             sh.dv, tid);
  }
  issue(0);

  float acc[32], s[32], dp[32];
  zero(acc);
  zero(s);
  zero(dp);
  const float sl2 = sh.scale * LOG2E;
  int i = 0;
  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BT;
    for (int c = 0; c < nkc; ++c, ++i) {   // S = Q K^T
      open(i, true, 0);
      wg_fence();
      chunk_ss(s, own(i, c), base + slot_of(i) + kWalk, ksteps(sh.dk, c),
               c == 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
    }
    for (int c = 0; c < nvc; ++c, ++i) {   // dP = dO V^T
      open(i, true, 0);
      wg_fence();
      chunk_ss(dp, own(i, nkc + c), base + slot_of(i) + kWalk,
               ksteps(sh.dv, c), c == 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(dp);
    }
    // dS as the A operand; register x of step kk is query q0 + row +
    // frag_row, key k0 + frag_col.
    const bool edge = edge_tile(q0, k0, sh);
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int rr = x & 1;
        float p = exp2_ftz(fmaf(s[frag_reg(kk, x)], sl2, -lr[rr]));
        if (edge && !kept_pair(q0 + row + frag_row(x),
                               k0 + frag_col(kk, x, cq), sh))
          p = 0.f;
        float hi, lo;
        split_tf32(p * (dp[frag_reg(kk, x)] - dr[rr]), hi, lo);
        ah[kk][x] = __float_as_uint(hi);
        al[kk][x] = __float_as_uint(lo);
      }
    open(i, false, sh.dk - 64 * j);   // dQ_j += dS K_j, a panel in s
    wg_fence();
    chunk_rs(s, ah, al, base + slot_of(i));
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += s[e];
    ++i;
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = q0 + row + 8 * r;
    if (qp >= sh.sq) continue;
    float* dqr = dq + ((b * sh.sq + qp) * sh.heads + h) * sh.dk;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 64 * j + 8 * n + cq + e;
        if (col < sh.dk) dqr[col] = sh.scale * acc[4 * n + 2 * r + e];
      }
  }
}

// The dK/dV and dQ kernels, with the block's own chunks resident or not.
template <bool RES>
int launch_main(const float* q, const float* k, const float* v,
                const float* dout, const float* lse, const float* D,
                float* dq, float* dk, float* dv, int64_t batch,
                const Shape& sh, Strides qs, Strides ks, Strides vs,
                Strides dos, cudaStream_t s) {
  const int res = RES ? resident_chunks(sh.dk, sh.dv) : 0;
  const size_t smem_kv = smem_bytes(true, res);
  const size_t smem_q = smem_bytes(false, res);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_tf32x3_dkdv<RES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_kv));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_tf32x3_dq<RES>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_q));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nkc = (sh.dk + 63) / 64, nvc = (sh.dv + 63) / 64;
  const dim3 grid_a(static_cast<unsigned>((sh.skv + BT - 1) / BT),
                    static_cast<unsigned>(sh.kv_heads *
                                          (nkc > nvc ? nkc : nvc)),
                    static_cast<unsigned>(batch));
  flash_bwd_tf32x3_dkdv<RES><<<grid_a, THREADS, smem_kv, s>>>(
      q, k, v, dout, lse, D, dk, dv, sh, qs, ks, vs, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(static_cast<unsigned>((sh.sq + BT - 1) / BT),
                    static_cast<unsigned>(sh.heads * nkc),
                    static_cast<unsigned>(batch));
  flash_bwd_tf32x3_dq<RES><<<grid_b, THREADS, smem_q, s>>>(
      q, k, v, dout, lse, D, dq, sh, qs, ks, vs, dos);
  return static_cast<int>(cudaGetLastError());
}

bool rows16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.s % 4 == 0 && s.h % 4 == 0;
}

}  // namespace

// Bytes of dynamic shared memory the larger of the two main kernels (dK/dV)
// requests; the same at every head dim.
extern "C" int poas_flash_bwd_tf32x3_smem(int64_t dk, int64_t dv) {
  return static_cast<int>(smem_bytes(
      true, resident_chunks(static_cast<int>(dk), static_cast<int>(dv))));
}

// Plain C entry point for ctypes, with poas_flash_bwd_f32's arguments.
// q (B, Sq, H, Dk), k (B, Skv, KH, Dk), v (B, Skv, KH, Dv), o and dout
// (B, Sq, H, Dv), float32, each with unit stride on its last dim; q, k, v,
// dout start on 16 bytes with (batch, seq, head) strides that are
// multiples of 4 elements (else cudaErrorInvalidValue, nothing launched);
// lse (B, H, Sq) f32 contiguous; dq (B, Sq, H, Dk), dk (B, Skv, KH, Dk),
// dv (B, Skv, KH, Dv) f32 contiguous outputs (every element written); D
// (B, H, Sq) f32 scratch.  `strides` holds 15 element strides: (batch,
// seq, head) of q, k, v, o, dout in that order; q_offset >= 0 is the
// position of query row 0.  The caller checks H % KH == 0.  Three kernels
// are queued on `stream` and not synchronised; the return value is the
// first launch error, or cudaErrorInvalidValue for head dims outside
// 1..256.
extern "C" int poas_flash_bwd_tf32x3_f32(const void* q, const void* k,
                                         const void* v, const void* o,
                                         const void* dout, const void* lse,
                                         void* dq, void* dk, void* dv,
                                         void* D, int64_t batch, int64_t sq,
                                         int64_t skv, int64_t heads,
                                         int64_t kv_heads, int64_t dk_dim,
                                         int64_t dv_dim,
                                         const int64_t* st, int64_t causal,
                                         int64_t window, float scale,
                                         int64_t q_offset, void* stream) {
  if (dk_dim < 1 || dk_dim > 256 || dv_dim < 1 || dv_dim > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  if (!rows16(q, qs) || !rows16(k, ks) || !rows16(v, vs) ||
      !rows16(dout, dos))
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, skv, heads, kv_heads, static_cast<int>(dk_dim),
                 static_cast<int>(dv_dim), static_cast<int>(causal), window,
                 scale, q_offset};
  auto s = static_cast<cudaStream_t>(stream);
  auto cq = static_cast<const float*>(q);
  auto ck = static_cast<const float*>(k);
  auto cv = static_cast<const float*>(v);
  auto co = static_cast<const float*>(o);
  auto cd = static_cast<const float*>(dout);
  auto cl = static_cast<const float*>(lse);
  auto fD = static_cast<float*>(D);
  const int64_t rows = batch * sq * heads;
  const int per_block = DOT_THREADS / 32;
  flash_bwd_tf32x3_dot<<<static_cast<unsigned>(
      (rows + per_block - 1) / per_block), DOT_THREADS, 0, s>>>(
      co, cd, fD, rows, sh, os, dos);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto fq = static_cast<float*>(dq);
  auto fk = static_cast<float*>(dk);
  auto fv = static_cast<float*>(dv);
  if (resident_chunks(sh.dk, sh.dv))
    return launch_main<true>(cq, ck, cv, cd, cl, fD, fq, fk, fv, batch, sh,
                             qs, ks, vs, dos, s);
  return launch_main<false>(cq, ck, cv, cd, cl, fD, fq, fk, fv, batch, sh,
                            qs, ks, vs, dos, s);
}
