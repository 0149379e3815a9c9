// K2 on Hopper's tensor cores in float32: causal / sliding-window GQA flash
// attention (forward), both products as 3xTF32 wgmma, for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (:70, body _flash_kernel) for float32 inputs: a (B, H, Sq/bq, Skv/bk)
// grid whose sequential KV axis carries a running f32 (m, l, acc); q, k and
// v are upcast to f32 before both products (:38-40); masks are causal
// (q_pos >= k_pos), sliding window (k_pos > q_pos - window, window 0 =
// full) and padding (k_pos < Skv); query head h reads KV head h // (H / KH).
// Query row i sits at position q_offset + i (the absolute position of q[0]
// in chunked prefill, as the reference model stack's flash_attention takes
// it), keys at 0..Skv-1; a row that keeps no key is written as 0 (its l
// stays 0; the reference gives it a mean of V, C0d).  The wrapper's route()
// sends every float32 call here; bf16 runs in flash_attention_sm90.cu (or,
// at head dims that are not multiples of 16, flash_attention.cu).
//
// What bounds it on this card.  At hymba-1.5B's float32 prefill (1 x 1300
// tokens, 25 query / 5 KV heads of 64, window 1024) the band holds 1.0e6
// (query, key) pairs a head: 5.17 GFLOP for the two products, 0.0771 ms at
// the 67 TFLOP/s f32 CUDA-core peak and 0.0313 ms as three TF32 products at
// 495 TFLOP/s, against 2.7 MB of q, k, v, o (0.0008 ms at 3.35 TB/s) --
// operation bound.  One TF32 product would keep 10 mantissa bits, ~1e-3
// relative, too far for the 2e-5 gate; three (hi/lo split, small terms
// first, sm90_tf32x3.cuh) keep each product within ~2^-20.
//
// What the design does about it:
//  * One warpgroup per 64-row query tile of one head and batch; the TPU's
//    sequential KV grid axis is a loop over 64-key tiles inside the block.
//    Tiles wholly outside the causal/window band are skipped (exact), and
//    the heaviest query tiles launch first.
//  * S = Q K^T and O += P V on wgmma.m64n64k8 tf32, each as tf32x3: Q and K
//    K-major as they lie, V transposed by its split pass (tf32 wgmma reads
//    B K-major only).  The online softmax stays in f32 registers: p =
//    exp2(s * scale*log2e - m * scale*log2e) (one FMA, one ex2.approx);
//    masked scores are dropped by a select (p = 0), never through
//    exp(-1e30 - m), and only on tiles that cross the diagonal, the window
//    edge or Skv.
//  * P feeds PV from registers (tf32x3_rs), split into hi and lo there.
//    The accumulator's columns (2c, 2c + 1 of each 8) are not the tf32 A
//    fragment's (c, c + 4): V's split pass permutes its key rows the same
//    way (flash_tf32x3.cuh), which costs nothing.  Each tile's P V is a
//    fresh panel added to the running O in f32 (O corr + panel, one FMA):
//    O kept in the wgmma accumulator drifts from the f32 sum over a long
//    band (chunk_rs).
//  * Q is loaded and split once, whole (hi and lo, 32 KiB per 64 columns
//    of Dk).  K and V stream through a ring of two 32 KiB slots in 64 x 64
//    chunks (the Dk chunks of K, then the Dv chunks of V, each key tile):
//    16-byte cp.async copies, zero-filled past Skv and the head dims, land
//    chunk i + 1 while chunk i is split and in the tensor cores.  So shared
//    memory grows with Dk only: 1024 (alignment) + 32,768 a 64-column chunk
//    of Dk (Q's hi and lo) + 65,536 (the ring): 99,328 bytes at Dk <= 64
//    (two blocks an SM), 132,096 at 128, 164,864 at 160 and 197,632 at 256,
//    of the 232,448 a block may use (poas_flash_tf32x3_smem; the wrapper's
//    tf32x3_smem_bytes mirrors it).
//  * Any Dk, Dv in 1..256: ragged head dims are zero-filled to the next 8
//    (the k8 step), and zeros add exact zeros.  Dv is a template of 64-wide
//    accumulator blocks (1-4), its padding columns computed and dropped.
//  * q, k, v are read through their (B, S, H, D) strides (rows on 16
//    bytes; the wrapper copies what is not), o written in place.  For
//    training, each row's log-sum-exp of its scaled scores, scale * m +
//    ln l, is written to `lse` (B, H, Sq) when the pointer is not null.
//
// Later work: K/V chunks shared by the group's query heads (one block per
// KV head), a producer warp with TMA, two consumer warpgroups.
#include <cstdint>

#include <cuda_runtime.h>

#include "flash_tf32x3.cuh"

namespace {

using namespace poas_flash_tf32x3;

// One tile of the online softmax on the S accumulator: the rows' running
// max m, their rescale factors corr and this thread's partial sums l over
// its own columns, and P (unnormalised) split into hi and lo as the A
// operand of PV.  s is read, never written: only wgmma defines a wgmma
// accumulator (a non-wgmma write makes ptxas serialise them, C7515).
// Register 4i + e is row row0 + 8 (e >> 1), column col0 + 8i + (e & 1).
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(const float (&s)[32],
                                             uint32_t (&ph)[8][4],
                                             uint32_t (&pl)[8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2,
                                             int64_t row0, int64_t col0,
                                             int64_t skv, int causal,
                                             int64_t window) {
  uint32_t keep = 0xffffffffu;
  if (EDGE) {
    keep = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int64_t qp = row0 + 8 * ((j & 3) >> 1);
      const int64_t kp = col0 + 8 * (j >> 2) + (j & 1);
      if (kept(qp, kp, skv, causal, window)) keep |= 1u << j;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (!EDGE || (keep >> j) & 1u)
      mx[(j & 3) >> 1] = fmaxf(mx[(j & 3) >> 1], s[j]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2_ftz((m[r] - mx[r]) * sl2);
    m[r] = mx[r];
  }
  const float b[2] = {mx[0] * sl2, mx[1] * sl2};
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = frag_reg(kk, x), r = x & 1;
      float p = exp2_ftz(fmaf(s[j], sl2, -b[r]));
      if (EDGE) p = (keep >> j) & 1u ? p : 0.f;
      sum[r] += p;
      float hi, lo;
      split_tf32(p, hi, lo);
      ph[kk][x] = __float_as_uint(hi);
      pl[kk][x] = __float_as_uint(lo);
    }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

// Dynamic shared memory of one block: Q's hi and lo, then two ring slots
// (hi, lo), from a 1024-byte-aligned base.
__host__ __device__ inline size_t smem_bytes(int dk) {
  return 1024 + static_cast<size_t>(CHUNK) * (2 * ((dk + 63) / 64) + 4);
}

template <int DVB>
__global__ void __launch_bounds__(THREADS)
flash_tf32x3_fwd(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int64_t sq, int64_t skv,
                 int64_t heads, int64_t kv_heads, int dk, int dv, Strides qs,
                 Strides ks, Strides vs, Strides os, int causal,
                 int64_t window, int64_t q_offset, float scale) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw0);
  const int nkc = (dk + 63) / 64;
  // Q's chunk c (hi, then lo) at 2 c CHUNK; ring slot s after them.
  const uint32_t ring = 2 * static_cast<uint32_t>(nkc) * CHUNK;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Launch the latest query tiles (the longest causal rows) first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BT;
  const int64_t qa0 = q_offset + q0;   // position of the tile's row 0
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / (heads / kv_heads);
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kh * ks.h;
  const float* vb = v + b * vs.b + kh * vs.h;

  // The KV band this q-tile can see; tiles outside it are skipped.
  const int64_t qa_last = q_offset + (q0 + BT < sq ? q0 + BT : sq) - 1;
  int64_t kv_end = skv;
  if (causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (window > 0 && qa0 - window + 1 > 0) kv_begin = qa0 - window + 1;
  kv_begin -= kv_begin % BT;
  const int n_tiles = kv_end > kv_begin
      ? static_cast<int>((kv_end - kv_begin + BT - 1) / BT) : 0;
  // Each key tile is nkc chunks of K, then DVB chunks of V.
  const int per_tile = nkc + DVB;
  const int n_steps = n_tiles * per_tile;

  auto slot_of = [&](int i) { return ring + (i & 1) * 2 * CHUNK; };
  auto issue = [&](int i) {
    if (i < n_steps) {
      const int t = i / per_tile, r = i - t * per_tile;
      const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BT;
      if (r < nkc)
        load_k(base + slot_of(i), kb, k0, skv, ks.s, 64 * r, dk, tid);
      else
        load_plain(base + slot_of(i) + CHUNK, vb, k0, skv, vs.s,
                   64 * (r - nkc), dv, tid);
    }
    cp_async_commit();   // one group a step, empty or not
  };
  for (int c = 0; c < nkc; ++c)
    load_k(base + 2 * c * CHUNK, qb, q0, sq, qs.s, 64 * c, dk, tid);
  issue(0);   // Q lands with step 0

  float acc[DVB][32], s[32];
#pragma unroll
  for (int n = 0; n < DVB; ++n) zero(acc[n]);
  zero(s);
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  const float sl2 = scale * LOG2E;
  const int row = warp * 16 + lane / 4;      // and row + 8
  const int cq = 2 * (lane % 4);

  for (int t = 0; t < n_tiles; ++t) {
    const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BT;
    // S = Q K^T over the Dk chunks of K.
    for (int c = 0; c < nkc; ++c) {
      const int i = t * per_tile + c;
      ring_wait();
      issue(i + 1);
      if (i == 0)
        for (int cc = 0; cc < nkc; ++cc) split_k(sm + 2 * cc * CHUNK, tid);
      split_k(sm + slot_of(i), tid);
      ring_ready();
      wg_fence();
      chunk_ss(s, base + 2 * c * CHUNK, base + slot_of(i), ksteps(dk, c),
               c == 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
    }

    const bool edge = k0 + BT > skv || (causal && k0 + BT - 1 > qa0) ||
                      (window > 0 && k0 <= qa0 + BT - 1 - window);
    uint32_t ph[8][4], pl[8][4];   // P as the A operand, hi and lo
    if (edge)
      softmax_tile<true>(s, ph, pl, m, l, corr, sl2, qa0 + row, k0 + cq, skv,
                         causal, window);
    else
      softmax_tile<false>(s, ph, pl, m, l, corr, sl2, qa0 + row, k0 + cq,
                          skv, causal, window);

    // O = O corr + P V, one 64-column chunk of V at a time: P V_n is a
    // panel in s (chunk_rs), added to the running O in f32.
#pragma unroll
    for (int n = 0; n < DVB; ++n) {
      const int i = t * per_tile + nkc + n;
      ring_wait();
      issue(i + 1);
      split_t(sm + slot_of(i), dv - 64 * n, tid);
      ring_ready();
      wg_fence();
      chunk_rs(s, ph, pl, base + slot_of(i));
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        acc[n][j] = fmaf(acc[n][j], corr[(j & 3) >> 1], s[j]);
    }
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[r] = 1.f / fmaxf(x, 1e-30f);
    const int64_t qp = q0 + row + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && qp < sq)
      lse[(b * heads + h) * sq + qp] =
          x > 0.f ? m[r] * scale + logf(x) : NEG_INF;
  }
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = q0 + row + 8 * r;
    if (qp >= sq) continue;
#pragma unroll
    for (int n = 0; n < DVB; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n * 64 + 8 * i + cq + e;
          if (col < dv)
            ob[qp * os.s + col] = acc[n][4 * i + 2 * r + e] * inv[r];
        }
  }
}

template <int DVB>
int launch_cfg(const float* q, const float* k, const float* v, float* o,
               float* lse, int64_t batch, int64_t sq, int64_t skv,
               int64_t heads, int64_t kv_heads, int dk, int dv, Strides qs,
               Strides ks, Strides vs, Strides os, int causal,
               int64_t window, int64_t q_offset, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(dk);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tf32x3_fwd<DVB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + BT - 1) / BT),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  flash_tf32x3_fwd<DVB><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, sq, skv, heads, kv_heads, dk, dv, qs, ks, vs, os,
      causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

bool rows16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.s % 4 == 0 && s.h % 4 == 0;
}

}  // namespace

// Bytes of dynamic shared memory that a launch at head dims dk, dv
// requests (the same at every dv).
extern "C" int poas_flash_tf32x3_smem(int64_t dk, int64_t dv) {
  (void)dv;
  return static_cast<int>(smem_bytes(static_cast<int>(dk)));
}

// Plain C entry point for ctypes, with poas_flash_f32's arguments.
// q (B, Sq, H, Dk), k (B, Skv, KH, Dk), v (B, Skv, KH, Dv), o (B, Sq, H, Dv),
// float32, each with unit stride on its last dim; q, k and v start on 16
// bytes with (batch, seq, head) strides that are multiples of 4 elements
// (else cudaErrorInvalidValue, nothing launched); lse (B, H, Sq) f32,
// contiguous, or null (not written); `strides` holds the 12 element strides
// (batch, seq, head) of q, k, v, o in that order; q_offset >= 0 is the
// position of query row 0.  The caller checks H % KH == 0.  The launch is
// queued on `stream` and not synchronised; the return value is
// cudaGetLastError(), or cudaErrorInvalidValue for head dims outside
// 1..256.
extern "C" int poas_flash_tf32x3_f32(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int64_t batch, int64_t sq, int64_t skv,
                                     int64_t heads, int64_t kv_heads,
                                     int64_t dk, int64_t dv,
                                     const int64_t* st, int64_t causal,
                                     int64_t window, float scale,
                                     int64_t q_offset, void* stream) {
  if (dk < 1 || dk > 256 || dv < 1 || dv > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  if (!rows16(q, qs) || !rows16(k, ks) || !rows16(v, vs))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(causal);
  const int ik = static_cast<int>(dk), iv = static_cast<int>(dv);
  auto fq = static_cast<const float*>(q);
  auto fk = static_cast<const float*>(k);
  auto fv = static_cast<const float*>(v);
  auto fo = static_cast<float*>(o);
  auto fl = static_cast<float*>(lse);
  switch ((dv + 63) / 64) {
    case 1:
      return launch_cfg<1>(fq, fk, fv, fo, fl, batch, sq, skv, heads,
                           kv_heads, ik, iv, qs, ks, vs, os, c, window,
                           q_offset, scale, s);
    case 2:
      return launch_cfg<2>(fq, fk, fv, fo, fl, batch, sq, skv, heads,
                           kv_heads, ik, iv, qs, ks, vs, os, c, window,
                           q_offset, scale, s);
    case 3:
      return launch_cfg<3>(fq, fk, fv, fo, fl, batch, sq, skv, heads,
                           kv_heads, ik, iv, qs, ks, vs, os, c, window,
                           q_offset, scale, s);
    default:
      return launch_cfg<4>(fq, fk, fv, fo, fl, batch, sq, skv, heads,
                           kv_heads, ik, iv, qs, ks, vs, os, c, window,
                           q_offset, scale, s);
  }
}
