// What K2's two float32 sources on the tensor cores share
// (flash_attention_tf32x3.cu, flash_attention_bwd_tf32x3.cu): 64 x 64 f32
// chunks of a strided (B, S, H, D) operand streamed through a cp.async
// ring, split into 3xTF32's hi and lo (sm90_tf32x3.cuh), K-major as they lie
// or transposed, and the layout rule that lets an f32 accumulator feed the
// next product as its register A operand.
//
// Chunks.  Every operand is cut into chunks of 64 rows (queries or keys)
// by 64 columns of its head dim, 16 KiB of f32.  A chunk split into hi and
// lo takes 32 KiB: hi first, lo CHUNK bytes after it.
//  * K-major (load_k, split_k): the chunk as it lies, rows of 64 columns in
//    two 128-byte-swizzle atoms (columns 0-31, 32-63).  The raw chunk lands
//    in hi and is split in place, lo beside it.  It is an A or B operand
//    whose K is the head dim (S = Q K^T, dP = dO V^T, and the backward's
//    transposes of both).
//  * Transposed (load_plain, split_t): the B operand of a product whose K
//    is the chunk's rows (O += P V, dV += P^T dO, dK += dS^T Q, dQ += dS K).
//    tf32 wgmma reads B only K-major, so the split pass writes the chunk's
//    columns as rows: hi and lo [column][row], K-major over the rows.  The
//    raw chunk lands unswizzled (rows of 256 bytes) in lo and is split
//    through registers.
//
// The register A operand.  The f32 accumulator of an m64nN product holds,
// in each 8-wide k step, columns 2c and 2c + 1 (c = lane % 4) where the
// tf32 A fragment wants columns c and c + 4 (sm90_tf32x3.cuh).  Instead of
// moving the scores between lanes, the transposed split permutes the rows
// of the chunk the same way (logical k c <- row 2c, k c + 4 <- row 2c + 1 in
// each group of 8), as K3 does for xdt (csrc/ssd_chunk.cu): fragment
// register x of step kk is accumulator register 4 kk + 2 (x & 1) + (x >> 1)
// (frag_reg), and costs no instruction.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "sm90_tf32x3.cuh"

namespace poas_flash_tf32x3 {

using namespace poas_sm90;

constexpr int BT = 64;             // rows of a chunk: one wgmma M or K tile
constexpr int THREADS = 128;       // one warpgroup
constexpr int ATOM = 64 * 128;     // 64 rows x 32 f32, one swizzle column
constexpr int CHUNK = 2 * ATOM;    // 64 rows x 64 f32: one of hi, lo
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {   // element strides of a (B, S, H, D) tensor; D is unit
  int64_t b, s, h;
};

// 2^x on the SFU, denormal results flushed to 0 (weights below 2^-126).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool kept(int64_t qpos, int64_t kp, int64_t skv,
                                     int causal, int64_t window) {
  return kp < skv && (!causal || kp <= qpos) &&
         (window <= 0 || kp > qpos - window);
}

// Rows [row0, row0 + 64) and columns [col0, col0 + 64) of a strided f32
// operand (rows `stride` apart, 16-byte aligned) into a K-major chunk at
// `dst`; zero past row `limit` and column `d`.
__device__ __forceinline__ void load_k(uint32_t dst, const float* src,
                                       int64_t row0, int64_t limit,
                                       int64_t stride, int col0, int d,
                                       int tid) {
#pragma unroll
  for (int e = tid; e < BT * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    const int bytes = row0 + r < limit ? chunk_bytes(col0 + 4 * c, d, 4) : 0;
    cp_async16(dst + (c >> 3) * ATOM + sw128(r, c & 7),
               bytes ? src + (row0 + r) * stride + col0 + 4 * c : src, bytes);
  }
}

// The same rows and columns as they lie, 256 bytes a row (split_t's input).
__device__ __forceinline__ void load_plain(uint32_t dst, const float* src,
                                           int64_t row0, int64_t limit,
                                           int64_t stride, int col0, int d,
                                           int tid) {
#pragma unroll
  for (int e = tid; e < BT * 16; e += THREADS) {
    const int r = e >> 4, c = e & 15;
    const int bytes = row0 + r < limit ? chunk_bytes(col0 + 4 * c, d, 4) : 0;
    cp_async16(dst + r * 256 + c * 16,
               bytes ? src + (row0 + r) * stride + col0 + 4 * c : src, bytes);
  }
}

// A K-major chunk split in place: hi over the raw values, lo beside them
// (elementwise, so the walk ignores the swizzle).
__device__ __forceinline__ void split_k(uint8_t* hi, int tid) {
#pragma unroll
  for (int m = 0; m < BT * 16 / THREADS; ++m) {
    const int off = (tid + m * THREADS) * 16;
    float4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(hi + off), h, l);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(hi + CHUNK + off) = l;
  }
}

// The raw chunk [row t][column p], landed in lo (hi + CHUNK), -> hi and lo
// [p][k], K-major, swizzled, k in the A fragment's order: 16-byte chunk cc
// of row p holds logical k 4cc .. 4cc+3, i.e. t = 8 (cc / 2) + 2j + cc % 2
// for j = 0..3.  Columns p >= `cols` are written as zero.  Every thread
// reads its raw values into registers before any thread writes over them.
__device__ __forceinline__ void split_t(uint8_t* hi, int cols, int tid) {
  constexpr int PER = BT * 16 / THREADS;
  uint8_t* lo = hi + CHUNK;
  float4 x[PER];
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS, p = e % BT, cc = e / BT;
    const int t = 8 * (cc >> 1) + (cc & 1);
    const float* col = reinterpret_cast<const float*>(lo + t * 256) + p;
    x[m] = p < cols ? make_float4(col[0], col[2 * BT], col[4 * BT],
                                  col[6 * BT])
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < PER; ++m) {
    const int e = tid + m * THREADS, p = e % BT, cc = e / BT;
    float4 h, l;
    split_tf32(x[m], h, l);
    const uint32_t off = (cc >> 3) * ATOM + sw128(p, cc & 7);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// Accumulator register that holds fragment register x of k8 step kk.
__device__ __forceinline__ constexpr int frag_reg(int kk, int x) {
  return 4 * kk + 2 * (x & 1) + (x >> 1);
}

// Column (within the 64-wide tile) of fragment register x of step kk for
// the thread at quad position cq = 2 * (lane % 4), and its row offset.
__device__ __forceinline__ constexpr int frag_col(int kk, int x, int cq) {
  return 8 * kk + cq + (x >> 1);
}
__device__ __forceinline__ constexpr int frag_row(int x) {
  return 8 * (x & 1);
}

// K-major descriptors of k8 step kk of a chunked tile at `base` (2 atoms a
// chunk, chunks CHUNK apart, so step kk of the whole tile) and of its lo.
__device__ __forceinline__ uint64_t hi_desc(uint32_t base, int kk) {
  return kmajor_desc(base, kk, ATOM);
}
__device__ __forceinline__ uint64_t lo_desc(uint32_t base, int kk) {
  return kmajor_desc(base + CHUNK, kk, ATOM);
}

// k8 steps of the head-dim columns [64 c, 64 c + 64) that lie below d.
__device__ __forceinline__ int ksteps(int d, int c) {
  const int left = d - 64 * c;
  return left >= 64 ? 8 : (left + 7) / 8;
}

// The 64 x 64 product of one chunk pair, 3xTF32, both K-major: d {=, +=}
// A B^T over `steps` k8 steps; `first` overwrites d.
__device__ __forceinline__ void chunk_ss(float (&d)[32], uint32_t a,
                                         uint32_t b, int steps, bool first) {
  for (int kk = 0; kk < steps; ++kk)
    tf32x3_ss<64>(d, hi_desc(a, kk), lo_desc(a, kk), hi_desc(b, kk),
                  lo_desc(b, kk), !(first && kk == 0));
}

// d = A B with A the register fragments of 64 rows x 64 k (hi, lo) and B
// a transposed chunk.  d is a panel: the first product overwrites it, and
// the caller adds it to its running total in f32.  A total kept in the
// wgmma accumulator over a long walk (5 x 1024 queries for a key's dK at
// hymba's training shape) drifts from the sum in IEEE f32, as the tensor
// cores' adds do not round to nearest: chip_smoke's float32 K2-bwd row
// there read 5.1e-4 against the plain backward (gate 1e-4); with panels
// added in f32, 2.4e-5.
__device__ __forceinline__ void chunk_rs(float (&d)[32],
                                         const uint32_t (&ah)[8][4],
                                         const uint32_t (&al)[8][4],
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    tf32x3_rs<64>(d, ah[kk], al[kk], hi_desc(b, kk), lo_desc(b, kk),
                  kk > 0);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0.f;
}

// Open step i of a two-slot ring: this thread's copies of step i landed,
// every thread's too, and every thread is done with step i - 1 (whose slot
// step i + 1 loads into next).
__device__ __forceinline__ void ring_wait() {
  cp_async_wait<0>();
  __syncthreads();
}
// The split pass's writes visible to wgmma, for every thread.
__device__ __forceinline__ void ring_ready() {
  fence_proxy_async();
  __syncthreads();
}

}  // namespace poas_flash_tf32x3
