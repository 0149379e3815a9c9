// K1: C = A @ B on Hopper's tensor cores (sm_90a): f32 through 3xTF32 on
// wgmma, bf16 on bf16 wgmma.
//
// Replaces src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel):
// a (M/bm, N/bn, K/bk) grid whose sequential k axis adds each block's f32
// dot into a VMEM accumulator, output in promote_types(a, b), ragged edges
// zero-padded and cropped.
//
// What bounds it on this card.  At the paper's sizes a 128 x 128 tile of C
// reuses each loaded element 128 times, far above the card's operations-
// per-byte balance: operation bound.
//  * f32: the reference's gate (rtol 1e-4 / atol 1e-3 against float64 at
//    K = 30000) is out of reach of one TF32 pass, so every product is split
//    into three TF32 products (sm90_tf32x3.cuh).  Bound 3 * 2mnk / 495
//    TFLOP/s: 308.8 ms at i1's 28309-row card partition (its 10.4 GB of
//    A, B, C take 3.1 ms at 3.35 TB/s), where the CUDA cores' f32 FMA
//    bound is 760.5 ms.
//  * bf16: one bf16 wgmma per product, bound 2mnk / 989 TFLOP/s: 0.139 ms
//    at 4096^3.
//
// What the design does about it:
//  * One block per 128 x 128 tile of C, two warpgroups of 64 rows each; the
//    TPU's sequential k axis is a loop inside the block.  Blocks are
//    rasterised in groups of 16 row tiles, so the tiles that run together
//    share A and B tiles in L2.
//  * f32: a ring of 4 raw A/B tiles, 32 deep, 3 in flight, filled by
//    16-byte cp.async (zero-filled past M, N and K; no operand is copied).
//    A lands K-major in the 128-byte-swizzle layout; B lands as it lies
//    (N contiguous).  Each warpgroup reads its A fragments from the raw
//    tile and splits them in registers (A is wgmma's register operand);
//    all 256 threads split B into hi/lo TF32 tiles, transposed into
//    K-major on the way, in one of two buffers.  Per k8 step a warpgroup
//    issues lo*hi, hi*lo, hi*hi on wgmma.m64n128k8.  The tensor cores work
//    on tile t while the threads split tile t+1.  192 KiB of shared memory.
//  * Two-level f32 accumulation, as the Pallas kernel's per-k-block dot:
//    the wgmma accumulator sums one 256-deep panel of K and is then added
//    into a running f32 total in registers.  One running sum over
//    K = 30000 drifts by ~5e-4 (one sigma) from the exact product and
//    breaks atol 1e-3 near zero.
//  * bf16: a ring of 5 tiles, 64 deep, 3 in flight; A K-major, B read
//    MN-major (wgmma's transposed B, as K2 reads V); wgmma.m64n128k16 on
//    the ring's tiles directly, one sum over K in f32, C rounded to bf16.
//  * Every global offset is int64: the paper's instances reach 2.6e9
//    elements per operand.  Leading dimensions are passed in, so a row
//    slice of a larger matrix is used in place.  Rows must start on 16
//    bytes (lda, ldb multiples of 16 bytes, aligned bases); the wrapper
//    copies operands that do not.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_tf32x3.cuh"

namespace {

using namespace poas_sm90;

constexpr int BM = 128;              // rows of C per block (two warpgroups)
constexpr int BN = 128;              // columns of C per block
constexpr int THREADS = 256;
constexpr int GROUP_M = 16;          // row tiles per rasterisation group
constexpr int TILE = BM * 128;       // bytes of a 128-row x 128-byte tile

// f32
constexpr int F_BK = 32;             // K per tile: one 128-byte row of f32
constexpr int F_RAW = 4;             // raw tiles in the ring, 3 in flight
constexpr int F_SPLIT = 2;           // B hi/lo buffer sets
constexpr int PANEL_TILES = 8;       // 256 of K per accumulator panel
constexpr int F_SMEM = 1024 + F_RAW * 2 * TILE + F_SPLIT * 2 * TILE;

// bf16
constexpr int H_BK = 64;             // K per tile: one 128-byte row of bf16
constexpr int H_STAGES = 5;          // ring depth
constexpr int H_AHEAD = 3;           // tiles in flight
constexpr int H_SMEM = 1024 + H_STAGES * 2 * TILE;

struct Tile {
  int64_t row0, col0;
};

// Grouped rasterisation of the 1-D grid over (row tile, column tile).
__device__ __forceinline__ Tile tile_of(int64_t M, int64_t N) {
  const int64_t tm = (M + BM - 1) / BM, tn = (N + BN - 1) / BN;
  const int64_t pid = blockIdx.x, per_group = GROUP_M * tn;
  const int64_t first = pid / per_group * GROUP_M;
  const int64_t rows = tm - first < GROUP_M ? tm - first : GROUP_M;
  const int64_t in = pid % per_group;
  return Tile{(first + in % rows) * BM, in / rows * BN};
}

// Rows [row0, row0 + 128) of a row-major operand, 128 bytes of K from k0,
// into a swizzled K-major tile; zero-filled past `rows` and `depth`.
template <typename T>
__device__ __forceinline__ void load_kmajor(uint32_t dst, const T* X,
                                            int64_t ld, int64_t rows,
                                            int64_t depth, int64_t row0,
                                            int64_t k0, int tid) {
  constexpr int per = 16 / sizeof(T);
  for (int e = tid; e < BM * 8; e += THREADS) {
    const int r = e >> 3, c = e & 7;
    const int64_t row = row0 + r, k = k0 + c * per;
    const int bytes = row < rows ? chunk_bytes(k, depth, sizeof(T)) : 0;
    cp_async16(dst + sw128(r, c), bytes ? X + row * ld + k : X, bytes);
  }
}

// C rows of this thread from a 64 x 128 f32 accumulator per warpgroup.
template <typename T>
__device__ __forceinline__ void store_c(T* C, int64_t ldc, int64_t M,
                                        int64_t N, Tile tl,
                                        const float (&d)[64], int tid) {
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int64_t row = tl.row0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t r = row + 8 * (e >> 1);
      const int64_t c = tl.col0 + 8 * i + 2 * (lane % 4) + (e & 1);
      if (r < M && c < N) {
        if constexpr (sizeof(T) == 4) C[r * ldc + c] = d[4 * i + e];
        else C[r * ldc + c] = __float2bfloat16(d[4 * i + e]);
      }
    }
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_f32_tf32x3(const float* __restrict__ A, const float* __restrict__ B,
                float* __restrict__ C, int64_t M, int64_t N, int64_t K,
                int64_t lda, int64_t ldb, int64_t ldc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw0);   // same bytes, generic
  const uint32_t split0 = F_RAW * 2 * TILE;          // B hi/lo, set 0
  const int tid = threadIdx.x, wg = tid / 128;
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const Tile tl = tile_of(M, N);
  const int nt = static_cast<int>((K + F_BK - 1) / F_BK);

  // Raw slot s: A (K-major, swizzled) at s * 2 * TILE, B (32 rows of K x
  // 128 columns, 512 bytes a row, as in memory) TILE after it.
  auto load_raw = [&](int t) {
    const uint32_t a = base + (t % F_RAW) * 2 * TILE, b = a + TILE;
    const int64_t k0 = static_cast<int64_t>(t) * F_BK;
    load_kmajor(a, A, lda, M, K, tl.row0, k0, tid);
    for (int e = tid; e < F_BK * 32; e += THREADS) {
      const int r = e >> 5, c = e & 31;
      const int64_t k = k0 + r, col = tl.col0 + c * 4;
      const int bytes = k < K ? chunk_bytes(col, N, 4) : 0;
      cp_async16(b + r * 512 + c * 16, bytes ? B + k * ldb + col : B, bytes);
    }
  };
  // This warpgroup's A fragments of raw tile t, split in registers: k8
  // step kk holds (row g, k 8kk + c), (g + 8, same), (g, 8kk + c + 4),
  // (g + 8, same), g = 64 wg + 16 warp + lane / 4, c = lane % 4.  A
  // warp's 8 rows read 8 distinct swizzled chunks: no bank conflict.
  const int g = wg * 64 + warp * 16 + lane / 4, cq = lane % 4;
  auto load_a = [&](int t, uint32_t (&hi)[4][4], uint32_t (&lo)[4][4]) {
    const uint8_t* ra = gbase + (t % F_RAW) * 2 * TILE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = g + 8 * (x & 1), c = 2 * kk + (x >> 1);
        float h, l;
        split_tf32(*reinterpret_cast<const float*>(
                       ra + sw128(r, c) + cq * 4), h, l);
        hi[kk][x] = __float_as_uint(h);
        lo[kk][x] = __float_as_uint(l);
      }
  };
  // Raw B of tile t -> B hi/lo of split set t % 2, K-major: chunk c of
  // row n holds k = 4c .. 4c + 3 of column n.  A warp reads 32
  // consecutive columns of each raw row, and 8 consecutive rows n write 8
  // distinct swizzled chunks.
  auto split_b = [&](int t) {
    const float* rb = reinterpret_cast<const float*>(
        gbase + (t % F_RAW) * 2 * TILE + TILE);
    uint8_t* s = gbase + split0 + (t % F_SPLIT) * 2 * TILE;
    for (int e = tid; e < BN * 8; e += THREADS) {
      const int n = e & (BN - 1), c = e >> 7;
      const float* col = rb + 4 * c * BN + n;
      float4 hi, lo;
      split_tf32(make_float4(col[0], col[BN], col[2 * BN], col[3 * BN]), hi,
                 lo);
      *reinterpret_cast<float4*>(s + sw128(n, c)) = hi;
      *reinterpret_cast<float4*>(s + TILE + sw128(n, c)) = lo;
    }
  };

  float acc[64], total[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = total[i] = 0.f;
#pragma unroll
  for (int s = 0; s < F_RAW - 1; ++s) {
    if (s < nt) load_raw(s);
    cp_async_commit();   // one group per tile, empty or not
  }
  int panel = 0;
  // One tile; the A fragments alternate between two register sets, since
  // tile t-1's products may still read theirs.
  auto step = [&](int t, uint32_t (&a_hi)[4][4], uint32_t (&a_lo)[4][4]) {
    cp_async_wait<F_RAW - 2>();   // this thread's copies of tile t landed
    // Everyone's copies landed; tile t-1's raw slot has been read; tile
    // t-2's products, which read B set t % 2 and this set of fragments,
    // are done in both warpgroups.
    __syncthreads();
    if (t + F_RAW - 1 < nt) load_raw(t + F_RAW - 1);
    cp_async_commit();
    load_a(t, a_hi, a_lo);
    split_b(t);
    fence_proxy_async();
    __syncthreads();

    const uint32_t b_hi = base + split0 + (t % F_SPLIT) * 2 * TILE;
    const uint32_t b_lo = b_hi + TILE;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < F_BK / 8; ++kk)
      tf32x3_rs<BN>(acc, a_hi[kk], a_lo[kk], kmajor_desc(b_hi, kk, 0),
                    kmajor_desc(b_lo, kk, 0), panel > 0 || kk > 0);
    wg_commit();
    fence_regs(acc);
    if (++panel == PANEL_TILES || t + 1 == nt) {   // close the panel
      wg_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) total[i] += acc[i];
      panel = 0;
    } else {
      wg_wait<1>();   // tile t-1's products are done; tile t's may run on
    }
  };
  uint32_t a0_hi[4][4], a0_lo[4][4], a1_hi[4][4], a1_lo[4][4];
  int t = 0;
  for (; t + 1 < nt; t += 2) {
    step(t, a0_hi, a0_lo);
    step(t + 1, a1_hi, a1_lo);
  }
  if (t < nt) step(t, a0_hi, a0_lo);
  store_c(C, ldc, M, N, tl, total, tid);
}

__global__ void __launch_bounds__(THREADS, 1)
gemm_bf16(const __nv_bfloat16* __restrict__ A,
          const __nv_bfloat16* __restrict__ B, __nv_bfloat16* __restrict__ C,
          int64_t M, int64_t N, int64_t K, int64_t lda, int64_t ldb,
          int64_t ldc) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int tid = threadIdx.x, wg = tid / 128;
  const Tile tl = tile_of(M, N);
  const int nt = static_cast<int>((K + H_BK - 1) / H_BK);

  // Stage s: A (K-major, swizzled) at s * 2 * TILE; B (64 rows of K x 128
  // columns) TILE after it, as two 64-column blocks of 64 swizzled
  // 128-byte rows, 8 KiB apart: wgmma's MN-major layout.
  auto load = [&](int t) {
    const uint32_t a = base + (t % H_STAGES) * 2 * TILE, b = a + TILE;
    const int64_t k0 = static_cast<int64_t>(t) * H_BK;
    load_kmajor(a, A, lda, M, K, tl.row0, k0, tid);
    for (int e = tid; e < H_BK * 16; e += THREADS) {
      const int r = e >> 4, c = e & 15;
      const int64_t k = k0 + r, col = tl.col0 + c * 8;
      const int bytes = k < K ? chunk_bytes(col, N, 2) : 0;
      cp_async16(b + (c >> 3) * (TILE / 2) + sw128(r, c & 7),
                 bytes ? B + k * ldb + col : B, bytes);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
  for (int s = 0; s < H_AHEAD; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_async_wait<H_AHEAD - 1>();
    fence_proxy_async();
    // Tile t landed everywhere; tile t-2's wgmma are done in both
    // warpgroups, so its stage, (t + 3) % 5, may be refilled.
    __syncthreads();
    if (t + H_AHEAD < nt) load(t + H_AHEAD);
    cp_async_commit();

    const uint32_t a = base + (t % H_STAGES) * 2 * TILE + wg * (TILE / 2);
    const uint32_t b = base + (t % H_STAGES) * 2 * TILE + TILE;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < H_BK / 16; ++kk)
      bf16_wgmma_n128(acc, kmajor_desc(a, kk, 0),
                      sw128_desc(b + kk * 2048, TILE / 2, 1024),
                      t > 0 || kk > 0);
    wg_commit();
    fence_regs(acc);
    wg_wait<1>();
  }
  wg_wait<0>();
  fence_regs(acc);
  store_c(C, ldc, M, N, tl, acc, tid);
}

template <typename T, typename Kernel>
int launch(Kernel kernel, int smem, const void* a, const void* b, void* c,
           int64_t m, int64_t n, int64_t k, int64_t lda, int64_t ldb,
           int64_t ldc, void* stream) {
  constexpr int64_t per = 16 / sizeof(T);
  if (lda % per || ldb % per ||
      (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);   // rows not 16-aligned
  const int64_t blocks = ((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Row-major operands with unit column
// stride; lda/ldb/ldc are row strides in elements, lda and ldb multiples of
// 16 bytes and a, b 16-byte aligned (else cudaErrorInvalidValue, nothing
// launched).  The launch is queued on `stream` and not synchronised; the
// return value is cudaGetLastError().
extern "C" int poas_matmul_f32(const void* a, const void* b, void* c,
                               int64_t m, int64_t n, int64_t k, int64_t lda,
                               int64_t ldb, int64_t ldc, void* stream) {
  return launch<float>(gemm_f32_tf32x3, F_SMEM, a, b, c, m, n, k, lda, ldb,
                       ldc, stream);
}

extern "C" int poas_matmul_bf16(const void* a, const void* b, void* c,
                                int64_t m, int64_t n, int64_t k, int64_t lda,
                                int64_t ldb, int64_t ldc, void* stream) {
  return launch<__nv_bfloat16>(gemm_bf16, H_SMEM, a, b, c, m, n, k, lda, ldb,
                               ldc, stream);
}
