// K1: C = A @ B, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/matmul.py::matmul_pallas (body _matmul_kernel):
// a (M/bm, N/bn, K/bk) grid whose sequential k axis adds each block's f32
// dot into a VMEM accumulator, output in promote_types(a, b), ragged edges
// zero-padded and cropped.
//
// What bounds it on this card: float32 products must stay IEEE float32 (the
// reference's gate is rtol 1e-4 / atol 1e-3), so no TF32 tensor-core path is
// allowed and the f32 instantiation is bound by the CUDA cores' FMA rate
// (67 TFLOP/s on an H100 SXM).  At the paper's sizes (30000^3) a tile of C
// reuses every loaded element 128 times, far above the card's
// operations-per-byte balance, so it is operation bound, not byte bound.
// The bf16 instantiation shares the same CUDA-core datapath for now;
// wgmma/TMA tensor-core kernels are later work.
//
// What the design does about it:
//  * One thread block owns one BM x BN tile of C and loops over K inside the
//    block (no cross-block accumulator); 256 threads each keep an 8 x 8
//    register micro-tile, so every shared-memory load feeds 8 FMAs.
//  * A and B tiles are staged through shared memory (A transposed, padded
//    against bank conflicts); the next tile is prefetched into registers
//    while the current one is multiplied.
//  * Two-level float32 accumulation, as the Pallas kernel's per-k-block dot
//    into its accumulator: the register tile sums one KPANEL-long panel of
//    K and is then added into a per-thread running total in shared memory.
//    A single running sum over K = 30000 drifts by ~5e-4 (one sigma) from
//    the exact product and breaks atol 1e-3 near zero; the panel sum keeps
//    it near 6e-5.
//  * Edge tiles are masked, never padded, so no operand is copied.
//  * Every global offset is int64: the paper's instances reach 2.6e9
//    elements per operand.  Leading dimensions are passed in, so a row slice
//    of a larger matrix is used in place.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;            // rows of C per block
constexpr int BN = 128;            // columns of C per block
constexpr int BK = 8;              // depth of one staged tile
constexpr int TM = 8;              // rows of the per-thread micro-tile
constexpr int TN = 8;              // columns of the per-thread micro-tile
constexpr int THREADS = (BM / TM) * (BN / TN);   // 256
constexpr int KPANEL_TILES = 32;   // KPANEL = 256 elements of K per panel
constexpr int APAD = 4;            // As row padding: conflict-free stores
constexpr int A_LOADS = BM * BK / THREADS;       // 4 per thread
constexpr int B_LOADS = BK * BN / THREADS;       // 4 per thread
constexpr int TOTAL_SMEM = TM * TN * THREADS * sizeof(float);   // 64 KiB

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Column of C (within the block tile) of a thread's j-th micro-tile column:
// two groups of 4 at tx*4 and BN/2 + tx*4, so a quarter-warp's float4 reads
// of a Bs row cover 32 distinct banks.
__device__ __forceinline__ int micro_col(int tx, int j) {
  return (j < TN / 2 ? 0 : BN / 2) + tx * (TN / 2) + (j % (TN / 2));
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
gemm_kernel(const T* __restrict__ A, const T* __restrict__ B,
            T* __restrict__ C, int64_t M, int64_t N, int64_t K,
            int64_t lda, int64_t ldb, int64_t ldc) {
  __shared__ __align__(16) float As[BK][BM + APAD];   // As[k][m]
  __shared__ __align__(16) float Bs[BK][BN];          // Bs[k][n]
  extern __shared__ float total[];                    // [TM*TN][THREADS]

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  // Loader mapping: A tile rows a_r + i*32 at depth a_c; B tile depth
  // b_r + i*2 at column b_c (a warp reads 32 consecutive columns of B).
  const int a_r = tid / BK, a_c = tid % BK;
  const int b_r = tid / BN, b_c = tid % BN;
  constexpr int A_STEP = THREADS / BK;
  constexpr int B_STEP = THREADS / BN;

  float a_next[A_LOADS], b_next[B_LOADS];
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int e = 0; e < TM * TN; ++e) total[e * THREADS + tid] = 0.f;

  auto load_tile = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) {
      const int64_t r = row0 + a_r + i * A_STEP, c = k0 + a_c;
      a_next[i] = (r < M && c < K) ? to_f32(A[r * lda + c]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) {
      const int64_t r = k0 + b_r + i * B_STEP, c = col0 + b_c;
      b_next[i] = (r < K && c < N) ? to_f32(B[r * ldb + c]) : 0.f;
    }
  };

  load_tile(0);
  int panel_tiles = 0;
  for (int64_t k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) As[a_c][a_r + i * A_STEP] = a_next[i];
#pragma unroll
    for (int i = 0; i < B_LOADS; ++i) Bs[b_r + i * B_STEP][b_c] = b_next[i];
    __syncthreads();
    if (k0 + BK < K) load_tile(k0 + BK);   // overlaps the FMAs below

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a_frag[TM], b_frag[TN];
      const float4* ap = reinterpret_cast<const float4*>(&As[kk][ty * TM]);
      const float4 a0 = ap[0], a1 = ap[1];
      a_frag[0] = a0.x; a_frag[1] = a0.y; a_frag[2] = a0.z; a_frag[3] = a0.w;
      a_frag[4] = a1.x; a_frag[5] = a1.y; a_frag[6] = a1.z; a_frag[7] = a1.w;
      const float4 b0 =
          *reinterpret_cast<const float4*>(&Bs[kk][tx * (TN / 2)]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * (TN / 2)]);
      b_frag[0] = b0.x; b_frag[1] = b0.y; b_frag[2] = b0.z; b_frag[3] = b0.w;
      b_frag[4] = b1.x; b_frag[5] = b1.y; b_frag[6] = b1.z; b_frag[7] = b1.w;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          acc[i][j] = fmaf(a_frag[i], b_frag[j], acc[i][j]);
    }
    __syncthreads();

    if (++panel_tiles == KPANEL_TILES || k0 + BK >= K) {
      // Only this thread touches its slots of `total`: no barrier needed.
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          total[(i * TN + j) * THREADS + tid] += acc[i][j];
          acc[i][j] = 0.f;
        }
      panel_tiles = 0;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t c = col0 + micro_col(tx, j);
      if (c < N)
        C[r * ldc + c] = from_f32<T>(total[(i * TN + j) * THREADS + tid]);
    }
  }
}

template <typename T>
int launch(const void* a, const void* b, void* c, int64_t m, int64_t n,
           int64_t k, int64_t lda, int64_t ldb, int64_t ldc, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gemm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      TOTAL_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + BN - 1) / BN),
                  static_cast<unsigned>((m + BM - 1) / BM));
  gemm_kernel<T><<<grid, THREADS, TOTAL_SMEM,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, lda, ldb, ldc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Row-major operands with unit column
// stride; lda/ldb/ldc are row strides in elements.  The launch is queued on
// `stream` and not synchronised; the return value is cudaGetLastError().
extern "C" int poas_matmul_f32(const void* a, const void* b, void* c,
                               int64_t m, int64_t n, int64_t k, int64_t lda,
                               int64_t ldb, int64_t ldc, void* stream) {
  return launch<float>(a, b, c, m, n, k, lda, ldb, ldc, stream);
}

extern "C" int poas_matmul_bf16(const void* a, const void* b, void* c,
                                int64_t m, int64_t n, int64_t k, int64_t lda,
                                int64_t ldb, int64_t ldc, void* stream) {
  return launch<__nv_bfloat16>(a, b, c, m, n, k, lda, ldb, ldc, stream);
}
