// Shared Hopper (sm_90a) building blocks for the port's tensor-core kernels:
// the cp.async ring, the 128-byte swizzle, wgmma descriptors and issue, and
// 3xTF32 -- f32 accuracy from the TF32 tensor cores.
//
// csrc/matmul.cu (K1), csrc/flash_attention_sm90.cu (K2 in bf16),
// csrc/ssd_chunk.cu (K3) and the two backward sources,
// csrc/flash_attention_bwd_sm90.cu (bf16 m64n64k16) and
// csrc/ssd_chunk_bwd.cu (3xTF32), include this header.
//
// 3xTF32.  A tf32 operand keeps 10 of f32's 23 mantissa bits, so one TF32
// product is ~1e-3 off in relative terms: too far for the f32 gates (rtol
// 1e-4 / atol 1e-3 for K1, 1e-4 for K3).  Each f32 x is split as
//   hi = tf32(x) (round to nearest, as cvt.rna.tf32.f32),  lo = x - hi
// and a product is taken as  a_lo*b_hi + a_hi*b_lo + a_hi*b_hi,  small terms
// first.  The dropped a_lo*b_lo (< 2^-22 |ab|) and lo's truncation to its
// top 19 bits by the tensor cores (< 2^-21 |x|) keep each product within
// ~2^-20 of |ab|, random in sign: f32-like over long sums.  Three tf32
// wgmma cost 3 * ops / 495 TFLOP/s, still 2.5x under the CUDA cores'
// 67 TFLOP/s f32 FMA bound.
//
// Layout.  tf32 wgmma reads both operands K-major from shared memory (the
// transposed, MN-major form exists only for 16-bit types).  Operands that
// are MN-major in memory (K1's B, K3's xdt) are transposed by the split
// pass, which reads the raw tile that cp.async landed and writes hi and lo
// in the K-major swizzled layout: no extra global traffic.
//
// The 128-byte swizzle: a tile is stored as rows of 128 bytes (32 f32 or
// 64 bf16 of its K extent), 8 rows to a 1024-byte atom; the 16-byte chunk
// c of row r sits at chunk (c ^ (r % 8)).  Atoms must be 1024-byte aligned.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace poas_sm90 {

constexpr int kSmemLimit = 232448;   // bytes of shared memory a block may use

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..7) of row r inside a swizzled atom row.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16 bytes global -> shared, asynchronously; the first `bytes` (0..16) are
// read and the rest zero-filled.  `src` is 16-byte aligned.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
// Generic-proxy writes to shared memory (st.shared, cp.async) visible to
// the async proxy that wgmma reads through; then a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bytes of a 16-byte chunk that lie before `limit` (in elements of `size`
// bytes), starting at element `pos`: 0..16.
__device__ __forceinline__ int chunk_bytes(int64_t pos, int64_t limit,
                                           int size) {
  const int64_t left = (limit - pos) * size;
  return left <= 0 ? 0 : (left >= 16 ? 16 : static_cast<int>(left));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.  K-major: sbo is
// the stride of 8-row groups (1024 when dense), lbo unused.  MN-major
// (16-bit types only): lbo is the stride of 64-element MN blocks.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major tile: the k8 (tf32) or k16 (bf16) step `kk`, 32 bytes deep, of a
// tile whose 128-byte K atoms lie `atom_bytes` apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk,
                                                uint32_t atom_bytes) {
  return sw128_desc(base + (kk >> 2) * atom_bytes + (kk & 3) * 32, 16, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving reads of an accumulator above a wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// ---- 3xTF32 split ------------------------------------------------------
// hi = x rounded to the nearest tf32, ties away from zero: cvt.rna.tf32.f32
// on finite x, done as ptxas does it (add half a tf32 ulp to the bits,
// drop the 13 low bits) without its Inf/NaN select, which the kernels'
// finite inputs never need.  lo = x - hi is exact in f32 and goes to the
// tensor cores as it is: they read its top 19 bits, so its own rounding
// costs at most 2^-10 of |lo| <= 2^-11 |x|, i.e. 2^-21 |x|.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}
__device__ __forceinline__ void split_tf32(const float4& x, float4& hi,
                                           float4& lo) {
  split_tf32(x.x, hi.x, lo.x);
  split_tf32(x.y, hi.y, lo.y);
  split_tf32(x.z, hi.z, lo.z);
  split_tf32(x.w, hi.w, lo.w);
}

// ---- wgmma issue -------------------------------------------------------
// Accumulator layout of every m64nN f32 wgmma: d[4i + e] is row
// 16 * warp + lane / 4 + 8 * (e >> 1), column 8i + 2 * (lane % 4) + (e & 1)
// (warp and lane within the warpgroup).  The register A operand of a tf32
// k8 step holds a[0] (row g, col c), a[1] (g + 8, c), a[2] (g, c + 4),
// a[3] (g + 8, c + 4), with g = 16 * warp + lane / 4 and c = lane % 4.

#define POAS_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define POAS_D8(i) POAS_D4(i), POAS_D4(i + 4)
#define POAS_D16(i) POAS_D8(i), POAS_D8(i + 8)
#define POAS_D32(i) POAS_D16(i), POAS_D16(i + 16)
#define POAS_D64(i) POAS_D32(i), POAS_D32(i + 32)
#define POAS_R8 "%0, %1, %2, %3, %4, %5, %6, %7"
#define POAS_R16 POAS_R8 ", %8, %9, %10, %11, %12, %13, %14, %15"
#define POAS_R32                                                            \
  POAS_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
           "%28, %29, %30, %31"
#define POAS_R64                                                            \
  POAS_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
           "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "    \
           "%56, %57, %58, %59, %60, %61, %62, %63"

// m64nNk8, f32 {=, +=} tf32 * tf32; `accumulate` 0 overwrites d.  ss: A
// and B K-major in shared memory; rs: A from registers.
template <int N> struct Tf32Wgmma;

#define POAS_TF32_WGMMA(N, R, REGS, DOPS, SS_AB, SS_P, RS_AB, RS_P)          \
  template <> struct Tf32Wgmma<N> {                                          \
    static __device__ __forceinline__ void ss(float (&d)[R], uint64_t da,   \
                                              uint64_t db, int accumulate) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " SS_P ", 0;\n"         \
                   "wgmma.mma_async.sync.aligned.m64n" #N                    \
                   "k8.f32.tf32.tf32 {" REGS "}, " SS_AB ", p, 1, 1;\n}\n"   \
                   : DOPS : "l"(da), "l"(db), "r"(accumulate));              \
    }                                                                        \
    static __device__ __forceinline__ void rs(float (&d)[R],                \
                                              const uint32_t (&a)[4],       \
                                              uint64_t db, int accumulate) { \
      asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " RS_P ", 0;\n"         \
                   "wgmma.mma_async.sync.aligned.m64n" #N                    \
                   "k8.f32.tf32.tf32 {" REGS "}, " RS_AB ", p, 1, 1;\n}\n"   \
                   : DOPS : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),      \
                     "l"(db), "r"(accumulate));                              \
    }                                                                        \
  };

POAS_TF32_WGMMA(16, 8, POAS_R8, POAS_D8(0), "%8, %9", "%10",
                "{%8, %9, %10, %11}, %12", "%13")
POAS_TF32_WGMMA(32, 16, POAS_R16, POAS_D16(0), "%16, %17", "%18",
                "{%16, %17, %18, %19}, %20", "%21")
POAS_TF32_WGMMA(64, 32, POAS_R32, POAS_D32(0), "%32, %33", "%34",
                "{%32, %33, %34, %35}, %36", "%37")
POAS_TF32_WGMMA(128, 64, POAS_R64, POAS_D64(0), "%64, %65", "%66",
                "{%64, %65, %66, %67}, %68", "%69")

// d (64 x 128, f32) {=, +=} A (64 x 16 bf16, K-major smem) * B (16 x 128
// bf16, MN-major smem: the transposed B that 16-bit types allow).
__device__ __forceinline__ void bf16_wgmma_n128(float (&d)[64], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               "{" POAS_R64 "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
               : POAS_D64(0) : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) {=, +=} A (64 x 16 bf16) * B (16 x 64 bf16), for the
// K2 backward.  ss: A and B both K-major in shared memory.  rs: A from
// registers (the accumulator layout of an m64nN f32 product, rounded to
// bf16 pairs, is the A layout of m64k16), B MN-major in shared memory.
__device__ __forceinline__ void bf16_wgmma_n64_ss(float (&d)[32], uint64_t da,
                                                  uint64_t db,
                                                  int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{" POAS_R32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
               : POAS_D32(0) : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void bf16_wgmma_n64_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
               "{" POAS_R32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : POAS_D32(0)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
                 "r"(1));
}

// 3xTF32 of one k8 step on shared-memory operands, small terms first.
template <int N>
__device__ __forceinline__ void tf32x3_ss(float (&d)[N / 2], uint64_t a_hi,
                                          uint64_t a_lo, uint64_t b_hi,
                                          uint64_t b_lo, int accumulate) {
  Tf32Wgmma<N>::ss(d, a_lo, b_hi, accumulate);
  Tf32Wgmma<N>::ss(d, a_hi, b_lo, 1);
  Tf32Wgmma<N>::ss(d, a_hi, b_hi, 1);
}
// The same with A from registers.
template <int N>
__device__ __forceinline__ void tf32x3_rs(float (&d)[N / 2],
                                          const uint32_t (&a_hi)[4],
                                          const uint32_t (&a_lo)[4],
                                          uint64_t b_hi, uint64_t b_lo,
                                          int accumulate) {
  Tf32Wgmma<N>::rs(d, a_lo, b_hi, accumulate);
  Tf32Wgmma<N>::rs(d, a_hi, b_lo, 1);
  Tf32Wgmma<N>::rs(d, a_hi, b_hi, 1);
}

}  // namespace poas_sm90
