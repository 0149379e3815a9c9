// K2 on Hopper's tensor cores: causal / sliding-window GQA flash attention
// (forward) in bf16, with wgmma and a cp.async ring of K/V tiles, for sm_90a.
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (:70, body _flash_kernel): a (B, H, Sq/bq, Skv/bk) grid whose sequential
// KV axis carries a running f32 (m, l, acc); masks are causal
// (q_pos >= k_pos), sliding window (k_pos > q_pos - window, window 0 = full)
// and padding (k_pos < Skv); query head h reads KV head h // (H / KH); the
// output is in q's dtype.  Query row i sits at position q_offset + i (the
// absolute position of q[0] in chunked prefill, as the reference model
// stack's flash_attention takes it), keys at 0..Skv-1; a row that keeps no
// key is written as 0 (its l stays 0; the reference gives it a mean of V,
// C0d).  This source takes the bf16 inputs whose head dims
// Dk, Dv are multiples of 16 up to 256; csrc/flash_attention_tf32x3.cu
// (3xTF32 wgmma) takes float32 and csrc/flash_attention.cu (IEEE f32 on the
// CUDA cores) every other bf16 shape.  The wrapper's route() says which, by
// that rule and nothing else.
//
// What bounds it on this card.  At hymba-1.5B's prefill (5 x 2776 tokens,
// 25 query / 5 KV heads of 64, window 1024) the band holds 2.90e8
// (query, key) pairs: 7.42e10 operations for the two products, 0.075 ms at
// the 989 TFLOP/s bf16 tensor-core peak, against 107 MB of q, k, v, o
// (0.032 ms at 3.35 TB/s) -- operation bound.  The softmax needs one exp
// per pair, and exps run on the SFU (MUFU) at 16 a clock per SM: 2.90e8 of
// them take ~0.075 ms at 1.83 GHz, as long as the tensor work.  So the
// kernel has two bounds of the same size, and the exps matter.
//
// What the design does about it:
//  * One warpgroup (128 threads) per 64-row query tile of one head and
//    batch; the TPU's sequential KV grid axis is a loop inside the block,
//    over 64-key tiles.  Tiles wholly outside the causal/window band are
//    skipped (exact), and the heaviest query tiles are launched first.
//  * S = Q K^T on wgmma.m64n64k16 (bf16 in, f32 accumulate; products of
//    bf16 are exact in f32, so only the order of the sums changes), Q and
//    K read from shared memory in wgmma's K-major layout with the 128-byte
//    swizzle, through descriptors built here (no library).
//  * Online softmax in the accumulator's registers: each thread holds two
//    rows x 16 columns; a row's max is reduced over its quad with two
//    shuffles, its sum only once at the end.  p = exp2(s * scale*log2e -
//    m * scale*log2e), one FMA and one MUFU op (ex2.approx.ftz) per score,
//    where exp2f's denormal handling would add three more.  Masks are
//    selects (p = 0), applied only on tiles that cross the diagonal, the
//    window edge or Skv; interior tiles do no mask arithmetic.
//  * O += P V on wgmma with P as the register A operand: the f32 scores are
//    rounded to bf16 in place (the accumulator layout of m64n16 is the A
//    layout of m64k16), as the reference model stack's flash rounds P to
//    V's dtype; V is the B operand in its natural [key][dv] layout, read
//    MN-major (wgmma's transposed B for 16-bit types).
//  * K and V tiles stream through a ring of two buffers in shared memory
//    filled by 16-byte cp.async copies (zero-filled past Skv): tile t+1
//    loads while tile t is in the tensor cores.  At Dk = Dv = 64 a block
//    holds 40 KiB (Q 8 + two stages of K, V 16 each) and 128 registers a
//    thread (the launch bound for four blocks an SM), so four blocks share
//    an SM and one block's exps can overlap another's wgmma.
//  * q, k, v are read through their (B, S, H, D) strides (16-byte aligned
//    rows; the wrapper copies what is not), the output written in place.
//  * Dk is a runtime loop of 16-deep steps; Dv is a template of 64-wide
//    blocks (1-4), its padding columns computed and dropped.
//  * For training, each row's log-sum-exp of its scaled scores,
//    scale * m + ln l, is written to `lse` (B, H, Sq) f32 when the pointer
//    is not null (flash_attention_bwd.cu reads it); the serving path
//    passes null and pays one untaken branch per row.
//  * Measured no faster at hymba's shape, so not kept: a ring of 3 or 4
//    stages, and two or three warpgroups per block sharing one K/V ring
//    (half or a third of the tile loads, at fewer blocks per SM).
//
// Later work: TMA loads (a descriptor over the strided (B, S, H, D) views
// needs cuTensorMapEncodeTiled from libcuda, which the port does not bind),
// a producer warp with mbarriers, two consumer warpgroups in ping-pong so
// one's softmax hides the other's wgmma, and exp2 by polynomial on the FMA
// pipe for part of each tile.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;            // query rows per block (one wgmma M)
constexpr int BK = 64;            // keys per tile (wgmma N of S, K of PV)
constexpr int THREADS = 128;      // one warpgroup
constexpr int ATOM = 64 * 128;    // 64 rows x 128 bytes: one swizzled block
constexpr int STAGES = 2;         // K/V ring depth
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {   // element strides of a (B, S, H, D) tensor; D is unit
  int64_t b, s, h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 2^x on the SFU, denormal results flushed to 0 (weights below 2^-126).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 64 rows x d columns (d a multiple of 8) of a strided bf16 tensor into
// ceil(d/64) blocks of ATOM bytes, each in wgmma's 128-byte-swizzle layout:
// row r at r * 128 bytes, its 16-byte chunk c at (c ^ (r % 8)) * 16.
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t row0, int64_t limit,
                                          int64_t stride, int chunks,
                                          int tid) {
  for (int e = tid; e < BQ * chunks; e += THREADS) {
    const int r = e / chunks, c = e - r * chunks;
    const bool ok = row0 + r < limit;
    const __nv_bfloat16* g = ok ? src + (row0 + r) * stride + c * 8 : src;
    cp_async16(dst + (c >> 3) * ATOM + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               g, ok);
  }
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads of an accumulator above the wait.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64, f32) {=, +=} A (64 x 16, K-major smem) * B (16 x 64, K-major
// smem).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, MN-major
// smem, i.e. transposed B).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ bool kept(int64_t qp, int64_t kp, int64_t skv,
                                     int causal, int64_t window) {
  return kp < skv && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// One tile of the online softmax on the S accumulator, in place: s becomes
// P (unnormalised, f32); m, l are this thread's two rows' running max and
// its partial sum over its own columns; corr the rows' rescale factors.
// Accumulator layout (wgmma m64nN f32): s[4i + e] is row
// row0 + 8 * (e >> 1), column 8i + 2 * (lane % 4) + (e & 1).
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&s)[32], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float sl2, int64_t row0,
                                             int64_t col0, int64_t skv,
                                             int causal, int64_t window) {
  uint32_t keep = 0xffffffffu;
  if (EDGE) {
    keep = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int64_t qp = row0 + 8 * ((j & 3) >> 1);
      const int64_t kp = col0 + 8 * (j >> 2) + (j & 1);
      if (kept(qp, kp, skv, causal, window)) keep |= 1u << j;
      else s[j] = NEG_INF;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 32; ++j) mx[(j & 3) >> 1] = fmaxf(mx[(j & 3) >> 1], s[j]);
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
  for (int j = 0; j < 32; ++j) {
    const int r = (j & 3) >> 1;
    float p = exp2_ftz(fmaf(s[j], sl2, -b[r]));
    if (EDGE) p = (keep >> j) & 1u ? p : 0.f;
    s[j] = p;
    sum[r] += p;
  }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

template <int DVB>
__global__ void __launch_bounds__(THREADS, DVB == 1 ? 4 : 1)
flash_sm90_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int64_t sq, int64_t skv,
                  int64_t heads, int64_t kv_heads, int dk, int dv,
                  Strides qs, Strides ks, Strides vs, Strides os, int causal,
                  int64_t window, int64_t q_offset, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int dkb = (dk + 63) / 64;
  const uint32_t stage_bytes = static_cast<uint32_t>(dkb + DVB) * ATOM;
  const uint32_t ring = q_smem + dkb * ATOM;   // stage s: K, then V

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // Launch the latest query tiles (the longest causal rows) first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t qa0 = q_offset + q0;   // position of the tile's row 0
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / (heads / kv_heads);
  const __nv_bfloat16* qb = q + b * qs.b + h * qs.h;
  const __nv_bfloat16* kb = k + b * ks.b + kh * ks.h;
  const __nv_bfloat16* vb = v + b * vs.b + kh * vs.h;

  // The KV band this q-tile can see; tiles outside it are skipped.
  const int64_t qa_last = q_offset + (q0 + BQ < sq ? q0 + BQ : sq) - 1;
  int64_t kv_end = skv;
  if (causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (window > 0 && qa0 - window + 1 > 0) kv_begin = qa0 - window + 1;
  kv_begin -= kv_begin % BK;
  const int n_tiles = kv_end > kv_begin
      ? static_cast<int>((kv_end - kv_begin + BK - 1) / BK) : 0;

  auto load_kv = [&](int t) {
    const uint32_t st = ring + (t % STAGES) * stage_bytes;
    const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BK;
    load_rows(st, kb, k0, skv, ks.s, dk / 8, tid);
    load_rows(st + dkb * ATOM, vb, k0, skv, vs.s, dv / 8, tid);
  };
  load_rows(q_smem, qb, q0, sq, qs.s, dk / 8, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_kv(t);
    cp_async_commit();   // one group per tile, empty or not
  }

  float acc[DVB][32];
#pragma unroll
  for (int n = 0; n < DVB; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[n][j] = 0.f;
  float s[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) s[j] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2];
  const float sl2 = scale * LOG2E;
  const int row = warp * 16 + lane / 4;      // and row + 8
  const int cq = 2 * (lane % 4);
  const int ksteps = dk / 16;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of tile t landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // everyone's landed; tile t-1's stage is free
    if (t + STAGES - 1 < n_tiles) load_kv(t + STAGES - 1);
    cp_async_commit();

    const uint32_t k_st = ring + (t % STAGES) * stage_bytes;
    const uint32_t v_st = k_st + dkb * ATOM;
    const int64_t k0 = kv_begin + static_cast<int64_t>(t) * BK;

    // S = Q K^T: K-major A and B, 16 deep a step.
    wg_fence();
    for (int kk = 0; kk < ksteps; ++kk) {
      const uint32_t off = (kk >> 2) * ATOM + (kk & 3) * 32;
      wgmma_ss(s, sw128_desc(q_smem + off, 16, 1024),
               sw128_desc(k_st + off, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > qa0) ||
                      (window > 0 && k0 <= qa0 + BQ - 1 - window);
    if (edge)
      softmax_tile<true>(s, m, l, corr, sl2, qa0 + row, k0 + cq, skv, causal,
                         window);
    else
      softmax_tile<false>(s, m, l, corr, sl2, qa0 + row, k0 + cq, skv, causal,
                          window);

    uint32_t pa[4][4];   // P as the A operand, 16 keys a step
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
#pragma unroll
    for (int n = 0; n < DVB; ++n)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[n][j] *= corr[(j & 3) >> 1];

    // O += P V: V tile [key][dv] read MN-major; 16 keys (2 KiB) a step,
    // 8-key groups 1 KiB apart, 64-column blocks ATOM apart.
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < DVB; ++n)
        wgmma_rs(acc[n], pa[kk],
                 sw128_desc(v_st + n * ATOM + kk * 2048, ATOM, 1024));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int n = 0; n < DVB; ++n) fence_regs(acc[n]);
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
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = q0 + row + 8 * r;
    if (qp >= sq) continue;
#pragma unroll
    for (int n = 0; n < DVB; ++n)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = n * 64 + 8 * i + cq;
        if (col < dv)
          *reinterpret_cast<__nv_bfloat162*>(ob + qp * os.s + col) =
              __floats2bfloat162_rn(acc[n][4 * i + 2 * r] * inv[r],
                                    acc[n][4 * i + 2 * r + 1] * inv[r]);
      }
  }
}

// Dynamic shared memory of one block: Q, then the K/V ring, in 64-column
// blocks of ATOM bytes; + 1024 because the buffer is aligned up to the
// swizzle's 1024-byte period.
size_t smem_bytes(int dk, int dv) {
  const int dkb = (dk + 63) / 64, dvb = (dv + 63) / 64;
  return 1024 + static_cast<size_t>(ATOM) * (dkb + STAGES * (dkb + dvb));
}

template <int DVB>
int launch_cfg(const void* q, const void* k, const void* v, void* o,
               float* lse, int64_t batch, int64_t sq, int64_t skv,
               int64_t heads, int64_t kv_heads, int dk, int dv, Strides qs,
               Strides ks, Strides vs, Strides os, int causal,
               int64_t window, int64_t q_offset, float scale,
               cudaStream_t stream) {
  const size_t smem = smem_bytes(dk, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<DVB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  flash_sm90_kernel<DVB><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, sq, skv, heads, kv_heads, dk, dv, qs, ks, vs, os, causal, window,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of dynamic shared memory that a launch at head dims dk, dv requests.
extern "C" int poas_flash_sm90_smem(int64_t dk, int64_t dv) {
  return static_cast<int>(
      smem_bytes(static_cast<int>(dk), static_cast<int>(dv)));
}

// Plain C entry point for ctypes.  q (B, Sq, H, Dk), k (B, Skv, KH, Dk),
// v (B, Skv, KH, Dv), o (B, Sq, H, Dv), bf16, each with unit stride on its
// last dim, 16-byte aligned base and (batch, seq, head) strides that are
// multiples of 8 elements; lse (B, H, Sq) f32, contiguous, or null (not
// written); `strides` holds those 12 element strides of q, k, v, o in that
// order; q_offset >= 0 is the position of query row 0.  The caller checks
// H % KH == 0.  The launch is queued on `stream` and not synchronised; the
// return value is cudaGetLastError(), or cudaErrorInvalidValue for head dims
// other than 16, 32, ..., 256.
extern "C" int poas_flash_sm90_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int64_t batch, int64_t sq, int64_t skv,
                                    int64_t heads, int64_t kv_heads,
                                    int64_t dk, int64_t dv,
                                    const int64_t* st, int64_t causal,
                                    int64_t window, float scale,
                                    int64_t q_offset, void* stream) {
  if (dk < 16 || dk > 256 || dk % 16 || dv < 16 || dv > 256 || dv % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  auto s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(causal);
  const int ik = static_cast<int>(dk), iv = static_cast<int>(dv);
  float* l = static_cast<float*>(lse);
  switch ((dv + 63) / 64) {
    case 1:
      return launch_cfg<1>(q, k, v, o, l, batch, sq, skv, heads, kv_heads, ik,
                           iv, qs, ks, vs, os, c, window, q_offset, scale,
                           s);
    case 2:
      return launch_cfg<2>(q, k, v, o, l, batch, sq, skv, heads, kv_heads, ik,
                           iv, qs, ks, vs, os, c, window, q_offset, scale,
                           s);
    case 3:
      return launch_cfg<3>(q, k, v, o, l, batch, sq, skv, heads, kv_heads, ik,
                           iv, qs, ks, vs, os, c, window, q_offset, scale,
                           s);
    default:
      return launch_cfg<4>(q, k, v, o, l, batch, sq, skv, heads, kv_heads, ik,
                           iv, qs, ks, vs, os, c, window, q_offset, scale,
                           s);
  }
}
