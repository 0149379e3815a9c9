// K2 on Hopper's tensor cores: causal / sliding-window GQA flash attention
// (forward) in bf16, with wgmma, for sm_90a: warp-specialised, a TMA
// producer and two consumer warpgroups in ping-pong.
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
// What bounds it on this card.  A kept (query, key) pair costs 2 (Dk + Dv)
// operations on the tensor cores (320 at MLA's 96 / 64: 3.2e-13 s at the
// 989 TFLOP/s bf16 peak) and one exp on the SFU (MUFU, 16 a clock per SM:
// 2.6e-13 s at 1.83 GHz over 132 SMs), 80 % of the tensor time; q, k, v, o
// are read and written once per tile pass, far under HBM's rate.  So the
// kernel has two bounds of nearly the same size.  Done one after the other
// they cap it near 56 % of its roofline; done side by side, the tensor
// cores alone bound it.
//
// The arithmetic:
//  * S = Q K^T on wgmma (bf16 in, f32 accumulate; products of bf16 are
//    exact in f32, so only the order of the sums changes), Q and K read
//    from shared memory in wgmma's K-major layout with the 128-byte swizzle
//    (csrc/sm90_tf32x3.cuh), through descriptors built here (no library).
//  * Online softmax in the accumulator's registers: each thread holds two
//    rows of the tile; a row's max is reduced over its quad with two
//    shuffles, its sum only once at the end.  p = exp2(s * scale*log2e -
//    m * scale*log2e), one FMA and one MUFU op (ex2.approx.ftz) per score,
//    where exp2f's denormal handling would add three more.  Masks are
//    selects (p = 0), applied only on tiles that cross the diagonal, the
//    window edge or Skv; interior tiles do no mask arithmetic, and tiles
//    wholly outside the causal/window band are skipped (exact).  The
//    heaviest query tiles (the longest causal rows) are launched first.
//  * O += P V on wgmma with P as the register A operand: the softmax
//    writes each score's weight rounded to bf16 straight into it (the
//    accumulator layout of m64nN is the A layout of m64k16) and leaves S
//    as it is, as the reference model stack's flash rounds P to V's dtype;
//    V is the B operand in its natural [key][dv] layout, read MN-major
//    (wgmma's transposed B for 16-bit types).
//  * q, k, v are read through their (B, S, H, D) strides (16-byte aligned
//    rows; the wrapper copies what is not), the output written in place
//    from the accumulators.  Dk is a runtime loop of 16-deep steps; Dv is a
//    template of 64-wide blocks (1-4), its padding columns computed and
//    dropped.
//  * For training, each row's log-sum-exp of its scaled scores,
//    scale * m + ln l, is written to `lse` (B, H, Sq) f32 when the pointer
//    is not null (the backward kernels read it); the serving path passes
//    null and pays one untaken branch per row.
//
// The design:
//  * A block of 384 threads takes a 128-row query tile of one head and
//    batch.  Warpgroup 0 is the producer: one thread keeps K/V tiles in
//    flight through a ring of 2-4 stages (as many as shared memory holds)
//    with TMA (cp.async.bulk.tensor over the (B, S, H, D) strided views;
//    the descriptors come from cuTensorMapEncodeTiled, reached through the
//    runtime's cudaGetDriverEntryPoint, since the port links no libcuda),
//    each stage guarded by a full and an empty mbarrier.  Out-of-range rows
//    and columns land as zeros.  It keeps 24 registers (setmaxnreg); the
//    consumers take 240, which balances only if ptxas gave the kernel 168:
//    the launch checks that count and fails where it differs.
//  * Warpgroups 1 and 2 each own 64 rows of the tile and read every K/V
//    tile once (half the K/V loads per query row of one warpgroup a tile).
//    They never copy and never __syncthreads() in the loop.  Two named
//    barriers order them in ping-pong: a warpgroup issues its products
//    only after the other has issued its own, so one's softmax runs while
//    the other's products hold the tensor cores.
//  * Inside a consumer, tile t's S = Q K(t)^T and the previous tile's
//    O += P(t-1) V(t-1) are issued together, and the wait is
//    wgmma.wait_group 1: the softmax of tile t starts when S(t) lands,
//    while PV(t-1) still runs, and writes P(t) into the other of two P
//    buffers.  O is rescaled before the next pair is issued, while no
//    product is in flight: ptxas serialises every wgmma of a kernel where
//    other instructions write a live accumulator (its C7515 report).
//  * Keys a tile and ring stages come from the wrapper (sm90_plan in
//    flash_attention.py, by (Dk, Dv) alone: 128 keys, S on
//    wgmma.m64n128k16, where Dk <= 128 and Dv <= 128, else 64; as many
//    stages, 2-4, as fit); the entry checks that the launch fits a block's
//    shared memory and that an instantiation takes that tile.
//
// It replaced one warpgroup per 64-row query tile over a two-stage
// cp.async ring, with one __syncthreads() a tile and the products and the
// softmax strictly in turn.  Measured on an H100 80GB HBM3 at 700 W
// (chip_smoke.py's rows, CUDA events) against that loop: MLA's prefill of
// 4 x 16384 tokens, 40 heads, 96 / 64, window 0, 14.3 ms against 33.4
// (48.7 % of the 6.95 ms bound against 20.8; sdpa's is_causal 14.7);
// 5 x 2776 at Dk 128 1.13 against 2.57, at 160 1.01 against 3.41; hymba's
// window 1024 0.41 against 0.47, where a 128-row tile sees at most 10 key
// tiles.
//
// What bounds it now.  At MLA's prefill the products alone take 6.95 ms
// and the exps alone 5.6 (2.1e10 kept pairs at 16 a clock per SM); 14.3 ms
// is near their sum, so the ping-pong hides only part of the softmax.  A
// warpgroup's 64 x 128 tile holds the tensor cores ~640 clocks, and its
// 8192 exps hold the SM's SFU, which both warpgroups share, ~512, beside
// the softmax's FMAs, maxima, mask selects and bf16 packing in the same
// issue slots: the two halves of a ping-pong are nearly equal, so a stall
// in either shows in the other.  Which stall it is has not been measured.
//
// Measured and not kept: the softmax written over S in place (ptxas's
// C7515 serialised the kernel: 19.3 ms at MLA's prefill); the S loop
// unrolled over 16 steps (no faster); S(t) and PV(t-1) waited together
// (wait_group 0), 5 % slower at MLA, even at Dk 128 and 160.  In the loop
// it replaced, a ring of 3 or 4 stages, and two or three warpgroups per
// block sharing one K/V ring that they load themselves and meet at
// __syncthreads() (hymba's shape, window 1024).
//
// Later work: exp2 by polynomial on the FMA pipe for part of each tile;
// a persistent grid, so one tile's epilogue overlaps the next one's loads;
// the spills of the widest instantiations (ptxas, chip_smoke's build).
#include <cstdint>
#include <type_traits>

#include <cuda.h>   // CUtensorMap and its enums (types only; no libcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90_tf32x3.cuh"

namespace {

using namespace poas_sm90;

constexpr int BQ = 128;           // query rows per block
constexpr int THREADS = 384;      // producer + two consumer warpgroups
constexpr int MIN_STAGES = 2, MAX_STAGES = 4;
constexpr int BARRIERS = 256;     // bytes for the ring's and Q's mbarriers
// Registers a thread is launched with, and what setmaxnreg gives
// back: the producer's 128 threads drop to 24, the consumers' 256 rise to
// 240, which balances only at (128 * 24 + 256 * 240) / 384 = 168 (the most
// __launch_bounds__(384, 1) allows).  At any other count setmaxnreg.inc
// would wait forever, so the launch checks it.
constexpr int REGS = 168;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS == THREADS * REGS,
              "setmaxnreg must balance");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ bool kept(int64_t qp, int64_t kp, int64_t skv,
                                     int causal, int64_t window) {
  return kp < skv && (!causal || kp <= qp) &&
         (window <= 0 || kp > qp - window);
}

// Whether a tile of keys k0..k0+bk-1 needs masks for the 64 rows at
// positions qa0..qa0+63.
__device__ __forceinline__ bool edge_tile(int64_t k0, int bk, int64_t qa0,
                                          int64_t skv, int causal,
                                          int64_t window) {
  return k0 + bk > skv || (causal && k0 + bk - 1 > qa0) ||
         (window > 0 && k0 <= qa0 + 63 - window);
}

// One tile of the online softmax on an S accumulator of N registers (N / 2
// keys), which it only reads: P (unnormalised, rounded to bf16) goes to
// pa, the A operand of N / 8 16-key steps of O += P V; m, l are this
// thread's two rows' running max and its partial sum over its own
// columns; corr the rows' rescale factors.  Accumulator layout (wgmma
// m64nN f32): s[4i + e] is row row0 + 8 * (e >> 1), column
// 8i + 2 * (lane % 4) + (e & 1); the A operand of a 16-key step kk holds
// pa[kk][x] = the pair s[8kk + 2x], s[8kk + 2x + 1].  S stays untouched
// because ptxas serialises wgmma when other instructions write a wgmma's
// accumulator while another product is in flight.
template <int N, bool EDGE>
__device__ __forceinline__ void softmax_tile(const float (&s)[N],
                                             uint32_t (&pa)[N / 8][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2,
                                             int64_t row0, int64_t col0,
                                             int64_t skv, int causal,
                                             int64_t window) {
  using Bits = std::conditional_t<(N > 32), uint64_t, uint32_t>;
  Bits keep = ~Bits(0);
  if (EDGE) {
    keep = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t qp = row0 + 8 * ((j & 3) >> 1);
      const int64_t kp = col0 + 8 * (j >> 2) + (j & 1);
      keep |= Bits(kept(qp, kp, skv, causal, window)) << j;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float x = EDGE && !((keep >> j) & 1) ? NEG_INF : s[j];
    mx[(j & 3) >> 1] = fmaxf(mx[(j & 3) >> 1], x);
  }
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
  for (int kk = 0; kk < N / 8; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int j = 8 * kk + 2 * x, r = x & 1;
      float p0 = exp2_ftz(fmaf(s[j], sl2, -b[r]));
      float p1 = exp2_ftz(fmaf(s[j + 1], sl2, -b[r]));
      if (EDGE) {
        p0 = (keep >> j) & 1 ? p0 : 0.f;
        p1 = (keep >> (j + 1)) & 1 ? p1 : 0.f;
      }
      sum[r] += p0;
      sum[r] += p1;
      pa[kk][x] = pack_bf16(p0, p1);
    }
  l[0] = l[0] * corr[0] + sum[0];
  l[1] = l[1] * corr[1] + sum[1];
}

template <int N>
__device__ __forceinline__ void softmax(bool edge, const float (&s)[N],
                                        uint32_t (&pa)[N / 8][4],
                                        float (&m)[2], float (&l)[2],
                                        float (&corr)[2], float sl2,
                                        int64_t row0, int64_t col0,
                                        int64_t skv, int causal,
                                        int64_t window) {
  if (edge)
    softmax_tile<N, true>(s, pa, m, l, corr, sl2, row0, col0, skv, causal,
                          window);
  else
    softmax_tile<N, false>(s, pa, m, l, corr, sl2, row0, col0, skv, causal,
                           window);
}

// Keeps the compiler from reusing P's registers while a wgmma that reads
// them may still run.
template <int K>
__device__ __forceinline__ void fence_p(uint32_t (&pa)[K][4]) {
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) asm volatile("" : "+r"(pa[kk][x]) :: "memory");
}

// The 64 rows' normaliser and log-sum-exp, then O written from the
// accumulators: rows q_row0 + row and + 8 of (b, h), those below sq.
template <int DVB>
__device__ __forceinline__ void store_rows(const float (&acc)[DVB][32],
                                           const float (&m)[2],
                                           const float (&l)[2],
                                           __nv_bfloat16* __restrict__ o,
                                           float* __restrict__ lse,
                                           int64_t q_row0, int row, int lane,
                                           int64_t sq, int64_t b, int64_t h,
                                           int64_t heads, int dv, Strides os,
                                           float scale) {
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l[r] + __shfl_xor_sync(0xffffffffu, l[r], 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    inv[r] = 1.f / fmaxf(x, 1e-30f);
    const int64_t qp = q_row0 + row + 8 * r;
    if (lse != nullptr && (lane & 3) == 0 && qp < sq)
      lse[(b * heads + h) * sq + qp] =
          x > 0.f ? m[r] * scale + logf(x) : NEG_INF;
  }
  const int cq = 2 * (lane % 4);
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t qp = q_row0 + row + 8 * r;
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

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// The producer's arrival on a full barrier, with the bytes its TMA loads
// will bring.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// An arrival by the threads whose `lane` is 0, predicated, not branched
// (a branch between wgmma issues makes ptxas serialise them).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, int lane) {
  asm volatile("{\n.reg .pred p;\nsetp.eq.s32 p, %1, 0;\n"
               "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
               :: "r"(bar), "r"(lane) : "memory");
}
// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// One box of a 4-D tensor map, (column, head, row, batch), into shared
// memory; completion is counted on `bar` in bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int head, int row,
                                         int batch, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(col),
         "r"(head), "r"(row), "r"(batch), "r"(bar)
      : "memory");
}

// Named barriers 1 and 2, one a consumer warpgroup: it waits on its own,
// and the other warpgroup arrives there (256 threads in all).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

// d (64 x 128, f32) {=, +=} A (64 x 16 bf16, K-major smem) * B (16 x 128
// bf16, K-major smem).
__device__ __forceinline__ void bf16_wgmma_n128_ss(float (&d)[64],
                                                   uint64_t da, uint64_t db,
                                                   int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
               "{" POAS_R64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
               : POAS_D64(0) : "l"(da), "l"(db), "r"(accumulate));
}

// S (64 x KT) = Q K^T over dk / 16 steps; Q's 64-column blocks lie q_blk
// bytes apart, K's k_blk.
template <int KT>
__device__ __forceinline__ void s_product(float (&s)[KT / 2], uint32_t qa,
                                          uint32_t q_blk, uint32_t k_st,
                                          uint32_t k_blk, int ksteps) {
  for (int kk = 0; kk < ksteps; ++kk) {
    const uint64_t da = kmajor_desc(qa, kk, q_blk);
    const uint64_t db = kmajor_desc(k_st, kk, k_blk);
    if constexpr (KT == 128) bf16_wgmma_n128_ss(s, da, db, kk > 0);
    else bf16_wgmma_n64_ss(s, da, db, kk > 0);
  }
}

// O += P V over KT keys: V's 64-column blocks lie KT * 128 bytes apart.
template <int KT, int DVB>
__device__ __forceinline__ void pv_product(float (&acc)[DVB][32],
                                           const uint32_t (&pa)[KT / 16][4],
                                           uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk)
#pragma unroll
    for (int n = 0; n < DVB; ++n)
      bf16_wgmma_n64_rs(acc[n], pa[kk],
                        sw128_desc(v_st + n * KT * 128 + kk * 2048, KT * 128,
                                   1024));
}

template <int KT, int DVB>
__global__ void __launch_bounds__(THREADS, 1)
flash_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                  __grid_constant__ const CUtensorMap tk,
                  __grid_constant__ const CUtensorMap tv,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int64_t sq, int64_t skv, int64_t heads, int64_t kv_heads,
                  int dk, int dv, Strides os, int causal, int64_t window,
                  int64_t q_offset, float scale, int stages) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_smem = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const int dkb = (dk + 63) / 64;
  const uint32_t q_blk = BQ * 128, kv_blk = KT * 128;
  const uint32_t k_bytes = dkb * kv_blk;
  const uint32_t stage_bytes = k_bytes + DVB * kv_blk;   // K, then V
  const uint32_t ring = q_smem + dkb * q_blk;
  const uint32_t bars = ring + stages * stage_bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (MAX_STAGES + s); };
  const uint32_t q_full = bars + 16 * MAX_STAGES;

  // The warpgroup's index, read from lane 0 so that ptxas knows it is the
  // same across the warp (its products are then issued on a uniform path).
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  // Launch the latest query tiles (the longest causal rows) first.
  const int64_t q0 = static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * BQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / (heads / kv_heads);

  // The KV band the tile's 128 rows can see; tiles outside it are skipped.
  const int64_t qa_last = q_offset + (q0 + BQ < sq ? q0 + BQ : sq) - 1;
  int64_t kv_end = skv;
  if (causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (window > 0 && q_offset + q0 - window + 1 > 0)
    kv_begin = q_offset + q0 - window + 1;
  kv_begin -= kv_begin % KT;
  const int n_tiles = kv_end > kv_begin
      ? static_cast<int>((kv_end - kv_begin + KT - 1) / KT) : 0;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full(s), 1);     // the producer's expect_tx
      mbar_init(empty(s), 8);    // one lane of each consumer warp
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {   // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                 :: "n"(PRODUCER_REGS) : "memory");
    if (tid == 0 && n_tiles > 0) {
      mbar_expect_tx(q_full, dkb * q_blk);
      for (int c = 0; c < dkb; ++c)
        tma_load(q_smem + c * q_blk, &tq, 64 * c, static_cast<int>(h),
                 static_cast<int>(q0), static_cast<int>(b), q_full);
      int s = 0;
      uint32_t phase = 0;
      for (int t = 0; t < n_tiles; ++t) {
        mbar_wait(empty(s), phase ^ 1);   // the first round finds it free
        const uint32_t st = ring + s * stage_bytes;
        const int k0 =
            static_cast<int>(kv_begin + static_cast<int64_t>(t) * KT);
        mbar_expect_tx(full(s), stage_bytes);
        for (int c = 0; c < dkb; ++c)
          tma_load(st + c * kv_blk, &tk, 64 * c, static_cast<int>(kh), k0,
                   static_cast<int>(b), full(s));
        for (int c = 0; c < DVB; ++c)
          tma_load(st + k_bytes + c * kv_blk, &tv, 64 * c,
                   static_cast<int>(kh), k0, static_cast<int>(b), full(s));
        if (++s == stages) {
          s = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // A consumer: warpgroup c + 1 owns rows 64c..64c+63 of the tile.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
               :: "n"(CONSUMER_REGS) : "memory");
  const int c = wg - 1;
  const int ctid = tid - 128 * wg, warp = ctid / 32, lane = ctid % 32;
  const int row = warp * 16 + lane / 4;      // and row + 8
  const int cq = 2 * (lane % 4);
  const int64_t q_row0 = q0 + 64 * c;
  const int64_t qa0 = q_offset + q_row0;
  const uint32_t qa = q_smem + c * 64 * 128;
  const int ksteps = dk / 16;
  const float sl2 = scale * LOG2E;
  // Ping-pong: warpgroup c issues after waiting on barrier 1 + c, then
  // lets the other one issue; warpgroup 1 goes first.
  const int mine = 1 + c, other = 2 - c;
  if (c == 1) named_arrive(other);

  float acc[DVB][32];
#pragma unroll
  for (int n = 0; n < DVB; ++n)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[n][j] = 0.f;
  float s[KT / 2];
  uint32_t pa[2][KT / 16][4];   // P of tiles t-1 and t, alternately
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, corr[2] = {1.f, 1.f};
  int st = 0;          // the ring stage of the newest tile
  uint32_t phase = 0;

  // Tile t (>= 1): O to tile t-1's running max, then S(t) and
  // O += P(t-1) V(t-1) issued together; the softmax of tile t into p_next
  // while PV(t-1), which reads p_prev, may still run.
  auto step = [&](int t, uint32_t (&p_prev)[KT / 16][4],
                  uint32_t (&p_next)[KT / 16][4]) {
    const int prev = st;
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
    const int64_t k0 = kv_begin + static_cast<int64_t>(t) * KT;
#pragma unroll
    for (int n = 0; n < DVB; ++n) {
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[n][j] *= corr[(j & 3) >> 1];
      fence_regs(acc[n]);
    }
    fence_regs(s);
    mbar_wait(full(st), phase);
    named_sync(mine);
    wg_fence();
    s_product<KT>(s, qa, q_blk, ring + st * stage_bytes, kv_blk, ksteps);
    wg_commit();
    pv_product<KT, DVB>(acc, p_prev, ring + prev * stage_bytes + k_bytes);
    wg_commit();
    named_arrive(other);
    wg_wait<1>();   // S(t) has landed; PV(t-1) may still run
    fence_regs(s);
    softmax(edge_tile(k0, KT, qa0, skv, causal, window), s, p_next, m, l,
            corr, sl2, qa0 + row, k0 + cq, skv, causal, window);
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < DVB; ++n) fence_regs(acc[n]);
    fence_p(p_prev);
    mbar_arrive_lane0(empty(prev), lane);   // stage prev is read
  };

  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    mbar_wait(full(0), 0);
    named_sync(mine);
    fence_regs(s);
    wg_fence();
    s_product<KT>(s, qa, q_blk, ring, kv_blk, ksteps);
    wg_commit();
    named_arrive(other);
    wg_wait<0>();
    fence_regs(s);
    softmax(edge_tile(kv_begin, KT, qa0, skv, causal, window), s, pa[0], m,
            l, corr, sl2, qa0 + row, kv_begin + cq, skv, causal, window);
    int t = 1;
    for (; t + 1 < n_tiles; t += 2) {
      step(t, pa[0], pa[1]);
      step(t + 1, pa[1], pa[0]);
    }
    const bool odd = t < n_tiles;   // one tile left, P then in pa[1]
    if (odd) step(t, pa[0], pa[1]);
#pragma unroll
    for (int n = 0; n < DVB; ++n) {
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[n][j] *= corr[(j & 3) >> 1];
      fence_regs(acc[n]);
    }
    wg_fence();
    const uint32_t v_st = ring + st * stage_bytes + k_bytes;
    if (odd) pv_product<KT, DVB>(acc, pa[1], v_st);
    else pv_product<KT, DVB>(acc, pa[0], v_st);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < DVB; ++n) fence_regs(acc[n]);
  }
  // Warpgroup 2's last arrival on barrier 1 (its first, when the band is
  // empty) meets this wait, so each barrier ends as it began.
  if (c == 0) named_sync(mine);
  store_rows(acc, m, l, o, lse, q_row0, row, lane, sq, b, h, heads, dv, os,
             scale);
}

// ---- launch ---------------------------------------------------------------

// Dynamic shared memory of a launch (bytes): 1024 for aligning the buffer
// up to the swizzle's 1024-byte period, Q's 128 rows, `stages` stages of
// K and V at `kt` keys, the mbarriers.
int smem_bytes(int dk, int dv, int kt, int stages) {
  const int dkb = (dk + 63) / 64, dvb = (dv + 63) / 64;
  return 1024 + dkb * BQ * 128 + stages * (dkb + dvb) * kt * 128 + BARRIERS;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (null if the
// driver lacks it).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
        ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A 4-D map (D, H, S, B) of a strided bf16 (B, S, H, D) tensor whose box is
// 64 columns x `rows` rows of one head and batch, landing in the 128-byte
// swizzle; rows and columns past the tensor read as 0.
bool tensor_map(CUtensorMap* map, const void* ptr, int64_t batch,
                int64_t seq, int64_t heads, int64_t d, Strides st,
                int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int64_t ext[3] = {heads, seq, batch}, el[3] = {st.h, st.s, st.b};
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = static_cast<cuuint64_t>(ext[i] > 0 ? ext[i] : 1);
    // a dimension of extent 1 is never stepped: any stride will do
    strides[i] = static_cast<cuuint64_t>(ext[i] > 1 ? el[i] * 2 : 16);
  }
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int64_t batch, sq, skv, heads, kv_heads;
  int dk, dv;
  Strides qs, ks, vs, os;
  int causal;
  int64_t window, q_offset;
  float scale;
  int stages, smem;
  cudaStream_t stream;
};

template <int KT, int DVB>
int launch(const Args& a) {
  // The registers ptxas gave this instantiation, read once (REGS).
  static const int regs = [] {
    cudaFuncAttributes attr{};
    return cudaFuncGetAttributes(&attr, flash_sm90_kernel<KT, DVB>) ==
        cudaSuccess ? attr.numRegs : -1;
  }();
  if (regs != REGS) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, a.q, a.batch, a.sq, a.heads, a.dk, a.qs, BQ) ||
      !tensor_map(&tk, a.k, a.batch, a.skv, a.kv_heads, a.dk, a.ks, KT) ||
      !tensor_map(&tv, a.v, a.batch, a.skv, a.kv_heads, a.dv, a.vs, KT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      flash_sm90_kernel<KT, DVB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      a.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((a.sq + BQ - 1) / BQ),
                  static_cast<unsigned>(a.heads),
                  static_cast<unsigned>(a.batch));
  flash_sm90_kernel<KT, DVB><<<grid, THREADS, a.smem, a.stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(a.o), a.lse, a.sq, a.skv,
      a.heads, a.kv_heads, a.dk, a.dv, a.os, a.causal, a.window, a.q_offset,
      a.scale, a.stages);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  keys (64, or 128 where Dv <= 128) and
// stages (2-4) are the K/V tile and ring depth the wrapper plans; q
// (B, Sq, H, Dk), k (B, Skv, KH, Dk), v (B, Skv, KH, Dv), o (B, Sq, H, Dv),
// bf16, each with unit stride on its last dim, 16-byte aligned base and
// (batch, seq, head) strides that are multiples of 8 elements (nonzero
// where the extent is above 1); lse (B, H, Sq) f32, contiguous, or null
// (not written); `strides` holds those 12 element strides of q, k, v, o in
// that order; q_offset >= 0 is the position of query row 0.  The caller
// checks H % KH == 0.  The launch is queued on `stream` and not
// synchronised; the return value is cudaGetLastError(), or
// cudaErrorInvalidValue for head dims other than 16, 32, ..., 256, a tile
// or ring no instantiation takes or a block's shared memory does not hold,
// views no tensor map describes, or a kernel whose register count is not
// the one its setmaxnreg split needs.
extern "C" int poas_flash_sm90_bf16(int64_t keys, int64_t stages,
                                    const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int64_t batch, int64_t sq, int64_t skv,
                                    int64_t heads, int64_t kv_heads,
                                    int64_t dk, int64_t dv,
                                    const int64_t* st, int64_t causal,
                                    int64_t window, float scale,
                                    int64_t q_offset, void* stream) {
  const int dvb = static_cast<int>((dv + 63) / 64);
  if (dk < 16 || dk > 256 || dk % 16 || dv < 16 || dv > 256 || dv % 16 ||
      !(keys == 64 || (keys == 128 && dvb <= 2)) || stages < MIN_STAGES ||
      stages > MAX_STAGES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(static_cast<int>(dk), static_cast<int>(dv),
                              static_cast<int>(keys),
                              static_cast<int>(stages));
  if (smem > kSmemLimit) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, static_cast<float*>(lse), batch, sq, skv, heads,
               kv_heads, static_cast<int>(dk), static_cast<int>(dv),
               Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
               Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
               static_cast<int>(causal), window, q_offset, scale,
               static_cast<int>(stages), smem,
               static_cast<cudaStream_t>(stream)};
  if (keys == 128) return dvb == 1 ? launch<128, 1>(a) : launch<128, 2>(a);
  switch (dvb) {
    case 1: return launch<64, 1>(a);
    case 2: return launch<64, 2>(a);
    case 3: return launch<64, 3>(a);
    default: return launch<64, 4>(a);
  }
}
