// K2: causal / sliding-window GQA flash attention (forward), hand-written
// for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body _flash_kernel): a (B, H, Sq/bq, Skv/bk) grid whose sequential KV axis
// carries a running f32 (m, l, acc) in VMEM; q, k and v are upcast to f32
// before both products; masks are causal (q_pos >= k_pos), sliding window
// (k_pos > q_pos - window, window 0 = full) and padding (k_pos < Skv);
// query head h reads KV head h // (H / KH); the output is in q's dtype.
// Query row i sits at position q_offset + i (q_offset >= 0, the absolute
// position of q[0] in chunked prefill, as the reference model stack's
// flash_attention takes it); keys sit at 0..Skv-1.  A row that keeps no key
// is written as 0: masked scores are dropped, so its l stays 0 and
// acc / max(l, 1e-30) is 0 (the reference gives it a mean of V, C0d).
//
// Route: the wrapper sends bf16 here at head dims that are not multiples
// of 16 (bf16 at multiples of 16 runs on the tensor cores in
// flash_attention_sm90.cu, float32 as 3xTF32 in flash_attention_tf32x3.cu).
// Its float32 entry, the first design of the float32 route, is reached only
// by a caller that names the route "simt" (the wrapper's _launch), to time
// it beside flash_attention_tf32x3.cu.
//
// What bounds it on this card: at hymba-1.5B's prefill (25 query heads,
// head_dim 64, prompts of a few thousand tokens) the two products do
// ~4 * Sq * band * Dk operations per head against ~2 * S * D bytes per head
// read and written, hundreds of operations per byte: it is operation bound,
// by the 67 TFLOP/s f32 CUDA-core peak.  It keeps the Pallas kernel's f32
// arithmetic.
//
// What the design does about it:
//  * One block per (q-tile of 64 rows, q-head, batch); the TPU's sequential
//    KV grid axis is a loop inside the block.  K/V tiles of 64 keys are
//    staged in shared memory as f32; each thread keeps the running m, l and
//    its slice of acc for 4 query rows in registers, and computes a 4 x 4
//    micro-tile of scores, so every shared-memory load feeds 2-4 FMAs.
//  * KV tiles wholly above the causal diagonal or wholly before the window
//    are skipped, which is exact.  Masked scores are dropped by a select
//    (p = 0), never through exp(-1e30 - m), so no tile can leave a row with
//    stale weight, whichever tile is its last.
//  * q, k, v and o are read and written through their (B, S, H, D) strides
//    (unit stride on D only): no transpose and no padded copy.  Ragged
//    edges are masked.
//  * Any Dk, Dv <= 256 (the zoo has 64, 96, 128, 160 and MLA's 96/64): the
//    depth is a runtime loop and the output columns per thread a template
//    (4, 8 or 16), so nothing is padded in memory.  The window is a runtime
//    argument, so per-layer windows share one instantiation.
//  * For training, each row's log-sum-exp of its scaled scores, m + ln l,
//    is written to `lse` (B, H, Sq) f32 when the pointer is not null
//    (flash_attention_bwd.cu reads it); the serving path passes null.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per staged tile
constexpr int THREADS = 256;
constexpr int RT = 4;            // query rows per thread: BQ / (THREADS / 16)
constexpr int CT = 4;            // score columns per thread: BK / 16
constexpr float NEG_INF = -1e30f;

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

struct Strides {   // element strides of a (B, S, H, D) tensor; D is unit
  int64_t b, s, h;
};

__device__ __forceinline__ bool kept(int64_t qp, int64_t kp, int64_t skv,
                                     int causal, int64_t window) {
  return kp < skv && (!causal || kp <= qp) && (window <= 0 ||
                                               kp > qp - window);
}

// The 16 lanes of a half-warp share a query row.  The xor butterfly gives
// every lane the same (bitwise) result.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DVT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int64_t sq,
                 int64_t skv, int64_t heads, int64_t kv_heads, int dk, int dv,
                 Strides qs, Strides ks, Strides vs, Strides os, int causal,
                 int64_t window, int64_t q_offset, float scale) {
  extern __shared__ float smem[];
  const int ldk = dk + 1;        // odd row pitch: conflict-free K reads
  constexpr int LDP = BK + 1;
  float* Qs = smem;              // [BQ][ldk]
  float* Ks = Qs + BQ * ldk;     // [BK][ldk]
  float* Vs = Ks + BK * ldk;     // [BK][dv]
  float* Ps = Vs + BK * dv;      // [BQ][LDP]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BQ;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / (heads / kv_heads);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  for (int e = tid; e < BQ * dk; e += THREADS) {
    const int r = e / dk, d = e % dk;
    Qs[r * ldk + d] = q0 + r < sq ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  float m[RT], l[RT], acc[RT][DVT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DVT; ++j) acc[i][j] = 0.f;
  }

  // The KV band this q-tile can see (query positions qa0..qa_last);
  // tiles outside it are skipped.
  const int64_t qa0 = q_offset + q0;
  const int64_t qa_last = q_offset + (q0 + BQ < sq ? q0 + BQ : sq) - 1;
  int64_t kv_end = skv;
  if (causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (window > 0 && qa0 - window + 1 > 0) kv_begin = qa0 - window + 1;
  kv_begin -= kv_begin % BK;

  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();   // Q staged; the previous tile's readers are done
    for (int e = tid; e < BK * dk; e += THREADS) {
      const int r = e / dk, d = e % dk;
      Ks[r * ldk + d] = k0 + r < skv ? to_f32(kb[(k0 + r) * ks.s + d]) : 0.f;
    }
    for (int e = tid; e < BK * dv; e += THREADS) {
      const int r = e / dv, d = e % dv;
      Vs[r * dv + d] = k0 + r < skv ? to_f32(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dk; ++d) {
      float a[RT], kk[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = Qs[(ty * RT + i) * ldk + d];
#pragma unroll
      for (int j = 0; j < CT; ++j) kk[j] = Ks[(tx + 16 * j) * ldk + d];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int64_t qp = qa0 + ty * RT + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const bool ok = kept(qp, k0 + tx + 16 * j, skv, causal, window);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const bool ok = kept(qp, k0 + tx + 16 * j, skv, causal, window);
        const float p = ok ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty * RT + i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DVT; ++j) acc[i][j] *= corr;
    }
    __syncwarp();   // a row's P is written and read by one half-warp

    const int c_end = kv_end - k0 < BK ? static_cast<int>(kv_end - k0) : BK;
    for (int c = 0; c < c_end; ++c) {
      float vv[DVT];
#pragma unroll
      for (int j = 0; j < DVT; ++j) {
        const int col = tx + 16 * j;
        vv[j] = col < dv ? Vs[c * dv + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const float p = Ps[(ty * RT + i) * LDP + c];
#pragma unroll
        for (int j = 0; j < DVT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int64_t qp = q0 + ty * RT + i;
    if (qp >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    if (lse != nullptr && tx == 0)
      lse[(b * heads + h) * sq + qp] = l[i] > 0.f ? m[i] + logf(l[i])
                                                  : NEG_INF;
#pragma unroll
    for (int j = 0; j < DVT; ++j) {
      const int col = tx + 16 * j;
      if (col < dv) ob[qp * os.s + col] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DVT>
int launch_dvt(const void* q, const void* k, const void* v, void* o,
               float* lse, int64_t batch, int64_t sq, int64_t skv,
               int64_t heads, int64_t kv_heads, int dk, int dv, Strides qs,
               Strides ks, Strides vs, Strides os, int causal,
               int64_t window, int64_t q_offset, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(BQ + BK) * (dk + 1) + BK * dv + BQ * (BK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DVT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((sq + BQ - 1) / BQ),
                  static_cast<unsigned>(heads),
                  static_cast<unsigned>(batch));
  flash_fwd_kernel<T, DVT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, heads,
      kv_heads, dk, dv, qs, ks, vs, os, causal, window, q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int64_t batch, int64_t sq, int64_t skv, int64_t heads,
           int64_t kv_heads, int64_t dk, int64_t dv, const int64_t* st,
           int64_t causal, int64_t window, float scale, int64_t q_offset,
           void* stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  auto s = static_cast<cudaStream_t>(stream);
  const int c = static_cast<int>(causal);
  const int ik = static_cast<int>(dk), iv = static_cast<int>(dv);
  float* l = static_cast<float*>(lse);
  if (dv <= 64)
    return launch_dvt<T, 4>(q, k, v, o, l, batch, sq, skv, heads, kv_heads,
                            ik, iv, qs, ks, vs, os, c, window, q_offset,
                            scale, s);
  if (dv <= 128)
    return launch_dvt<T, 8>(q, k, v, o, l, batch, sq, skv, heads, kv_heads,
                            ik, iv, qs, ks, vs, os, c, window, q_offset,
                            scale, s);
  return launch_dvt<T, 16>(q, k, v, o, l, batch, sq, skv, heads, kv_heads,
                           ik, iv, qs, ks, vs, os, c, window, q_offset,
                           scale, s);
}

}  // namespace

// Plain C entry points for ctypes.  q (B, Sq, H, Dk), k (B, Skv, KH, Dk),
// v (B, Skv, KH, Dv), o (B, Sq, H, Dv), each with unit stride on its last
// dim; lse (B, H, Sq) f32, contiguous, or null (not written); `strides`
// holds 12 element strides: (batch, seq, head) of q, k, v, o in that
// order; q_offset >= 0 is the position of query row 0.  The caller checks
// 1 <= Dk, Dv <= 256 and H % KH == 0.  The launch is queued on `stream`
// and not synchronised; the return value is cudaGetLastError().
extern "C" int poas_flash_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int64_t batch, int64_t sq,
                              int64_t skv, int64_t heads, int64_t kv_heads,
                              int64_t dk, int64_t dv, const int64_t* strides,
                              int64_t causal, int64_t window, float scale,
                              int64_t q_offset, void* stream) {
  return launch<float>(q, k, v, o, lse, batch, sq, skv, heads, kv_heads, dk,
                       dv, strides, causal, window, scale, q_offset, stream);
}

extern "C" int poas_flash_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, int64_t batch, int64_t sq,
                               int64_t skv, int64_t heads, int64_t kv_heads,
                               int64_t dk, int64_t dv, const int64_t* strides,
                               int64_t causal, int64_t window, float scale,
                               int64_t q_offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, lse, batch, sq, skv, heads,
                               kv_heads, dk, dv, strides, causal, window,
                               scale, q_offset, stream);
}
