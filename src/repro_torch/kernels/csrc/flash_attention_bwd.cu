// K2 backward: the gradient (dQ, dK, dV) of causal / sliding-window GQA
// flash attention, hand-written for Hopper (sm_90a), f32 arithmetic on the
// CUDA cores, reading float32 or bf16.
//
// Replaces the gradient of src/repro/models/layers.py:90 (flash_attention,
// the model stack's attention), which the reference takes with
// jax.value_and_grad (src/repro/training/step.py:30); the Pallas kernel
// src/repro/kernels/flash_attention.py:70 has no backward.  Inputs: q
// (B, Sq, H, Dk), k (B, Skv, KH, Dk), v (B, Skv, KH, Dv), the forward's
// output o and its gradient dO (B, Sq, H, Dv), and each row's log-sum-exp
// of its scaled scores, lse (B, H, Sq) f32, written by the forward kernels.
// Masks as the forward: causal (q_pos >= k_pos), window (k_pos > q_pos -
// window, 0 = full), padding (k_pos < Skv), query row i at position
// q_offset + i; query head h reads KV head h // (H / KH).  Outputs dq,
// dk, dv in f32, contiguous; the wrapper rounds them to the inputs' dtypes.
//
//   P = exp(S * scale - lse) on kept pairs, dV = P^T dO, dP = dO V^T,
//   D = rowsum(dO o O), dS = P o (dP - D), dQ = scale dS K, dK = scale dS^T Q
//
// Route: the wrapper sends bf16 here at head dims that are not multiples
// of 16 (bf16 at multiples of 16 runs in flash_attention_bwd_sm90.cu,
// float32 as 3xTF32 in flash_attention_bwd_tf32x3.cu).  Its float32 entry,
// the first design of the float32 route, is reached only by a caller that
// names the route "simt" (the wrapper's _launch_bwd), to time it beside
// flash_attention_bwd_tf32x3.cu.
//
// What bounds it on this card: at hymba-1.5B's training shape (4 x 2048
// tokens, 25 / 5 heads of 64, window 1024) the five products over the
// band's pairs are ~2 * pairs * (3 Dk + 2 Dv) operations against a few
// bytes per pair: operation bound, by the 67 TFLOP/s f32 CUDA-core rate of
// this route (989 TFLOP/s were it on the bf16 tensor cores).
//
// What the design does about it (a first, simple kernel: right before
// fast):
//  * Deterministic, no atomics.  A pre-pass writes D.  Kernel A has one
//    block per (64-key tile, KV head, batch): it walks the H/KH query heads
//    of its KV head and the 64-query tiles of the band, and keeps dK and dV
//    of its keys in registers, so the sum over the group is in-block.
//    Kernel B has one block per (64-query tile, head, batch): it walks the
//    key tiles of the band and keeps dQ in registers.  B recomputes S and
//    dP, so the pair does seven products where five would do; that buys
//    the absence of atomics.
//  * Tiles outside the causal/window band are skipped (exact); masked
//    pairs are dropped by a select (p = 0), so exp is taken only of kept
//    scores.
//  * Head dims are staged in chunks of 64 columns as f32 (odd row pitch,
//    conflict-free), so shared memory does not grow with Dk, Dv: any
//    Dk, Dv <= 256; the number of chunks is a template (1-4) so the
//    accumulators stay in registers.  Each thread computes a 4 x 4
//    micro-tile of scores; strided (B, S, H, D) reads as the forward.
//  * Later work: S, dP, dV, dK, dQ on wgmma (bf16), a K/V ring, one pass
//    with dQ by atomics or a split reduction (FA2/FA3's shape).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;           // rows and columns of a score tile
constexpr int DC = 64;           // head-dim columns staged at a time
constexpr int THREADS = 256;
constexpr int RT = 4;            // tile rows per thread: BT / (THREADS / 16)
constexpr int CT = 4;            // tile columns per thread: BT / 16
constexpr int LD = DC + 1;       // odd pitches: conflict-free reads
constexpr int LDP = BT + 1;
// Dynamic shared memory of a block of kernel A or B: 50,432 bytes whatever
// Dk and Dv (they are staged in chunks).
constexpr size_t SMEM = sizeof(float) * (2 * BT * LD + BT * LDP + 2 * BT);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Query row qp (from 0) sits at position q_offset + qp.
__device__ __forceinline__ bool kept(int64_t qp, int64_t kp, const Shape& sh) {
  const int64_t qa = sh.q_offset + qp;
  return qp < sh.sq && kp < sh.skv && (!sh.causal || kp <= qa) &&
         (sh.window <= 0 || kp > qa - sh.window);
}

// Rows [r0, r0 + 64) and columns [c0, c0 + 64) of one (batch, head) slice
// of a strided tensor into dst [64][LD] as f32; zero outside.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int64_t r0,
                                      int64_t limit, int64_t stride, int c0,
                                      int d, int tid) {
  for (int e = tid; e < BT * DC; e += THREADS) {
    const int r = e / DC, c = e % DC;
    const int64_t row = r0 + r;
    const int col = c0 + c;
    dst[r * LD + c] = row < limit && col < d
        ? to_f32(src[row * stride + col]) : 0.f;
  }
}

// acc[i][j] += sum_c X[row_i][c] * Y[col_j][c] over one staged chunk:
// rows ty*RT + i, columns tx + 16 j.
__device__ __forceinline__ void tile_dot(float (&acc)[RT][CT],
                                         const float* X, const float* Y,
                                         int tx, int ty) {
#pragma unroll 4
  for (int c = 0; c < DC; ++c) {
    float a[RT], b[CT];
#pragma unroll
    for (int i = 0; i < RT; ++i) a[i] = X[(ty * RT + i) * LD + c];
#pragma unroll
    for (int j = 0; j < CT; ++j) b[j] = Y[(tx + 16 * j) * LD + c];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][jj] += sum_r P[row_i][r] * Y[r][tx + 16 jj]: a P tile (this
// half-warp's rows) times a staged chunk.
__device__ __forceinline__ void tile_acc(float (&acc)[RT][CT],
                                         const float* P, const float* Y,
                                         int tx, int ty) {
#pragma unroll 4
  for (int r = 0; r < BT; ++r) {
    float y[CT];
#pragma unroll
    for (int j = 0; j < CT; ++j) y[j] = Y[r * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float p = P[(ty * RT + i) * LDP + r];
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(p, y[j], acc[i][j]);
    }
  }
}

// D[b, h, q] = sum_d dO[b, q, h, d] * O[b, q, h, d]: one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ D, int64_t rows, Shape sh,
                     Strides os, Strides dos) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (THREADS / 32) +
                      threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int64_t h = row % sh.heads;
  const int64_t q = (row / sh.heads) % sh.sq;
  const int64_t b = row / (sh.heads * sh.sq);
  const T* ob = o + b * os.b + q * os.s + h * os.h;
  const T* db = dout + b * dos.b + q * dos.s + h * dos.h;
  float acc = 0.f;
  for (int d = lane; d < sh.dv; d += 32)
    acc = fmaf(to_f32(ob[d]), to_f32(db[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) D[(b * sh.heads + h) * sh.sq + q] = acc;
}

// Kernel A: dK and dV of one 64-key tile of one KV head.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ D, float* __restrict__ dk,
                      float* __restrict__ dv, Shape sh, Strides qs,
                      Strides ks, Strides vs, Strides dos) {
  extern __shared__ float smem[];
  float* Xs = smem;              // [BT][LD]: a chunk of K or V (key rows)
  float* Ys = Xs + BT * LD;      // [BT][LD]: a chunk of Q or dO (query rows)
  float* Ps = Ys + BT * LD;      // [BT][LDP]: P^T, then dS^T
  float* Ls = Ps + BT * LDP;     // [BT]: lse of the query tile
  float* Ds = Ls + BT;           // [BT]: D of the query tile

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t kh = blockIdx.y, b = blockIdx.z;
  const int64_t group = sh.heads / sh.kv_heads;
  const int nkc = (sh.dk + DC - 1) / DC, nvc = (sh.dv + DC - 1) / DC;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;

  float acc_k[NC][RT][CT], acc_v[NC][RT][CT];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc_k[c][i][j] = acc_v[c][i][j] = 0.f;

  // The query rows of this key tile's band (row i at position q_offset +
  // i); tiles outside it are skipped.
  const int64_t k_last = (k0 + BT < sh.skv ? k0 + BT : sh.skv) - 1;
  int64_t q_begin = sh.causal && k0 > sh.q_offset ? k0 - sh.q_offset : 0;
  q_begin -= q_begin % BT;
  int64_t q_end = sh.sq;
  if (sh.window > 0 && k_last + sh.window - sh.q_offset < q_end)
    q_end = k_last + sh.window - sh.q_offset;

  for (int64_t g = 0; g < group; ++g) {
    const int64_t h = kh * group + g;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* db = dout + b * dos.b + h * dos.h;
    const float* lb = lse + (b * sh.heads + h) * sh.sq;
    const float* Db = D + (b * sh.heads + h) * sh.sq;
    for (int64_t q0 = q_begin; q0 < q_end; q0 += BT) {
      // S^T = K Q^T
      float s[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) s[i][j] = 0.f;
      for (int c = 0; c < nkc; ++c) {
        __syncthreads();   // the previous readers of Xs, Ys, Ls, Ds are done
        stage(Xs, kb, k0, sh.skv, ks.s, c * DC, sh.dk, tid);
        stage(Ys, qb, q0, sh.sq, qs.s, c * DC, sh.dk, tid);
        if (c == 0 && tid < BT) {
          const bool in = q0 + tid < sh.sq;
          Ls[tid] = in ? lb[q0 + tid] : 0.f;
          Ds[tid] = in ? Db[q0 + tid] : 0.f;
        }
        __syncthreads();
        tile_dot(s, Xs, Ys, tx, ty);
      }
      // P^T on kept pairs, into Ps for dV = P^T dO.
      float p[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int64_t kp = k0 + ty * RT + i, qp = q0 + tx + 16 * j;
          p[i][j] = kept(qp, kp, sh)
              ? expf(s[i][j] * sh.scale - Ls[tx + 16 * j]) : 0.f;
          Ps[(ty * RT + i) * LDP + tx + 16 * j] = p[i][j];
        }
      __syncwarp();   // a row of Ps is written and read by one half-warp
      // dP^T = V dO^T; dV += P^T dO
      float dp[RT][CT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) dp[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nvc) {
          __syncthreads();
          stage(Xs, vb, k0, sh.skv, vs.s, c * DC, sh.dv, tid);
          stage(Ys, db, q0, sh.sq, dos.s, c * DC, sh.dv, tid);
          __syncthreads();
          tile_dot(dp, Xs, Ys, tx, ty);
          tile_acc(acc_v[c], Ps, Ys, tx, ty);
        }
      }
      // dS^T = P^T o (dP^T - D), into Ps for dK = dS^T Q.
      __syncwarp();   // this half-warp's reads of P^T are done
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j)
          Ps[(ty * RT + i) * LDP + tx + 16 * j] =
              p[i][j] * (dp[i][j] - Ds[tx + 16 * j]);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (c < nkc) {
          __syncthreads();
          stage(Ys, qb, q0, sh.sq, qs.s, c * DC, sh.dk, tid);
          __syncthreads();
          tile_acc(acc_k[c], Ps, Ys, tx, ty);
        }
      }
    }
  }

  // Every key row of the tile is written, zero where no query sees it.
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int64_t kp = k0 + ty * RT + i;
    if (kp >= sh.skv) continue;
    float* dkr = dk + ((b * sh.skv + kp) * sh.kv_heads + kh) * sh.dk;
    float* dvr = dv + ((b * sh.skv + kp) * sh.kv_heads + kh) * sh.dv;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = c * DC + tx + 16 * j;
        if (col < sh.dk) dkr[col] = sh.scale * acc_k[c][i][j];
        if (col < sh.dv) dvr[col] = acc_v[c][i][j];
      }
  }
}

// Kernel B: dQ of one 64-query tile of one head.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dq,
                    Shape sh, Strides qs, Strides ks, Strides vs,
                    Strides dos) {
  extern __shared__ float smem[];
  float* Xs = smem;              // [BT][LD]: a chunk of Q or dO (query rows)
  float* Ys = Xs + BT * LD;      // [BT][LD]: a chunk of K or V (key rows)
  float* Ps = Ys + BT * LD;      // [BT][LDP]: dS
  float* Ls = Ps + BT * LDP;
  float* Ds = Ls + BT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * BT;
  const int64_t h = blockIdx.y, b = blockIdx.z;
  const int64_t kh = h / (sh.heads / sh.kv_heads);
  const int nkc = (sh.dk + DC - 1) / DC, nvc = (sh.dv + DC - 1) / DC;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* db = dout + b * dos.b + h * dos.h;
  const T* kb = k + b * ks.b + kh * ks.h;
  const T* vb = v + b * vs.b + kh * vs.h;
  if (tid < BT) {
    const bool in = q0 + tid < sh.sq;
    Ls[tid] = in ? lse[(b * sh.heads + h) * sh.sq + q0 + tid] : 0.f;
    Ds[tid] = in ? D[(b * sh.heads + h) * sh.sq + q0 + tid] : 0.f;
  }

  float acc[NC][RT][CT];
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) acc[c][i][j] = 0.f;

  // The key band of this query tile (positions qa0..qa_last); tiles
  // outside it are skipped.
  const int64_t qa0 = sh.q_offset + q0;
  const int64_t qa_last = sh.q_offset + (q0 + BT < sh.sq ? q0 + BT : sh.sq) - 1;
  int64_t kv_end = sh.skv;
  if (sh.causal && qa_last + 1 < kv_end) kv_end = qa_last + 1;
  int64_t kv_begin = 0;
  if (sh.window > 0 && qa0 - sh.window + 1 > 0) kv_begin = qa0 - sh.window + 1;
  kv_begin -= kv_begin % BT;

  for (int64_t k0 = kv_begin; k0 < kv_end; k0 += BT) {
    float s[RT][CT], dp[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < nkc; ++c) {      // S = Q K^T
      __syncthreads();
      stage(Xs, qb, q0, sh.sq, qs.s, c * DC, sh.dk, tid);
      stage(Ys, kb, k0, sh.skv, ks.s, c * DC, sh.dk, tid);
      __syncthreads();
      tile_dot(s, Xs, Ys, tx, ty);
    }
    for (int c = 0; c < nvc; ++c) {      // dP = dO V^T
      __syncthreads();
      stage(Xs, db, q0, sh.sq, dos.s, c * DC, sh.dv, tid);
      stage(Ys, vb, k0, sh.skv, vs.s, c * DC, sh.dv, tid);
      __syncthreads();
      tile_dot(dp, Xs, Ys, tx, ty);
    }
    // dS = P o (dP - D), into Ps.
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int64_t qp = q0 + ty * RT + i;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int64_t kp = k0 + tx + 16 * j;
        const float p = kept(qp, kp, sh)
            ? expf(s[i][j] * sh.scale - Ls[ty * RT + i]) : 0.f;
        Ps[(ty * RT + i) * LDP + tx + 16 * j] =
            p * (dp[i][j] - Ds[ty * RT + i]);
      }
    }
    __syncwarp();   // a row of Ps is written and read by one half-warp
#pragma unroll
    for (int c = 0; c < NC; ++c) {       // dQ += dS K
      if (c < nkc) {
        __syncthreads();
        stage(Ys, kb, k0, sh.skv, ks.s, c * DC, sh.dk, tid);
        __syncthreads();
        tile_acc(acc[c], Ps, Ys, tx, ty);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int64_t qp = q0 + ty * RT + i;
    if (qp >= sh.sq) continue;
    float* dqr = dq + ((b * sh.sq + qp) * sh.heads + h) * sh.dk;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int col = c * DC + tx + 16 * j;
        if (col < sh.dk) dqr[col] = sh.scale * acc[c][i][j];
      }
  }
}

template <typename T, int NC>
int launch_nc(const T* q, const T* k, const T* v, const T* o, const T* dout,
              const float* lse, float* dq, float* dk, float* dv, float* D,
              int64_t batch, const Shape& sh, const int64_t* st,
              cudaStream_t stream) {
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]};
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = batch * sh.sq * sh.heads;
  const int per_block = THREADS / 32;
  flash_bwd_dot_kernel<T><<<static_cast<unsigned>(
      (rows + per_block - 1) / per_block), THREADS, 0, stream>>>(
      o, dout, D, rows, sh, os, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_a(static_cast<unsigned>((sh.skv + BT - 1) / BT),
                    static_cast<unsigned>(sh.kv_heads),
                    static_cast<unsigned>(batch));
  flash_bwd_dkdv_kernel<T, NC><<<grid_a, THREADS, SMEM, stream>>>(
      q, k, v, dout, lse, D, dk, dv, sh, qs, ks, vs, dos);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_b(static_cast<unsigned>((sh.sq + BT - 1) / BT),
                    static_cast<unsigned>(sh.heads),
                    static_cast<unsigned>(batch));
  flash_bwd_dq_kernel<T, NC><<<grid_b, THREADS, SMEM, stream>>>(
      q, k, v, dout, lse, D, dq, sh, qs, ks, vs, dos);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* dq, void* dk, void* dv,
           void* D, int64_t batch, int64_t sq, int64_t skv, int64_t heads,
           int64_t kv_heads, int64_t dk_dim, int64_t dv_dim,
           const int64_t* st, int64_t causal, int64_t window, float scale,
           int64_t q_offset, void* stream) {
  if (dk_dim < 1 || dk_dim > 256 || dv_dim < 1 || dv_dim > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const Shape sh{sq, skv, heads, kv_heads, static_cast<int>(dk_dim),
                 static_cast<int>(dv_dim), static_cast<int>(causal), window,
                 scale, q_offset};
  const int64_t wide = dk_dim > dv_dim ? dk_dim : dv_dim;
  auto s = static_cast<cudaStream_t>(stream);
  auto cq = static_cast<const T*>(q);
  auto ck = static_cast<const T*>(k);
  auto cv = static_cast<const T*>(v);
  auto co = static_cast<const T*>(o);
  auto cd = static_cast<const T*>(dout);
  auto cl = static_cast<const float*>(lse);
  auto fq = static_cast<float*>(dq);
  auto fk = static_cast<float*>(dk);
  auto fv = static_cast<float*>(dv);
  auto fD = static_cast<float*>(D);
  switch ((wide + DC - 1) / DC) {
    case 1:
      return launch_nc<T, 1>(cq, ck, cv, co, cd, cl, fq, fk, fv, fD, batch,
                             sh, st, s);
    case 2:
      return launch_nc<T, 2>(cq, ck, cv, co, cd, cl, fq, fk, fv, fD, batch,
                             sh, st, s);
    case 3:
      return launch_nc<T, 3>(cq, ck, cv, co, cd, cl, fq, fk, fv, fD, batch,
                             sh, st, s);
    default:
      return launch_nc<T, 4>(cq, ck, cv, co, cd, cl, fq, fk, fv, fD, batch,
                             sh, st, s);
  }
}

}  // namespace

// Plain C entry points for ctypes.  q (B, Sq, H, Dk), k (B, Skv, KH, Dk),
// v (B, Skv, KH, Dv), o and dout (B, Sq, H, Dv), each with unit stride on
// its last dim; lse (B, H, Sq) f32 contiguous; dq (B, Sq, H, Dk), dk
// (B, Skv, KH, Dk), dv (B, Skv, KH, Dv) f32 contiguous outputs (every
// element written); D (B, H, Sq) f32 scratch.  `strides` holds 15 element
// strides: (batch, seq, head) of q, k, v, o, dout in that order; q_offset
// >= 0 is the position of query row 0.  The caller checks H % KH == 0.
// Three kernels are queued on `stream` and not synchronised; the return
// value is the first launch error, or cudaErrorInvalidValue for head dims
// outside 1..256.
extern "C" int poas_flash_bwd_f32(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* dq, void* dk, void* dv, void* D,
                                  int64_t batch, int64_t sq, int64_t skv,
                                  int64_t heads, int64_t kv_heads,
                                  int64_t dk_dim, int64_t dv_dim,
                                  const int64_t* strides, int64_t causal,
                                  int64_t window, float scale,
                                  int64_t q_offset, void* stream) {
  return launch<float>(q, k, v, o, dout, lse, dq, dk, dv, D, batch, sq, skv,
                       heads, kv_heads, dk_dim, dv_dim, strides, causal,
                       window, scale, q_offset, stream);
}

extern "C" int poas_flash_bwd_bf16(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* dq, void* dk, void* dv, void* D,
                                   int64_t batch, int64_t sq, int64_t skv,
                                   int64_t heads, int64_t kv_heads,
                                   int64_t dk_dim, int64_t dv_dim,
                                   const int64_t* strides, int64_t causal,
                                   int64_t window, float scale,
                                   int64_t q_offset, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dq, dk, dv, D, batch,
                               sq, skv, heads, kv_heads, dk_dim, dv_dim,
                               strides, causal, window, scale, q_offset,
                               stream);
}
