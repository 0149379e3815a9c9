// K3: the Mamba-2 SSD intra-chunk part, hand-written for Hopper (sm_90a).
//
// Replaces src/repro/kernels/ssd_chunk.py::ssd_chunk_pallas (body
// _ssd_chunk_kernel).  For each (batch, chunk, head), with cum the
// within-chunk cumulative sum of dt*A (falling along the chunk):
//   CB     = C . B^T                                   (Q x Q)
//   L[q,t] = exp(cum_q - cum_t) if q >= t else 0
//   y      = (CB o L) . xdt                            (Q x hp, xdt's dtype)
//   state  = (B o exp(cum_end - cum))^T . xdt          (ds x hp, f32)
// Head h reads B/C group h // (nh / G).  The Pallas kernel holds the whole
// Q x Q score tile in VMEM; at ssm_chunk = 256 an f32 tile is 256 KiB, more
// than the 227 KB of shared memory a block may use here.
//
// What bounds it on this card: per (batch, chunk, head) it reads a Q x hp
// slab of xdt and writes one of y (B and C are shared by nh / G heads) and
// does ~Q^2 (ds + hp) operations on the causal half of the score tile.  At
// hymba-1.5B's shapes (Q 256, hp 64, ds 16) that is ~45 operations per
// byte: bytes bound against the tensor cores' rates, but operation bound on
// the CUDA cores' 67 TFLOP/s f32 that this first kernel uses (the model
// calls it in f32; ssd_scan upcasts).  Mamba2-2.7b's ds = 128 raises the
// ratio further.
//
// What the design does about it:
//  * One block per (head, chunk, batch).  The score tile is cut into 64 x 64
//    tiles and never held whole: for each 64-row tile of q the block walks
//    the t tiles up to the diagonal (tiles above it are skipped), stages
//    B and xdt of that t tile in shared memory, forms the masked decayed
//    scores in a 64 x 64 tile and adds their product with xdt into
//    registers (4 rows x up to 8 columns per thread).
//  * The decay is selected, not multiplied: for q < t, cum_q - cum_t > 0
//    and exp may overflow to inf, and inf * 0 would be NaN.
//  * A second pass over the chunk accumulates the state, each thread owning
//    up to 8 x 8 entries of the (ds x hp) state.
//  * xdt, B, C, cum and y are read and written through their strides (unit
//    stride on the last dim): no transposes.  Any Q fits (ragged last tiles
//    are masked); hp <= 128 and ds <= 128.
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 64;           // score rows per tile
constexpr int TT = 64;           // score columns (t) per tile
constexpr int THREADS = 256;
constexpr int RQ = 4;            // score rows per thread: TQ / (THREADS / 16)
constexpr int CQ = 4;            // score columns per thread: TT / 16

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

struct Strides {   // element strides of (b, NC, Q, heads or groups); last is unit
  int64_t b, c, q, h;
};

struct Dims {
  int q, nh, groups, hp, ds;
};

// HPT: columns of hp per thread (hp <= 16 * HPT); SPT: rows of ds per thread
// in the state pass (ds <= 16 * SPT).
template <typename T, int HPT, int SPT>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const T* __restrict__ xdt, const T* __restrict__ bmat,
                 const T* __restrict__ cmat, const float* __restrict__ cum,
                 T* __restrict__ y, float* __restrict__ states, Dims dm,
                 Strides xs, Strides bs, Strides cs, Strides ms, Strides ys) {
  extern __shared__ float smem[];
  const int Q = dm.q, hp = dm.hp, ds = dm.ds;
  const int ldb = ds + 1;        // odd row pitch: conflict-free B reads
  constexpr int LDM = TT + 1;
  float* cum_s = smem;           // [Q]
  float* Cs = cum_s + Q;         // [TQ][ldb]
  float* Bs = Cs + TQ * ldb;     // [TT][ldb]
  float* Xs = Bs + TT * ldb;     // [TT][hp]
  float* Ms = Xs + TT * hp;      // [TQ][LDM]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int64_t g = h / (dm.nh / dm.groups);
  const T* xb = xdt + b * xs.b + c * xs.c + h * xs.h;
  const T* bb = bmat + b * bs.b + c * bs.c + g * bs.h;
  const T* cb = cmat + b * cs.b + c * cs.c + g * cs.h;
  const float* mb = cum + b * ms.b + c * ms.c + h * ms.h;
  T* yb = y + b * ys.b + c * ys.c + h * ys.h;

  for (int t = tid; t < Q; t += THREADS) cum_s[t] = mb[t * ms.q];

  // Stage rows [t0, t0 + TT) of B (times `weight(t)`) and xdt.
  auto stage_bx = [&](int t0, bool weighted, float cum_end) {
    for (int e = tid; e < TT * ds; e += THREADS) {
      const int r = e / ds, s = e % ds, t = t0 + r;
      float val = 0.f;
      if (t < Q) {
        val = to_f32(bb[t * bs.q + s]);
        if (weighted) val *= expf(cum_end - cum_s[t]);
      }
      Bs[r * ldb + s] = val;
    }
    for (int e = tid; e < TT * hp; e += THREADS) {
      const int r = e / hp, p = e % hp, t = t0 + r;
      Xs[r * hp + p] = t < Q ? to_f32(xb[t * xs.q + p]) : 0.f;
    }
  };

  // ---- y: row tiles of the score matrix, walked up to the diagonal ----
  for (int q0 = 0; q0 < Q; q0 += TQ) {
    __syncthreads();   // cum staged; the previous row tile's readers done
    for (int e = tid; e < TQ * ds; e += THREADS) {
      const int r = e / ds, s = e % ds, qq = q0 + r;
      Cs[r * ldb + s] = qq < Q ? to_f32(cb[qq * cs.q + s]) : 0.f;
    }
    float acc[RQ][HPT];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < HPT; ++j) acc[i][j] = 0.f;

    const int t_end = q0 + TQ < Q ? q0 + TQ : Q;
    for (int t0 = 0; t0 < t_end; t0 += TT) {
      if (t0 > 0) __syncthreads();   // previous t tile's readers done
      stage_bx(t0, false, 0.f);
      __syncthreads();

      float sc[RQ][CQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) sc[i][j] = 0.f;
      for (int s = 0; s < ds; ++s) {
        float a[RQ], bv[CQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = Cs[(ty * RQ + i) * ldb + s];
#pragma unroll
        for (int j = 0; j < CQ; ++j) bv[j] = Bs[(tx + 16 * j) * ldb + s];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) sc[i][j] = fmaf(a[i], bv[j], sc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qq = q0 + ty * RQ + i;
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int t = t0 + tx + 16 * j;
          Ms[(ty * RQ + i) * LDM + tx + 16 * j] =
              (qq < Q && t <= qq) ? sc[i][j] * expf(cum_s[qq] - cum_s[t])
                                  : 0.f;
        }
      }
      __syncwarp();   // a row of Ms is written and read by one half-warp

      const int c_end = t_end - t0 < TT ? t_end - t0 : TT;
      for (int cc = 0; cc < c_end; ++cc) {
        float xv[HPT];
#pragma unroll
        for (int j = 0; j < HPT; ++j) {
          const int p = tx + 16 * j;
          xv[j] = p < hp ? Xs[cc * hp + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i) {
          const float mm = Ms[(ty * RQ + i) * LDM + cc];
#pragma unroll
          for (int j = 0; j < HPT; ++j) acc[i][j] = fmaf(mm, xv[j], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qq = q0 + ty * RQ + i;
      if (qq >= Q) continue;
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int p = tx + 16 * j;
        if (p < hp) yb[qq * ys.q + p] = from_f32<T>(acc[i][j]);
      }
    }
  }

  // ---- chunk state: sum_t (B_t * exp(cum_end - cum_t)) (x) xdt_t ----
  const float cum_end = cum_s[Q - 1];
  float sacc[SPT][HPT];
#pragma unroll
  for (int i = 0; i < SPT; ++i)
#pragma unroll
    for (int j = 0; j < HPT; ++j) sacc[i][j] = 0.f;
  for (int t0 = 0; t0 < Q; t0 += TT) {
    __syncthreads();   // the last readers of Bs / Xs are done
    stage_bx(t0, true, cum_end);
    __syncthreads();
    const int c_end = Q - t0 < TT ? Q - t0 : TT;
    for (int cc = 0; cc < c_end; ++cc) {
      float xv[HPT];
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int p = tx + 16 * j;
        xv[j] = p < hp ? Xs[cc * hp + p] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int s = ty + 16 * i;
        const float bv = s < ds ? Bs[cc * ldb + s] : 0.f;
#pragma unroll
        for (int j = 0; j < HPT; ++j) sacc[i][j] = fmaf(bv, xv[j], sacc[i][j]);
      }
    }
  }
  float* sb = states + ((b * gridDim.y + c) * dm.nh + h) *
                           static_cast<int64_t>(ds) * hp;
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = ty + 16 * i;
    if (s >= ds) continue;
#pragma unroll
    for (int j = 0; j < HPT; ++j) {
      const int p = tx + 16 * j;
      if (p < hp) sb[s * hp + p] = sacc[i][j];
    }
  }
}

template <typename T, int HPT, int SPT>
int launch_t(const void* xdt, const void* bm, const void* cm, const float* cum,
             void* y, float* states, int64_t batch, int64_t nc, Dims dm,
             const Strides* st, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(dm.q) + (TQ + TT) * (dm.ds + 1) + TT * dm.hp +
       TQ * (TT + 1));
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel<T, HPT, SPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(dm.nh), static_cast<unsigned>(nc),
                  static_cast<unsigned>(batch));
  ssd_chunk_kernel<T, HPT, SPT><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(xdt), static_cast<const T*>(bm),
      static_cast<const T*>(cm), cum, static_cast<T*>(y), states, dm, st[0],
      st[1], st[2], st[3], st[4]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HPT>
int launch_hp(const void* xdt, const void* bm, const void* cm,
              const float* cum, void* y, float* states, int64_t batch,
              int64_t nc, Dims dm, const Strides* st, cudaStream_t stream) {
  if (dm.ds <= 16)
    return launch_t<T, HPT, 1>(xdt, bm, cm, cum, y, states, batch, nc, dm, st,
                               stream);
  if (dm.ds <= 32)
    return launch_t<T, HPT, 2>(xdt, bm, cm, cum, y, states, batch, nc, dm, st,
                               stream);
  if (dm.ds <= 64)
    return launch_t<T, HPT, 4>(xdt, bm, cm, cum, y, states, batch, nc, dm, st,
                               stream);
  return launch_t<T, HPT, 8>(xdt, bm, cm, cum, y, states, batch, nc, dm, st,
                             stream);
}

template <typename T>
int launch(const void* xdt, const void* bm, const void* cm, const void* cum,
           void* y, void* states, int64_t batch, int64_t nc, int64_t q,
           int64_t nh, int64_t groups, int64_t hp, int64_t ds,
           const int64_t* strides, void* stream) {
  const Dims dm{static_cast<int>(q), static_cast<int>(nh),
                static_cast<int>(groups), static_cast<int>(hp),
                static_cast<int>(ds)};
  Strides st[5];
  for (int i = 0; i < 5; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
  auto s = static_cast<cudaStream_t>(stream);
  auto cf = static_cast<const float*>(cum);
  auto sf = static_cast<float*>(states);
  if (hp <= 64)
    return launch_hp<T, 4>(xdt, bm, cm, cf, y, sf, batch, nc, dm, st, s);
  return launch_hp<T, 8>(xdt, bm, cm, cf, y, sf, batch, nc, dm, st, s);
}

}  // namespace

// Plain C entry points for ctypes.  xdt and y (b, NC, Q, nh, hp); B and C
// (b, NC, Q, G, ds); cum (b, NC, Q, nh) in f32; states (b, NC, nh, ds, hp)
// f32, contiguous.  Every other tensor has unit stride on its last dim and
// `strides` holds 20 element strides, (b, NC, Q, head-or-group) of xdt, B,
// C, cum and y in that order (cum's head stride is its last).  The caller
// checks 1 <= hp, ds <= 128, nh % G == 0 and that the shared memory fits.
// The launch is queued on `stream` and not synchronised; the return value
// is cudaGetLastError().
extern "C" int poas_ssd_chunk_f32(const void* xdt, const void* bm,
                                  const void* cm, const void* cum, void* y,
                                  void* states, int64_t batch, int64_t nc,
                                  int64_t q, int64_t nh, int64_t groups,
                                  int64_t hp, int64_t ds,
                                  const int64_t* strides, void* stream) {
  return launch<float>(xdt, bm, cm, cum, y, states, batch, nc, q, nh, groups,
                       hp, ds, strides, stream);
}

extern "C" int poas_ssd_chunk_bf16(const void* xdt, const void* bm,
                                   const void* cm, const void* cum, void* y,
                                   void* states, int64_t batch, int64_t nc,
                                   int64_t q, int64_t nh, int64_t groups,
                                   int64_t hp, int64_t ds,
                                   const int64_t* strides, void* stream) {
  return launch<__nv_bfloat16>(xdt, bm, cm, cum, y, states, batch, nc, q, nh,
                               groups, hp, ds, strides, stream);
}
