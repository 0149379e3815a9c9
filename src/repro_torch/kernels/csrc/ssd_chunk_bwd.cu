// K3 backward: the gradient of the Mamba-2 SSD intra-chunk part (y and the
// chunk states) with respect to xdt, B, C and cum, hand-written for Hopper
// (sm_90a), f32 arithmetic on the CUDA cores.
//
// Replaces the gradient of the intra-chunk part of
// src/repro/models/ssm.py:67 (ssd_scan), which the reference takes with
// jax.value_and_grad (src/repro/training/step.py:30); the Pallas kernel
// src/repro/kernels/ssd_chunk.py:56 has no backward.  Per (batch, chunk,
// head h, group g = h / (nh / G)), with L[q,t] = exp(cum_q - cum_t) for
// q >= t (else 0), M = (C B^T) o L, w_t = exp(cum_{Q-1} - cum_t), and the
// incoming gradients dy (Q x hp) and dstates (ds x hp):
//
//   dM = (dy xdt^T) o [q >= t]        dxdt = M^T dy + w o (B dstates)
//   dCB = dM o L                      dC_h = dCB B
//   dB_h = dCB^T C + w o (xdt dstates^T)
//   dcum_q += sum_t E[q,t], dcum_t -= sum_q E[q,t]   (E = dM o M)
//   dcum_t -= F_t, F_t = w_t sum_s B[t,s] (xdt dstates^T)[t,s]
//   (and dcum_{Q-1} += sum_t F_t, added by the wrapper)
//
// exp is taken only of kept (q >= t) differences: above the diagonal the
// difference is replaced by -inf before exp, so a decay that leaves f32's
// range (hymba's chunk 256 reaches cum spans of thousands) never becomes an
// inf that meets a zero cotangent.  The reference's gradient is NaN there
// (ROADMAP C3); this one is finite.
//
// What bounds it on this card: at hymba-1.5B's training shape (b 4, 8
// chunks of 256, 50 heads, 1 group, hp 64, ds 16) the products over the
// Q(Q+1)/2 kept pairs are 2 hp a pair per head (dM, dxdt) and 3 ds a pair
// per group (C B^T, dC, dB: dCB sums the group's heads elementwise), with
// the state terms ~15.3 GFLOP, against ~327 MB moved (xdt, dy, dxdt
// dominate): operation bound at the 67 TFLOP/s f32 CUDA-core rate of this
// route (~0.23 ms), bytes bound (~0.098 ms) at 3xTF32's 165 TFLOP/s on the
// tensor cores (the forward's route).  This kernel computes dB and dC per
// head, nh/G times the products the function needs.
//
// What the design does about it (a first, simple kernel: right before
// fast):
//  * Deterministic, no atomics: dB and dC are written per head and summed
//    over the group by the wrapper; dcum is written in two halves (the
//    row sums of E by q, the column sums and F by t) that the wrapper adds.
//  * One launch, two kinds of block per (64-row tile, head, batch-chunk):
//    "column" blocks own a t tile and walk the q tiles at or below the
//    diagonal, accumulating dxdt, dB_h and the t half of dcum in
//    registers, then add the chunk-state terms; "row" blocks own a q tile
//    and walk the t tiles, accumulating dC_h and the q half of dcum.  Both
//    recompute C B^T and dy xdt^T for their pairs (four products where two
//    would do), which buys the absence of cross-block sums.
//  * Each thread holds a 4 x 4 micro-tile of the pair scores, tiles above
//    the diagonal are skipped, and everything is staged in shared memory
//    as f32 with odd row pitches.  Any Q; hp, ds <= 128; grouped B/C.
//  * Later work: the products on the tensor cores (3xTF32 wgmma, as the
//    forward), one block per (chunk, head) sharing the pair scores.
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int BT = 64;           // rows and columns of a pair tile
constexpr int THREADS = 256;
constexpr int RT = 4;            // tile rows per thread
constexpr int CT = 4;            // tile columns per thread
constexpr int LDP = BT + 1;

struct Dims {
  int64_t nc, q, nh, g, hp, ds;
};

// Floats of dynamic shared memory of a block (76,032 bytes at hymba's hp 64,
// ds 16; 166,144 bytes at the largest, hp = ds = 128).
size_t smem_floats(int64_t hp, int64_t ds) {
  return static_cast<size_t>(BT) * (2 * (ds + 1) + 2 * (hp + 1)) +
         2 * BT * LDP + 3 * BT;
}

// 64 positions [r0, r0 + 64) x d columns of a (Q, ..., d) slice whose
// positions are `stride` apart, into dst [64][d + 1]; zero past Q.
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      int64_t r0, int64_t q, int64_t stride,
                                      int d, int tid) {
  for (int e = tid; e < BT * d; e += THREADS) {
    const int r = e / d, c = e % d;
    dst[r * (d + 1) + c] = r0 + r < q ? src[(r0 + r) * stride + c] : 0.f;
  }
}

// The 16 lanes of a half-warp share a row; every lane gets the sum.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// acc[i][j] += sum_c P[row_i][c] * Y[c][tx + 16 j], columns below d.
template <int J>
__device__ __forceinline__ void tile_acc(float (&acc)[RT][J], const float* P,
                                         const float* Y, int d, int tx,
                                         int ty) {
  for (int c = 0; c < BT; ++c) {
    float y[J];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = tx + 16 * j;
      y[j] = col < d ? Y[c * (d + 1) + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float p = P[(ty * RT + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(p, y[j], acc[i][j]);
    }
  }
}

// Blocks [0, nt) are column blocks (t tile x), [nt, 2 nt) row blocks (q tile
// x - nt); blockIdx.y is the head, blockIdx.z the (batch, chunk).
template <int J>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_kernel(const float* __restrict__ xdt, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ cum,
               const float* __restrict__ dy,
               const float* __restrict__ dstates, float* __restrict__ dxdt,
               float* __restrict__ dB, float* __restrict__ dC,
               float* __restrict__ dcum, float* __restrict__ F, Dims dm) {
  extern __shared__ float smem[];
  const int hp = static_cast<int>(dm.hp), ds = static_cast<int>(dm.ds);
  float* R1 = smem;                    // [64][ds+1]: B (column) / C (row)
  float* R2 = R1 + BT * (ds + 1);      // [64][hp+1]: xdt / dy
  float* K1 = R2 + BT * (hp + 1);      // [64][ds+1]: C / B
  float* K2 = K1 + BT * (ds + 1);      // [64][hp+1]: dy / xdt
  float* S1 = K2 + BT * (hp + 1);      // [64][LDP]: dCB (own rows)
  float* S2 = S1 + BT * LDP;           // [64][LDP]: M (column blocks)
  float* cumR = S2 + BT * LDP;         // [64]: cum of the own rows
  float* cumK = cumR + BT;             // [64]: cum of the walked tile
  float* wR = cumK + BT;               // [64]: w of the own rows (column)

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int64_t nt = (dm.q + BT - 1) / BT;
  const bool col_block = blockIdx.x < nt;
  const int64_t tile = col_block ? blockIdx.x : blockIdx.x - nt;
  const int64_t h = blockIdx.y, bn = blockIdx.z;
  const int64_t g = h / (dm.nh / dm.g);
  const int64_t r0 = tile * BT;
  // (batch, chunk) slices, offset to this head / group; positions are
  // `sx` (xdt, dy), `sb` (B, C) and `sc` (cum) elements apart.
  const int64_t sx = dm.nh * dm.hp, sb = dm.g * dm.ds, sc = dm.nh;
  const float* x_bn = xdt + bn * dm.q * sx + h * dm.hp;
  const float* dy_bn = dy + bn * dm.q * sx + h * dm.hp;
  const float* b_bn = Bm + bn * dm.q * sb + g * dm.ds;
  const float* c_bn = Cm + bn * dm.q * sb + g * dm.ds;
  const float* cum_bn = cum + bn * dm.q * sc + h;

  // Own rows: (B, xdt) at t for a column block, (C, dy) at q for a row one.
  stage(R1, col_block ? b_bn : c_bn, r0, dm.q, sb, ds, tid);
  stage(R2, col_block ? x_bn : dy_bn, r0, dm.q, sx, hp, tid);
  if (tid < BT) {
    const bool in = r0 + tid < dm.q;
    cumR[tid] = in ? cum_bn[(r0 + tid) * sc] : 0.f;
    wR[tid] = in ? expf(cum_bn[(dm.q - 1) * sc] - cum_bn[(r0 + tid) * sc])
                 : 0.f;
  }

  float acc1[RT][J], acc2[RT][J], esum[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    esum[i] = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) acc1[i][j] = acc2[i][j] = 0.f;
  }

  // Column block: q tiles tile..nt-1; row block: t tiles 0..tile.
  const int64_t first = col_block ? tile : 0;
  const int64_t last = col_block ? nt - 1 : tile;
  for (int64_t other = first; other <= last; ++other) {
    const int64_t o0 = other * BT;
    __syncthreads();   // the previous tile's readers are done
    stage(K1, col_block ? c_bn : b_bn, o0, dm.q, sb, ds, tid);
    stage(K2, col_block ? dy_bn : x_bn, o0, dm.q, sx, hp, tid);
    if (tid < BT) cumK[tid] = o0 + tid < dm.q ? cum_bn[(o0 + tid) * sc] : 0.f;
    __syncthreads();

    // cb = C B^T and dmt = dy xdt^T at (own row, walked column), as seen
    // from either side (the products are symmetric in the roles).
    float cb[RT][CT], dmt[RT][CT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < CT; ++j) cb[i][j] = dmt[i][j] = 0.f;
    for (int s = 0; s < ds; ++s) {
      float a[RT], b[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = R1[(ty * RT + i) * (ds + 1) + s];
#pragma unroll
      for (int j = 0; j < CT; ++j) b[j] = K1[(tx + 16 * j) * (ds + 1) + s];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) cb[i][j] = fmaf(a[i], b[j], cb[i][j]);
    }
    for (int p = 0; p < hp; ++p) {
      float a[RT], b[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = R2[(ty * RT + i) * (hp + 1) + p];
#pragma unroll
      for (int j = 0; j < CT; ++j) b[j] = K2[(tx + 16 * j) * (hp + 1) + p];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) dmt[i][j] = fmaf(a[i], b[j], dmt[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int64_t rp = r0 + ty * RT + i;
      float e = 0.f;
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        const int64_t cp = o0 + tx + 16 * j;
        const int64_t qp = col_block ? cp : rp, tp = col_block ? rp : cp;
        const float cq = col_block ? cumK[tx + 16 * j] : cumR[ty * RT + i];
        const float ct = col_block ? cumR[ty * RT + i] : cumK[tx + 16 * j];
        // exp of the kept difference only; -inf gives L = 0 elsewhere.
        const float L = expf(qp >= tp && qp < dm.q ? cq - ct : -INFINITY);
        const float M = cb[i][j] * L;
        e += dmt[i][j] * M;
        S1[(ty * RT + i) * LDP + tx + 16 * j] = dmt[i][j] * L;
        if (col_block) S2[(ty * RT + i) * LDP + tx + 16 * j] = M;
      }
      esum[i] += row_sum(e);
    }
    __syncwarp();   // a row of S1 / S2 is written and read by one half-warp
    // Row block: dC_h += dCB B.  Column block: dB_h += dCB^T C and
    // dxdt += M^T dy.
    tile_acc<J>(acc1, S1, K1, ds, tx, ty);
    if (col_block) tile_acc<J>(acc2, S2, K2, hp, tx, ty);
  }

  const int64_t base = bn * dm.q;    // (batch, chunk, position) rows
  if (!col_block) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int64_t qp = r0 + ty * RT + i;
      if (qp >= dm.q) continue;
      float* dcr = dC + ((base + qp) * dm.nh + h) * dm.ds;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int col = tx + 16 * j;
        if (col < ds) dcr[col] = acc1[i][j];
      }
      if (tx == 0) dcum[(base + qp) * dm.nh + h] = esum[i];
    }
    return;
  }

  // Column block: the chunk-state terms, with dstates (ds x hp) read from
  // global memory: dxdt += w o (B dstates); G = w o (xdt dstates^T),
  // dB_h += G; F_t = sum_s B[t,s] G[t,s].
  const float* dst = dstates + (bn * dm.nh + h) * dm.ds * dm.hp;
  float fsum[RT];
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int r = ty * RT + i;
    const float w = wR[r];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int p = tx + 16 * j;
      if (p < hp) {
        float a = 0.f;
        for (int s = 0; s < ds; ++s)
          a = fmaf(R1[r * (ds + 1) + s], dst[s * dm.hp + p], a);
        acc2[i][j] = fmaf(w, a, acc2[i][j]);
      }
    }
    float f = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int s = tx + 16 * j;
      if (s < ds) {
        float a = 0.f;
        for (int p = 0; p < hp; ++p)
          a = fmaf(R2[r * (hp + 1) + p], dst[s * dm.hp + p], a);
        const float gts = w * a;
        acc1[i][j] += gts;
        f = fmaf(R1[r * (ds + 1) + s], gts, f);
      }
    }
    fsum[i] = row_sum(f);
  }
#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int64_t tp = r0 + ty * RT + i;
    if (tp >= dm.q) continue;
    float* dxr = dxdt + ((base + tp) * dm.nh + h) * dm.hp;
    float* dbr = dB + ((base + tp) * dm.nh + h) * dm.ds;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int col = tx + 16 * j;
      if (col < hp) dxr[col] = acc2[i][j];
      if (col < ds) dbr[col] = acc1[i][j];
    }
    if (tx == 0) {
      const int64_t at = (base + tp) * dm.nh + h;
      dcum[static_cast<int64_t>(gridDim.z) * dm.q * dm.nh + at] =
          -esum[i] - fsum[i];
      F[at] = fsum[i];
    }
  }
}

template <int J>
int launch_j(const float* const* in, float* const* out, int64_t batch,
             const Dims& dm, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(dm.hp, dm.ds);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_kernel<J>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t nt = (dm.q + BT - 1) / BT;
  const dim3 grid(static_cast<unsigned>(2 * nt),
                  static_cast<unsigned>(dm.nh),
                  static_cast<unsigned>(batch * dm.nc));
  ssd_bwd_kernel<J><<<grid, THREADS, smem, stream>>>(
      in[0], in[1], in[2], in[3], in[4], in[5], out[0], out[1], out[2],
      out[3], out[4], dm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Every array is float32 and contiguous:
// xdt, dy (b, NC, Q, nh, hp); B, C (b, NC, Q, G, ds); cum (b, NC, Q, nh);
// dstates (b, NC, nh, ds, hp); outputs dxdt (b, NC, Q, nh, hp), dB and dC
// per head (b, NC, Q, nh, ds), dcum (2, b, NC, Q, nh) (the q half, then
// the t half with -F), F (b, NC, Q, nh); every element written.  The
// caller checks nh % G == 0, 1 <= hp, ds <= 128 and b * NC, nh <= 65535.
// The launch is queued on `stream` and not synchronised; the return value
// is cudaGetLastError().
extern "C" int poas_ssd_chunk_bwd_f32(
    const void* xdt, const void* B, const void* C, const void* cum,
    const void* dy, const void* dstates, void* dxdt, void* dB, void* dC,
    void* dcum, void* F, int64_t b, int64_t nc, int64_t q, int64_t nh,
    int64_t g, int64_t hp, int64_t ds, void* stream) {
  const Dims dm{nc, q, nh, g, hp, ds};
  const float* in[6] = {
      static_cast<const float*>(xdt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(cum),
      static_cast<const float*>(dy), static_cast<const float*>(dstates)};
  float* out[5] = {static_cast<float*>(dxdt), static_cast<float*>(dB),
                   static_cast<float*>(dC), static_cast<float*>(dcum),
                   static_cast<float*>(F)};
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t wide = ((hp > ds ? hp : ds) + 15) / 16;
  if (wide <= 1) return launch_j<1>(in, out, b, dm, s);
  if (wide <= 2) return launch_j<2>(in, out, b, dm, s);
  if (wide <= 4) return launch_j<4>(in, out, b, dm, s);
  return launch_j<8>(in, out, b, dm, s);
}
