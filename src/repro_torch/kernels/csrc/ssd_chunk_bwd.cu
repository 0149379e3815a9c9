// K3 backward on Hopper's tensor cores: the gradient of the Mamba-2 SSD
// intra-chunk part (y and the chunk states) with respect to xdt, B, C and
// cum, f32 through 3xTF32 on wgmma, for sm_90a.
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
//   dCB = sum over the group's heads of dM o L
//   dC = dCB B                        dB = dCB^T C + sum_h w o (xdt dstates^T)
//   dcum_q += sum_t E[q,t], dcum_t -= sum_q E[q,t]   (E = dM o M, per head)
//   dcum_t -= F_t, dcum_{Q-1} += sum_t F_t,
//   F_t = w_t sum_s B[t,s] (xdt dstates^T)[t,s]
//
// exp is taken only of kept (q >= t) differences: above the diagonal the
// decay is a select, never computed, so a decay that leaves f32's range
// (hymba's chunk 256 reaches cum spans of thousands) never becomes an inf
// that meets a zero cotangent.  The reference's gradient is NaN there
// (ROADMAP C3); this one is finite.
//
// What bounds it on this card.  At hymba-1.5B's training shape (b 4, 8
// chunks of 256, 50 heads, 1 group, hp 64, ds 16) the kernel reads xdt, B,
// C, cum, dy, dstates and writes dxdt, dB, dC, dcum: ~327 MB, 0.0975 ms at
// 3.35 TB/s.  Its products over the Q(Q+1)/2 kept pairs -- 2 hp a pair per
// head (dM, dxdt), 3 ds a pair per group (C B^T, dC, dB) -- and the state
// terms are 15.2 GFLOP: 0.0924 ms as three TF32 products at 495 TFLOP/s,
// so bytes bound (on the CUDA cores' 67 TFLOP/s, 0.23 ms).
//
// What the design does about it:
//  * Every product on tf32 wgmma through 3xTF32 (csrc/sm90_tf32x3.cuh),
//    which meets K3's 1e-4 float32 gate where one TF32 pass does not:
//    dM^T = xdt dy^T (m64n64k8, both operands K-major as they lie),
//    dxdt += M^T dy (A from registers, dy transposed by the split pass with
//    t permuted to the accumulator's column order, as K3's forward does
//    with xdt), the state terms xdt dstates^T (m64n32k8) and
//    (w o B) dstates (A from registers), C B^T, dC and dB.
//  * C B^T, dC = dCB B and dB = dCB^T C once per group, after dCB has been
//    summed over the group's heads elementwise, in three launches:
//      ssd_bwd_cb: one block per (t tile <= q tile pair, group, batch-chunk)
//        writes C B^T (as B_t C_q^T) once;
//      ssd_bwd_main: one block (two warpgroups) per (64-row t tile, head
//        slice, group, batch-chunk) walks the slice's heads and, per head,
//        the q tiles at or below the diagonal: dM^T, M^T, dxdt (in
//        registers, written once per head), the row sums of E (dcum_t) and
//        the column sums of E (dcum_q, one partial per t tile), the state
//        terms, and dCB^T summed over the slice's heads in shared memory.
//        Warpgroup w takes columns [32w, 32w + 32) of every q tile, so each
//        thread does half the split and elementwise work and an SM holds
//        eight warps; the two halves of dxdt and of E's row sums are added,
//        0 then 1, at the end of each head;
//      ssd_bwd_post: per (64-row tile, group, batch-chunk), dB blocks own a
//        t tile and walk the q tiles, dC blocks own a q tile and walk the t
//        tiles; each adds the slices' dCB partials in a fixed order before
//        its one product, and dC blocks also add dcum's parts.
//    The head slices exist for the grid: hymba has one group, so one block
//    per t tile would fill 128 of 132 SMs with blocks of 1-4 tiles of
//    work; the wrapper cuts the group into as few slices as give two
//    blocks an SM.  Deterministic, no float atomics: every sum has one
//    owner and a fixed order, so two runs give bit-equal gradients.
//  * Per (head, q tile) the raw dy tile lands once (16-byte cp.async,
//    zero-filled past Q) and is split twice, K-major and transposed; xdt's
//    t tile once per head.  Tiles above the diagonal are never loaded.
//  * The raw dy tiles (and their cum) pass through a two-stage ring: tile
//    i+1 loads while tile i is split and multiplied.  A head's first loads
//    (xdt's t tile, its first dy tile, dstates' first 32 rows) go out while
//    the previous head finishes its state terms; B's first 32 columns stay
//    in place from head to head (reloaded only when ds > 32).
//  * Shared memory (one block an SM): at hp 64, Q 256 216,576 bytes --
//    xdt, dy and dy^T split (96 KiB), two raw tiles (32 KiB), dCB^T of the
//    slice (16 KiB a q tile: 64 KiB), cum and the column sums (two stages
//    each), 32 raw rows of dstates and 32 columns of B (16 KiB).  The split
//    dstates pass through the dy buffers, 32 of ds at a time, once per
//    head; the state term's dB is summed over the slice's heads in global
//    memory, by the thread that owns each element.  Hence hp up to ~64 at
//    Q 256 (hp 128 needs 355,840 bytes; the wrapper raises on what does
//    not fit).
//  * Tried at hymba's shape and not kept: one warpgroup a block (four
//    warps an SM wait out every load, barrier and scalar split: slower
//    than two), and the dy ring without the second warpgroup (no faster).
//
// Later work: fewer barriers per q tile, the state phase's products in
// the other warpgroup's idle time, a producer warp with TMA.
#include <cstdint>

#include <cuda_runtime.h>

#include "sm90_tf32x3.cuh"

namespace {

using namespace poas_sm90;

constexpr int TT = 64;            // rows of a t or q tile (one wgmma M)
constexpr int THREADS = 128;      // one warpgroup
constexpr int MAIN_THREADS = 256; // the main kernel's two warpgroups
constexpr int ATOM = 64 * 128;    // 64 rows x 128 bytes (32 f32 of K)
constexpr int TILE = TT * TT;     // floats of a pair tile
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {   // element strides of (b, NC, Q, heads or groups)
  int64_t b, c, q, h;
};

struct Dims {
  int q, nh, groups, hp, ds, nc;
  int hs, slices;   // heads per slice, slices per group
};

__host__ __device__ inline int padded(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 64 ? 64 : 128;
}
__host__ __device__ inline int tiles(int q) { return (q + TT - 1) / TT; }
__host__ __device__ inline int pairs(int nt) { return nt * (nt + 1) / 2; }
// Index of the (t tile j <= q tile i) pair.
__host__ __device__ inline int pair_of(int j, int i) {
  return i * (i + 1) / 2 + j;
}

// Byte offsets of a main block's shared memory, past the 1024-byte
// alignment.  raw, cumq and red are two-stage rings (stage k at + k * the
// size of one).  The state phase's split dstates reuse [y_hi, raw); its
// raw dstates rows and B's 32 columns have their own place, so that they
// load while the previous head is still at work.
struct MainLayout {
  uint32_t xp;                                  // bytes of a raw hp row
  uint32_t x_hi, x_lo, y_hi, y_lo, yt_hi, yt_lo, raw;
  uint32_t sk_hi, sk_lo, st_hi, st_lo, s_raw, s_b;
  uint32_t dcb, cumq, red, bytes;
};

__host__ __device__ inline MainLayout main_layout(int hp, int ds, int q) {
  MainLayout l;
  const uint32_t pk = (hp + 31) / 32;           // 32-deep K atoms over hp
  const uint32_t xk = ATOM * pk;                // 64 rows, K-major over hp
  const uint32_t hpp = padded(hp);
  l.xp = 16 * ((hp + 3) / 4);
  l.x_hi = 0;
  l.x_lo = xk;
  l.y_hi = 2 * xk;
  l.y_lo = 3 * xk;
  l.yt_hi = 4 * xk;                             // hpp rows, K = 64 q
  l.yt_lo = l.yt_hi + hpp * 256;
  l.raw = l.yt_lo + hpp * 256;
  const uint32_t end = l.raw + 2 * TT * l.xp;
  l.sk_hi = l.y_hi;                             // dstates [s][p], 32 rows
  l.sk_lo = l.sk_hi + 4096 * pk;
  l.st_hi = l.sk_lo + 4096 * pk;                // dstates^T [p][s], K = 32
  l.st_lo = l.st_hi + hpp * 128;
  l.dcb = end;
  l.cumq = l.dcb + tiles(q) * 32 * THREADS * 4;
  l.red = l.cumq + 2 * TT * 4;
  l.s_raw = l.red + 2 * 8 * 32 * 4;             // 32 rows of dstates
  l.s_b = l.s_raw + 32 * l.xp;                  // 64 rows x 32 of B
  l.bytes = 1024 + l.s_b + TT * 128;
  return l;
}

__host__ __device__ inline uint32_t cb_bytes(int ds) {
  return 1024 + 4 * ATOM * ((ds + 31) / 32);
}

__host__ __device__ inline uint32_t post_bytes(int ds) {
  const uint32_t dp = 16 * ((ds + 3) / 4);
  const uint32_t tr = (TT * dp + 1023) & ~1023u;
  return 1024 + tr + 2 * padded(ds) * 256;
}

// The accumulator slot (register e of thread tid, stored at
// e * THREADS + tid) of element (row, col) of a 64 x 64 m64n64 tile.
__device__ __forceinline__ int acc_index(int row, int col) {
  const int r16 = row & 15;
  const int lane = 4 * (r16 & 7) + ((col & 7) >> 1);
  const int e = 4 * (col >> 3) + 2 * (r16 >> 3) + (col & 1);
  return e * THREADS + 32 * (row >> 4) + lane;
}

// 2^x on the SFU, denormal results flushed to 0.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// `rows` rows [row0, row0 + rows) of a (limit, d) f32 operand whose rows are
// `stride` elements apart, as they lie, `pitch` bytes a row; zero past d
// and past limit.
template <int NT = THREADS>
__device__ __forceinline__ void load_raw(uint32_t dst, const float* src,
                                         int64_t stride, int64_t limit,
                                         int d, uint32_t pitch, int64_t row0,
                                         int rows, int tid) {
  const int nch = static_cast<int>(pitch / 16);
  for (int e = tid; e < rows * nch; e += NT) {
    const int r = e / nch, c = e - r * nch;
    const int bytes = row0 + r < limit ? chunk_bytes(4 * c, d, 4) : 0;
    cp_async16(dst + r * pitch + c * 16,
               bytes ? src + (row0 + r) * stride + 4 * c : src, bytes);
  }
}

// 64 rows [row0, row0 + 64) of a (Q, ds) operand into a K-major swizzled
// tile (zero-filled past ds and Q), as K3's forward loads B and C.
__device__ __forceinline__ void load_kmajor(uint32_t dst, const float* src,
                                            int64_t stride, int Q, int ds,
                                            int64_t row0, int tid) {
  const int nch = 2 * ((ds + 7) / 8);
  for (int e = tid; e < TT * nch; e += THREADS) {
    const int r = e / nch, c = e - r * nch;
    const int bytes = row0 + r < Q ? chunk_bytes(4 * c, ds, 4) : 0;
    cp_async16(dst + (c >> 3) * ATOM + sw128(r, c & 7),
               bytes ? src + (row0 + r) * stride + 4 * c : src, bytes);
  }
}

// A K-major tile split in place: hi over the raw values, lo beside them.
__device__ __forceinline__ void split_kmajor(uint8_t* hi, uint8_t* lo,
                                             int ds, int tid) {
  const int nch = 2 * ((ds + 7) / 8);
  for (int e = tid; e < TT * nch; e += THREADS) {
    const int r = e / nch, c = e - r * nch;
    const uint32_t off = (c >> 3) * ATOM + sw128(r, c & 7);
    float4 h, l;
    split_tf32(*reinterpret_cast<const float4*>(hi + off), h, l);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// A raw tile (rows x `pitch` bytes) -> hi/lo K-major over its columns: row r
// keeps its place, 16-byte chunk c (columns 4c..4c+3, `nch` of them, zero
// past the pitch) goes to (c / 8) * atom + sw128(r, c % 8).
template <int NT = THREADS>
__device__ __forceinline__ void split_rows(uint8_t* hi, uint8_t* lo,
                                           const uint8_t* raw,
                                           uint32_t pitch, int rows,
                                           uint32_t atom, int nch, int tid) {
  for (int e = tid; e < rows * nch; e += NT) {
    const int r = e / nch, c = e - r * nch;
    const float4 x = c * 16u < pitch
        ? *reinterpret_cast<const float4*>(raw + r * pitch + c * 16)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 h, l;
    split_tf32(x, h, l);
    const uint32_t off = (c >> 3) * atom + sw128(r, c & 7);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

// A raw tile [k][n] (`pitch` bytes a k row, `kext` rows) -> hi/lo [n][k],
// K-major over k, N rows (zero for n >= n_valid).  16-byte chunk cc of row
// n holds k = 4cc .. 4cc+3, or with PERM the order the accumulator's
// columns have as a tf32 A operand: k = 8 (cc / 2) + 2j + cc % 2 for
// j = 0..3 (K3's forward transposes xdt the same way).
template <bool PERM, int NT = THREADS>
__device__ __forceinline__ void split_t(uint8_t* hi, uint8_t* lo,
                                        const uint8_t* raw, uint32_t pitch,
                                        int N, int n_valid, int kext,
                                        int tid) {
  const int pf = static_cast<int>(pitch / 4);
  const float* r = reinterpret_cast<const float*>(raw);
  for (int e = tid; e < N * (kext / 4); e += NT) {
    const int n = e % N, cc = e / N;
    const int k0 = PERM ? 8 * (cc >> 1) + (cc & 1) : 4 * cc;
    const int st = PERM ? 2 : 1;
    const float* col = r + k0 * pf + n;
    const float4 x = n < n_valid
        ? make_float4(col[0], col[st * pf], col[2 * st * pf], col[3 * st * pf])
        : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 h, l;
    split_tf32(x, h, l);
    const uint32_t off = (cc >> 3) * (N * 128) + sw128(n, cc & 7);
    *reinterpret_cast<float4*>(hi + off) = h;
    *reinterpret_cast<float4*>(lo + off) = l;
  }
}

__device__ __forceinline__ void split_frag(float v, uint32_t& hi,
                                           uint32_t& lo) {
  float h, l;
  split_tf32(v, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

// ---- 1. C B^T, once per (pair, group, batch-chunk) ------------------------
// Stored as B_t C_q^T (t rows, q columns) in accumulator order.
__global__ void __launch_bounds__(THREADS)
ssd_bwd_cb(const float* __restrict__ bmat, const float* __restrict__ cmat,
           float* __restrict__ cbs, Dims dm, Strides bs, Strides cs) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw0);
  const uint32_t kt = ATOM * ((dm.ds + 31) / 32);
  const int tid = threadIdx.x;
  const int pair = blockIdx.x;
  int i = 0;
  while (pairs(i + 1) <= pair) ++i;
  const int j = pair - pairs(i);
  const int64_t g = blockIdx.y, bc = blockIdx.z;
  const int64_t b = bc / dm.nc, c = bc % dm.nc;
  load_kmajor(base, bmat + b * bs.b + c * bs.c + g * bs.h, bs.q, dm.q, dm.ds,
              static_cast<int64_t>(j) * TT, tid);
  load_kmajor(base + 2 * kt, cmat + b * cs.b + c * cs.c + g * cs.h, cs.q,
              dm.q, dm.ds, static_cast<int64_t>(i) * TT, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  split_kmajor(sm, sm + kt, dm.ds, tid);
  split_kmajor(sm + 2 * kt, sm + 3 * kt, dm.ds, tid);
  fence_proxy_async();
  __syncthreads();
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  wg_fence();
  for (int kk = 0; kk < (dm.ds + 7) / 8; ++kk)
    tf32x3_ss<64>(s, kmajor_desc(base, kk, ATOM),
                  kmajor_desc(base + kt, kk, ATOM),
                  kmajor_desc(base + 2 * kt, kk, ATOM),
                  kmajor_desc(base + 3 * kt, kk, ATOM), kk > 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(s);
  float* out = cbs + ((bc * dm.groups + g) * pairs(tiles(dm.q)) + pair) *
                         static_cast<int64_t>(TILE);
#pragma unroll
  for (int e = 0; e < 32; ++e) out[e * THREADS + tid] = s[e];
}

// ---- 2. per head: dM, dxdt, dcum's parts, the state terms, dCB ----------
// Two warpgroups: warpgroup w takes columns [32w, 32w + 32) of every q tile
// (its m64n32 accumulator is registers 16w..16w+15 of the m64n64 one, so
// C B^T and dCB^T keep the accumulator order of the cb kernel), and half of
// each state chunk's products.  Their dxdt and row sums are added, 0 then
// 1, at the end of each head.
template <int HPP>
__global__ void __launch_bounds__(MAIN_THREADS, 1)
ssd_bwd_main(const float* __restrict__ xdt, const float* __restrict__ bmat,
             const float* __restrict__ cum, const float* __restrict__ dy,
             const float* __restrict__ dstates,
             const float* __restrict__ cbs, float* __restrict__ dxdt,
             float* __restrict__ dcbp, float* __restrict__ dbsp,
             float* __restrict__ dcq, float* __restrict__ dct,
             float* __restrict__ fsum, Dims dm, Strides xs, Strides bs,
             Strides ms, Strides ys, Strides ss) {
  constexpr int NT = MAIN_THREADS;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw0);
  const int Q = dm.q, hp = dm.hp, ds = dm.ds, nh = dm.nh;
  const int nt = tiles(Q), np = pairs(nt);
  const MainLayout L = main_layout(hp, ds, Q);
  const int j = static_cast<int>(blockIdx.x) / dm.slices;
  const int slice = static_cast<int>(blockIdx.x) % dm.slices;
  const int64_t g = blockIdx.y, bc = blockIdx.z, BC = gridDim.z;
  const int64_t b = bc / dm.nc, c = bc % dm.nc;
  const int hg = nh / dm.groups;
  const int m0 = slice * dm.hs;
  const int m1 = m0 + dm.hs < hg ? m0 + dm.hs : hg;
  const int64_t t0 = static_cast<int64_t>(j) * TT;
  const int tid = threadIdx.x, wg = tid / THREADS, wt = tid % THREADS;
  const int warp = wt / 32, lane = tid % 32, cq = lane % 4;
  const int row_a = warp * 16 + lane / 4;   // and row_a + 8: t of the tile
  float* const dcb = reinterpret_cast<float*>(sm + L.dcb);
  const float* const cumq_ring = reinterpret_cast<const float*>(sm + L.cumq);
  float* const red = reinterpret_cast<float*>(sm + L.red);
  const float* const braw = reinterpret_cast<const float*>(sm + L.s_b);
  for (int e = tid; e < (nt - j) * 32 * THREADS; e += NT) dcb[e] = 0.f;
  const float* const bb = bmat + b * bs.b + c * bs.c + g * bs.h;
  const float* const cb_blk =
      cbs + (bc * dm.groups + g) * np * static_cast<int64_t>(TILE);
  const int hk = (hp + 7) / 8;                  // k8 steps over hp
  const int nch = 2 * hk;                       // 16-byte chunks of them
  const uint32_t atom_s = 4096;                 // 32 rows of dstates
  const int slot0 = 16 * wg * THREADS + wt;     // this thread's first slot

  float acc[HPP / 2], s[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) s[e] = 0.f;

  const int nds = (ds + 31) / 32;               // 32-wide chunks of ds
  // The dy tile i of head m (and its cum) into raw stage st.
  auto load_dy = [&](int64_t hh, int i, int st) {
    const int64_t q0 = static_cast<int64_t>(i) * TT;
    const float* const mb = cum + b * ms.b + c * ms.c + hh * ms.h;
    load_raw<NT>(base + L.raw + st * TT * L.xp,
                 dy + b * ys.b + c * ys.c + hh * ys.h, ys.q, Q, hp, L.xp, q0,
                 TT, tid);
    if (tid < TT) {
      const bool ok = q0 + tid < Q;
      cp_async4(base + L.cumq + (st * TT + tid) * 4,
                ok ? mb + (q0 + tid) * ms.q : mb, ok);
    }
  };
  // 32 of ds, from s0: dstates rows of head hh, and B's columns.
  auto load_dst = [&](int64_t hh, int s0) {
    load_raw<NT>(base + L.s_raw,
                 dstates + b * ss.b + c * ss.c + hh * ss.h + s0 * ss.q, ss.q,
                 ds - s0, hp, L.xp, 0, 32, tid);
  };
  auto load_b = [&](int s0) {
    for (int e = tid; e < TT * 8; e += NT) {
      const int r = e / 8, cc = e % 8;
      const int bytes = t0 + r < Q ? chunk_bytes(s0 + 4 * cc, ds, 4) : 0;
      cp_async16(base + L.s_b + r * 128 + cc * 16,
                 bytes ? bb + (t0 + r) * bs.q + s0 + 4 * cc : bb, bytes);
    }
  };
  // What head hh needs first: xdt's t tile (raw stage 1), the first dy
  // tile (stage 0) and dstates' first 32 rows.  The first head also takes
  // B's first 32 columns; later heads find them in place (or reloaded).
  auto load_head = [&](int64_t hh) {
    load_raw<NT>(base + L.raw + TT * L.xp,
                 xdt + b * xs.b + c * xs.c + hh * xs.h, xs.q, Q, hp, L.xp,
                 t0, TT, tid);
    load_dy(hh, j, 0);
    load_dst(hh, 0);
    cp_async_commit();
  };
  load_b(0);
  load_head(g * hg + m0);

  for (int m = m0; m < m1; ++m) {
    const int64_t h = g * hg + m;
    const float* const mb = cum + b * ms.b + c * ms.c + h * ms.h;
    // This thread's two t rows: cum, w, and running sums.
    const float cend = mb[(Q - 1) * ms.q];
    float ct[2], w[2], erow[2] = {0.f, 0.f}, f[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t t = t0 + row_a + 8 * r;
      ct[r] = t < Q ? mb[t * ms.q] : 0.f;
      w[r] = t < Q ? exp2_ftz((cend - ct[r]) * LOG2E) : 0.f;
    }
    // The head's first loads (issued during the previous head's state
    // phase) have landed; xdt's t tile, K-major over hp.
    cp_async_wait<0>();
    __syncthreads();
    split_rows<NT>(sm + L.x_hi, sm + L.x_lo, sm + L.raw + TT * L.xp, L.xp,
                   TT, ATOM, nch, tid);
#pragma unroll
    for (int e = 0; e < HPP / 2; ++e) acc[e] = 0.f;

    // E's column sums of tile i: red holds, per stage, 8 warps x 32
    // columns; written once the barrier after their writes has passed.
    auto put_dcq = [&](int i) {
      const int64_t q0 = static_cast<int64_t>(i) * TT;
      const float* rd = red + ((i - j) & 1) * 8 * 32 + (tid / 32) * 4 * 32 +
                        tid % 32;
      if (tid < TT && q0 + tid < Q)
        dcq[((j * BC + bc) * Q + q0 + tid) * nh + h] =
            rd[0] + rd[32] + rd[64] + rd[96];
    };
    for (int i = j; i < nt; ++i) {
      const int64_t q0 = static_cast<int64_t>(i) * TT;
      const int st = (i - j) & 1;
      cp_async_wait<0>();
      __syncthreads();   // tile i landed; readers of stage st ^ 1 are done
      if (i + 1 < nt) load_dy(h, i + 1, st ^ 1);
      cp_async_commit();
      if (i > j) put_dcq(i - 1);
      const float* const cbt = cb_blk + pair_of(j, i) * TILE + slot0;
      float cbv[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) cbv[e] = cbt[e * THREADS];
      const uint8_t* const rawi = sm + L.raw + st * TT * L.xp;
      split_rows<NT>(sm + L.y_hi, sm + L.y_lo, rawi, L.xp, TT, ATOM, nch,
                     tid);
      split_t<true, NT>(sm + L.yt_hi, sm + L.yt_lo, rawi, L.xp, HPP, hp, TT,
                        tid);
      fence_proxy_async();
      __syncthreads();

      // dM^T = xdt_t dy_q^T over this warpgroup's 32 q, 3xTF32 over hp.
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
      fence_regs(s);
      wg_fence();
      for (int kk = 0; kk < hk; ++kk)
        tf32x3_ss<32>(s, kmajor_desc(base + L.x_hi, kk, ATOM),
                      kmajor_desc(base + L.x_lo, kk, ATOM),
                      kmajor_desc(base + L.y_hi + 4096 * wg, kk, ATOM),
                      kmajor_desc(base + L.y_lo + 4096 * wg, kk, ATOM),
                      kk > 0);
      wg_commit();
      wg_wait<0>();
      fence_regs(s);

      // Register e: t = t0 + row_a + 8 (e >> 1 & 1), q = q0 + 32 wg +
      // 8 (e >> 2) + 2 cq + (e & 1).  s becomes M^T; dM o L goes into the
      // slice's dCB^T.
      const float* const cumq = cumq_ring + st * TT + 32 * wg;
      float* const dcbi = dcb + (i - j) * 32 * THREADS + slot0;
      float colE[8];
#pragma unroll
      for (int v = 0; v < 8; ++v) colE[v] = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int r = (e >> 1) & 1;
        const int ql = 8 * (e >> 2) + 2 * cq + (e & 1);
        const int64_t tg = t0 + row_a + 8 * r, qg = q0 + 32 * wg + ql;
        const bool keep = qg >= tg && qg < Q;
        const float dec = keep ? exp2_ftz((cumq[ql] - ct[r]) * LOG2E) : 0.f;
        const float dmv = keep ? s[e] : 0.f;
        const float mv = cbv[e] * dec;
        const float ev = dmv * mv;
        erow[r] += ev;
        colE[2 * (e >> 2) + (e & 1)] += ev;
        dcbi[e * THREADS] += dmv * dec;
        s[e] = mv;
      }
      // M^T as tf32 A fragments: register x of step kk is accumulator
      // register 4kk + 2 (x & 1) + (x >> 1) (yt's permuted q order).
      uint32_t mh[4][4], ml[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x)
          split_frag(s[4 * kk + 2 * (x & 1) + (x >> 1)], mh[kk][x],
                     ml[kk][x]);
      // dxdt += M^T dy over this warpgroup's q: k8 steps 4 wg .. 4 wg + 3.
      fence_regs(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tf32x3_rs<HPP>(acc, mh[kk], ml[kk],
                       kmajor_desc(base + L.yt_hi, 4 * wg + kk, HPP * 128),
                       kmajor_desc(base + L.yt_lo, 4 * wg + kk, HPP * 128),
                       1);
      wg_commit();
      // E's column sums over the warp's 16 rows, into stage st of red.
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        colE[v] += __shfl_xor_sync(0xffffffffu, colE[v], 4);
        colE[v] += __shfl_xor_sync(0xffffffffu, colE[v], 8);
        colE[v] += __shfl_xor_sync(0xffffffffu, colE[v], 16);
      }
      if (lane < 4)
#pragma unroll
        for (int v = 0; v < 8; ++v)
          red[(st * 8 + tid / 32) * 32 + 8 * (v >> 1) + 2 * lane + (v & 1)] =
              colE[v];
      wg_wait<0>();
      fence_regs(acc);
    }
    __syncthreads();
    put_dcq(nt - 1);

    // Chunk-state terms, 32 of ds at a time: warpgroup 0 takes G = w o
    // (xdt dstates^T) into the slice's dB and F += B o G, warpgroup 1
    // dxdt += (w o B) dstates.  Once the last chunk's dstates are split,
    // the next head's first loads go out.
    for (int s0 = 0; s0 < ds; s0 += 32) {
      if (s0 > 0) {
        __syncthreads();   // the previous chunk's readers are done
        load_dst(h, s0);
        load_b(s0);
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();
      }
      split_rows<NT>(sm + L.sk_hi, sm + L.sk_lo, sm + L.s_raw, L.xp, 32,
                     atom_s, nch, tid);
      split_t<false, NT>(sm + L.st_hi, sm + L.st_lo, sm + L.s_raw, L.xp, HPP,
                         hp, 32, tid);
      fence_proxy_async();
      __syncthreads();
      if (s0 + 32 >= ds && m + 1 < m1) load_head(h + 1);

      if (wg == 0) {
        float gacc[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) gacc[e] = 0.f;
        fence_regs(gacc);
        wg_fence();
        for (int kk = 0; kk < hk; ++kk)
          tf32x3_ss<32>(gacc, kmajor_desc(base + L.x_hi, kk, ATOM),
                        kmajor_desc(base + L.x_lo, kk, ATOM),
                        kmajor_desc(base + L.sk_hi, kk, atom_s),
                        kmajor_desc(base + L.sk_lo, kk, atom_s), kk > 0);
        wg_commit();
        wg_wait<0>();
        fence_regs(gacc);
        // The slice's state-term dB rows are this thread's own in global
        // memory: the slice's first head writes them, the others add.
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int r = (e >> 1) & 1;
          const int col = 8 * (e >> 2) + 2 * cq + (e & 1);
          const float gv = w[r] * gacc[e];
          f[r] += braw[(row_a + 8 * r) * 32 + col] * gv;
          const int64_t t = t0 + row_a + 8 * r;
          if (t < Q && s0 + col < ds) {
            float* const at = dbsp + (((slice * BC + bc) * Q + t) *
                                      dm.groups + g) * ds + s0 + col;
            *at = m == m0 ? gv : *at + gv;
          }
        }
      } else {
        // (w o B) as tf32 A fragments in natural k order (s = 8kk + cq +
        // 4 (x >> 1)); B is zero past ds.
        uint32_t wh[4][4], wl[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x & 1;
            split_frag(w[r] * braw[(row_a + 8 * r) * 32 + 8 * kk + cq +
                                   4 * (x >> 1)],
                       wh[kk][x], wl[kk][x]);
          }
        fence_regs(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          tf32x3_rs<HPP>(acc, wh[kk], wl[kk],
                         kmajor_desc(base + L.st_hi, kk, HPP * 128),
                         kmajor_desc(base + L.st_lo, kk, HPP * 128), 1);
        wg_commit();
        wg_wait<0>();
        fence_regs(acc);
      }
    }

    // The head's sums: warpgroup 1 hands its dxdt and row sums to
    // warpgroup 0 through the (free) raw ring and red, which adds them.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      erow[r] += __shfl_xor_sync(0xffffffffu, erow[r], 1);
      erow[r] += __shfl_xor_sync(0xffffffffu, erow[r], 2);
      f[r] += __shfl_xor_sync(0xffffffffu, f[r], 1);
      f[r] += __shfl_xor_sync(0xffffffffu, f[r], 2);
    }
    float* const comb = reinterpret_cast<float*>(sm + L.y_hi);
    __syncthreads();   // the state phase's readers are done
    if (wg == 1) {
#pragma unroll
      for (int e = 0; e < HPP / 2; ++e) comb[e * THREADS + wt] = acc[e];
      if (cq == 0) {
        red[row_a] = erow[0];
        red[row_a + 8] = erow[1];
      }
    }
    __syncthreads();
    if (nds > 1 && m + 1 < m1) {   // B's first 32 columns for the next head
      load_b(0);
      cp_async_commit();
    }
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < HPP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int64_t t = t0 + row_a + 8 * (e >> 1);
          const int p = 8 * n + 2 * cq + (e & 1);
          if (t < Q && p < hp)
            dxdt[((bc * Q + t) * nh + h) * hp + p] =
                acc[4 * n + e] + comb[(4 * n + e) * THREADS + wt];
        }
      if (cq == 0)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int64_t t = t0 + row_a + 8 * r;
          if (t >= Q) continue;
          const int64_t at = (bc * Q + t) * nh + h;
          dct[at] = -(erow[r] + red[row_a + 8 * r]) - f[r];
          fsum[at] = f[r];
        }
    }
  }

  // The slice's dCB^T tiles, in accumulator order.
  for (int i = j; i < nt; ++i) {
    float* const out =
        dcbp + (((slice * BC + bc) * dm.groups + g) * np + pair_of(j, i)) *
                   static_cast<int64_t>(TILE);
#pragma unroll 4
    for (int e = 0; e < 16; ++e)
      out[e * THREADS + slot0] =
          dcb[(i - j) * 32 * THREADS + e * THREADS + slot0];
  }
}

// ---- 3. dB, dC once per group; dcum ----------------------------------------
// Blocks [0, nt) own t tile x and walk the q tiles x..nt-1: dB = dCB^T C +
// the slices' state terms.  Blocks [nt, 2 nt) own q tile x - nt and walk
// the t tiles 0..x-nt: dC = dCB B, then dcum of their rows.  dCB is the sum
// of the slices' partials, in slice order.
template <int DSP>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_post(const float* __restrict__ bmat, const float* __restrict__ cmat,
             const float* __restrict__ dcbp, const float* __restrict__ dbsp,
             const float* __restrict__ dcq, const float* __restrict__ dct,
             const float* __restrict__ fsum, float* __restrict__ dB,
             float* __restrict__ dC, float* __restrict__ dcum, Dims dm,
             Strides bs, Strides cs) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw0 = smem_addr(smem_raw);
  const uint32_t base = (raw0 + 1023u) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw0);
  const int Q = dm.q, ds = dm.ds, nh = dm.nh, G = dm.groups;
  const int nt = tiles(Q), np = pairs(nt);
  const uint32_t dp = 16 * ((ds + 3) / 4);
  const uint32_t tr_hi = (TT * dp + 1023) & ~1023u;
  const uint32_t tr_lo = tr_hi + DSP * 256;
  const bool is_db = static_cast<int>(blockIdx.x) < nt;
  const int own = is_db ? static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x) - nt;
  const int64_t g = blockIdx.y, bc = blockIdx.z, BC = gridDim.z;
  const int64_t b = bc / dm.nc, c = bc % dm.nc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cq = lane % 4;
  const int row_a = warp * 16 + lane / 4;
  const float* const walked = is_db
      ? cmat + b * cs.b + c * cs.c + g * cs.h
      : bmat + b * bs.b + c * bs.c + g * bs.h;
  const int64_t wstride = is_db ? cs.q : bs.q;
  const int first = is_db ? own : 0, last = is_db ? nt - 1 : own;
  const int64_t slice_step = BC * G * np * static_cast<int64_t>(TILE);
  const float* const dcb0 =
      dcbp + (bc * G + g) * np * static_cast<int64_t>(TILE);

  float acc[DSP / 2];
#pragma unroll
  for (int e = 0; e < DSP / 2; ++e) acc[e] = 0.f;
  for (int x = first; x <= last; ++x) {
    __syncthreads();   // the previous tile's readers are done
    load_raw(base, walked, wstride, Q, ds, dp, static_cast<int64_t>(x) * TT,
             TT, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    split_t<false>(sm + tr_hi, sm + tr_lo, sm, dp, DSP, ds, TT, tid);
    fence_proxy_async();
    __syncthreads();
    // A: dCB^T (t rows, q k) for dB, dCB (q rows, t k) for dC; natural k.
    const float* const tile =
        dcb0 + (is_db ? pair_of(own, x) : pair_of(x, own)) *
                   static_cast<int64_t>(TILE);
    // Element (kk, xx): row row_a + 8 (xx & 1), k = 8kk + cq + 4 (xx >> 1).
    float v[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) v[e] = 0.f;
    for (int sl = 0; sl < dm.slices; ++sl) {
      const float* const part = tile + sl * slice_step;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int rl = row_a + 8 * (e & 1);
        const int kl = 8 * (e >> 2) + cq + 4 * ((e >> 1) & 1);
        v[e] += part[is_db ? acc_index(rl, kl) : acc_index(kl, rl)];
      }
    }
    uint32_t ah[8][4], al[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int xx = 0; xx < 4; ++xx)
        split_frag(v[4 * kk + xx], ah[kk][xx], al[kk][xx]);
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      tf32x3_rs<DSP>(acc, ah[kk], al[kk],
                     kmajor_desc(base + tr_hi, kk, DSP * 128),
                     kmajor_desc(base + tr_lo, kk, DSP * 128), 1);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
  }

  const int64_t r0 = static_cast<int64_t>(own) * TT;
#pragma unroll
  for (int n = 0; n < DSP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t p = r0 + row_a + 8 * (e >> 1);
      const int s = 8 * n + 2 * cq + (e & 1);
      if (p >= Q || s >= ds) continue;
      const int64_t at = ((bc * Q + p) * G + g) * ds + s;
      if (is_db) {
        float v = acc[4 * n + e];
        for (int sl = 0; sl < dm.slices; ++sl)
          v += dbsp[sl * BC * Q * G * static_cast<int64_t>(ds) + at];
        dB[at] = v;
      } else {
        dC[at] = acc[4 * n + e];
      }
    }
  if (is_db) return;
  // dcum of this q tile's rows for the group's heads: the t part, the q
  // parts of t tiles 0..own, and at q = Q-1 the sum of F.
  const int hg = nh / G;
  for (int e = tid; e < TT * hg; e += THREADS) {
    const int64_t q = r0 + e / hg;
    const int64_t h = g * hg + e % hg;
    if (q >= Q) continue;
    const int64_t at = (bc * Q + q) * nh + h;
    float v = dct[at];
    for (int jj = 0; jj <= own; ++jj) v += dcq[((jj * BC + bc) * Q + q) * nh + h];
    if (q == Q - 1)
      for (int64_t t = 0; t < Q; ++t) v += fsum[(bc * Q + t) * nh + h];
    dcum[at] = v;
  }
}

// Floats of the scratch buffer and its parts: C B^T tiles, the slices' dCB
// partials, the slices' state-term dB, dcum's q parts per t tile, its t
// part, F.
struct Scratch {
  int64_t cb, dcb, dbs, dcq, dct, f, total;
};
Scratch scratch(int64_t bc, const Dims& dm) {
  const int nt = tiles(dm.q);
  const int64_t pt = bc * dm.groups * pairs(nt) * static_cast<int64_t>(TILE);
  const int64_t rows = bc * dm.q;
  Scratch s;
  s.cb = 0;
  s.dcb = pt;
  s.dbs = s.dcb + dm.slices * pt;
  s.dcq = s.dbs + dm.slices * rows * dm.groups * dm.ds;
  s.dct = s.dcq + nt * rows * dm.nh;
  s.f = s.dct + rows * dm.nh;
  s.total = s.f + rows * dm.nh;
  return s;
}

template <int HPP, int DSP>
int launch(const float* const* in, float* const* out, float* scr,
           int64_t bc, const Dims& dm, const Strides* st,
           cudaStream_t stream) {
  const uint32_t mb = main_layout(dm.hp, dm.ds, dm.q).bytes;
  const uint32_t cbb = cb_bytes(dm.ds), pb = post_bytes(dm.ds);
  if (mb > static_cast<uint32_t>(kSmemLimit) ||
      cbb > static_cast<uint32_t>(kSmemLimit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cb, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(cbb));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_main<HPP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(mb));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_post<DSP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pb));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Scratch s = scratch(bc, dm);
  const int nt = tiles(dm.q);
  const unsigned gy = static_cast<unsigned>(dm.groups);
  const unsigned gz = static_cast<unsigned>(bc);
  // in: xdt, B, C, cum, dy, dstates; out: dxdt, dB, dC, dcum.
  ssd_bwd_cb<<<dim3(pairs(nt), gy, gz), THREADS, cbb, stream>>>(
      in[1], in[2], scr + s.cb, dm, st[1], st[2]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_main<HPP><<<dim3(nt * dm.slices, gy, gz), MAIN_THREADS, mb,
                      stream>>>(
      in[0], in[1], in[3], in[4], in[5], scr + s.cb, out[0], scr + s.dcb,
      scr + s.dbs, scr + s.dcq, scr + s.dct, scr + s.f, dm, st[0], st[1],
      st[3], st[4], st[5]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_post<DSP><<<dim3(2 * nt, gy, gz), THREADS, pb, stream>>>(
      in[1], in[2], scr + s.dcb, scr + s.dbs, scr + s.dcq, scr + s.dct,
      scr + s.f, out[1], out[2], out[3], dm, st[1], st[2]);
  return static_cast<int>(cudaGetLastError());
}

template <int HPP>
int launch_hp(const float* const* in, float* const* out, float* scr,
              int64_t bc, const Dims& dm, const Strides* st,
              cudaStream_t stream) {
  switch (padded(dm.ds)) {
    case 16: return launch<HPP, 16>(in, out, scr, bc, dm, st, stream);
    case 32: return launch<HPP, 32>(in, out, scr, bc, dm, st, stream);
    case 64: return launch<HPP, 64>(in, out, scr, bc, dm, st, stream);
    default: return launch<HPP, 128>(in, out, scr, bc, dm, st, stream);
  }
}

bool rows16(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 4 == 0 &&
         s.c % 4 == 0 && s.q % 4 == 0 && s.h % 4 == 0;
}

Dims dims_of(int64_t nc, int64_t q, int64_t nh, int64_t g, int64_t hp,
             int64_t ds, int64_t hs) {
  const int hg = static_cast<int>(nh / g);
  const int h = static_cast<int>(hs);
  return Dims{static_cast<int>(q),  static_cast<int>(nh),
              static_cast<int>(g),  static_cast<int>(hp),
              static_cast<int>(ds), static_cast<int>(nc),
              h,                    (hg + h - 1) / h};
}

}  // namespace

// Bytes of dynamic shared memory the main kernel (the largest of the three)
// requests at chunk length q and dims hp, ds.
extern "C" int poas_ssd_chunk_bwd_smem(int64_t q, int64_t hp, int64_t ds) {
  return static_cast<int>(main_layout(static_cast<int>(hp),
                                      static_cast<int>(ds),
                                      static_cast<int>(q)).bytes);
}

// Floats of scratch a launch needs (the wrapper allocates it), or -1 past
// 2^31 - 1.
extern "C" int poas_ssd_chunk_bwd_scratch(int64_t b, int64_t nc, int64_t q,
                                          int64_t nh, int64_t g, int64_t hp,
                                          int64_t ds, int64_t hs) {
  const int64_t n = scratch(b * nc, dims_of(nc, q, nh, g, hp, ds, hs)).total;
  return n < 2147483648LL ? static_cast<int>(n) : -1;
}

// Plain C entry point for ctypes.  xdt, dy (b, NC, Q, nh, hp); B, C
// (b, NC, Q, G, ds); cum (b, NC, Q, nh); dstates (b, NC, nh, ds, hp); all
// f32 with unit stride on the last dim, rows of xdt, dy, B, C, dstates on
// 16 bytes; `strides` holds 24 element strides, (b, NC, Q-or-ds,
// head-or-group) of xdt, B, C, cum, dy and dstates in that order (cum's
// head stride is its last; dstates' third is its ds row).  Outputs dxdt
// (b, NC, Q, nh, hp), dB, dC (b, NC, Q, G, ds), dcum (b, NC, Q, nh), f32
// contiguous, every element written; `scratch` holds
// poas_ssd_chunk_bwd_scratch(...) floats.  `hs` heads per slice (1..nh/G).
// The caller checks nh % G == 0, 1 <= hp, ds <= 128 and the grid.  Three
// kernels are queued on `stream` and not synchronised; the return value is
// the first launch error, or cudaErrorInvalidValue (nothing launched) for
// unaligned rows or dims whose shared memory exceeds a block's.
extern "C" int poas_ssd_chunk_bwd_f32(
    const void* xdt, const void* B, const void* C, const void* cum,
    const void* dy, const void* dstates, void* dxdt, void* dB, void* dC,
    void* dcum, void* scratch_buf, int64_t b, int64_t nc, int64_t q,
    int64_t nh, int64_t g, int64_t hp, int64_t ds, int64_t hs,
    const int64_t* strides, void* stream) {
  Strides st[6];
  for (int i = 0; i < 6; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
  if (!rows16(xdt, st[0]) || !rows16(B, st[1]) || !rows16(C, st[2]) ||
      !rows16(dy, st[4]) || !rows16(dstates, st[5]) || hs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims dm = dims_of(nc, q, nh, g, hp, ds, hs);
  const float* in[6] = {
      static_cast<const float*>(xdt), static_cast<const float*>(B),
      static_cast<const float*>(C), static_cast<const float*>(cum),
      static_cast<const float*>(dy), static_cast<const float*>(dstates)};
  float* out[4] = {static_cast<float*>(dxdt), static_cast<float*>(dB),
                   static_cast<float*>(dC), static_cast<float*>(dcum)};
  auto scr = static_cast<float*>(scratch_buf);
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t bc = b * nc;
  switch (padded(dm.hp)) {
    case 16: return launch_hp<16>(in, out, scr, bc, dm, st, s);
    case 32: return launch_hp<32>(in, out, scr, bc, dm, st, s);
    case 64: return launch_hp<64>(in, out, scr, bc, dm, st, s);
    default: return launch_hp<128>(in, out, scr, bc, dm, st, s);
  }
}
