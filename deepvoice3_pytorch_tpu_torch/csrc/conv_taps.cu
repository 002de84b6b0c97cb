// Tap-accumulating 1-D convolution for Hopper (sm_90a): forward (also the
// input gradient) and weight gradient.
//
// Replaces the Pallas TPU kernels of deepvoice3_pytorch_tpu/ops/conv_pallas.py:
// `_fwd_kernel` (launched by `_launch_fwd`, also for dgrad in `_pconv_bwd`)
// and `_wgrad_kernel` (launched by `_launch_wgrad`). What they compute:
//
//   forward  y[b, t, n] = sum_j sum_c x[b, t + j*dil - pl, c] * W[j, c, n] + bias[n]
//   wgrad   dW[j, c, n] = sum_{b, t} x[b, t + j*dil - pl, c] * dy[b, t, n]
//
// with rows outside [0, T) of the same batch item reading zero (the padding
// is never materialised), all kw taps summed into one f32 accumulator, x read
// once from memory and y written once. The input gradient is the forward on
// dy with the taps flipped and transposed and the padding mirrored (the
// wrapper, ops/conv_cuda.py, makes that weight copy).
//
// What bounds it. At the train step's shapes every one of these products has
// an arithmetic intensity far above the H100's ridge (about 295 FLOP/byte in
// bf16, 20 in f32), so the floor is the arithmetic rate: 989 TFLOP/s for the
// bf16 tensor cores, 67 TFLOP/s for f32 FMA (no TF32: f32 stays full f32).
// To approach it the operands must reach the math units without the
// threads spending issue slots on addresses, and loads must overlap math.
//
// Design. Both are implicit GEMMs; every tile lies inside one batch item
// (BM time steps of item b), so a shifted tap can never read the
// neighbouring item and the padding is a zero fill at the tile's edge.
//   * forward: M = the tile's T rows, N output channels, K = kw*C walked tap
//     by tap, then C in BK steps. The weight comes (kw, N, C) ("out, in":
//     each tap's K contiguous, the ragged route and the f32 forward), the
//     same with its taps read in reverse (the input gradient on the layer's
//     own (kw, C, N) weight, fast route), or as the layer's (kw, C, N)
//     ("in, out", the bf16 forward: wgmma reads it MN-major), so the fast
//     route copies no weight but the f32 forward's.
//   * wgrad, per tap: dW_j (C x N) = x_shift^T dy, K = the B*T rows. Blocks
//     run in parallel and in no order, so each block owns a (tap, C tile,
//     N tile, row split) and loops over its split's row tiles; splits > 1
//     write a (S, kw, C, N) f32 workspace that `sum_splits` adds in a fixed
//     order. No atomics: the gradient is the same from run to run. The
//     wrapper picks S from the shape (fill the 132 SMs in whole waves).
//   * bf16 (fast route, C and N multiples of 8): TMA + wgmma, warp
//     specialised. One producer warp issues cp.async.bulk.tensor loads into
//     a ring of shared-memory stages guarded by full/empty mbarrier pairs;
//     two consumer warpgroups run wgmma.mma_async (64 rows each) on the
//     stages that have arrived. x is read through a 3-D tensor map over
//     (C, T, B) at (c0, t0 + j*dil - pl, b): TMA fills rows outside [0, T)
//     with zeros, negative coordinates included, so the per-tap bounds of
//     the TPU kernel cost nothing. 128-byte swizzle on every tile, matching
//     the wgmma descriptors. Forward: 128 x 256 x 64 tiles (m64n256, 4
//     stages, one block an SM) or 128 x 128 (3 stages, two blocks) where
//     the wide ones would leave half the SMs idle; bias added in f32, one
//     rounding to bf16, and the tile staged through shared memory so that
//     the stores are whole 16-byte runs (the direct fragment stores cost
//     a fifth of the forward's time on the H100). Wgrad: 128 (C) x 128 (N)
//     x 64 rows, both operands MN-major in memory, taken through wgmma's
//     transpose bits; 4 stages.
//     The tensor cores' f32 accumulation does not round to nearest, so a
//     long chain drifts (measured on the H100: one chain over 32768 rows was
//     4e-5 of the largest gradient off a float64 sum, 80x the f32 plain
//     version's error): each k-block of `kblock` row tiles is summed by
//     wgmma into a partial accumulator, then added to the running sum with
//     ordinary f32 adds.
//   * f32 (fast route, C and N multiples of 4): SIMT FMA in f32, 16-byte
//     cp.async (zero-fill for the padding) into a 3-stage ring, one
//     __syncthreads a k-step, 128 x 128 tiles (the forward's 128 x 64 where
//     128 columns would leave half the SMs idle: 40-44 % faster there on
//     the H100), 8 x 8 (8 x 4) outputs a thread, A/B fragments
//     double-buffered in registers.
//   * ragged route: the simple kernels (synchronous loads, one buffer,
//     mma.sync for bf16), for shapes whose rows are not 16-byte multiples.
//     The wrapper picks the route from the shape alone; nothing falls back.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (or an encode error of the tensor maps).

#include <chrono>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kFar = -(1 << 29);   // time of a row past the end: every tap misses

// ---------------------------------------------------------------------------
// Ragged route (shapes the fast routes refuse): f32 SIMT FMA
// ---------------------------------------------------------------------------

constexpr int FM = 128, FN = 64, FK = 16, F_THREADS = 256, FPAD = 4;

// acc[i][j] += As[k][ty*8 + i] * Bs[k][tx*4 + j] over the tile's FK
__device__ __forceinline__ void fma_tile(const float (*As)[FM + FPAD],
                                         const float (*Bs)[FN + FPAD], int ty,
                                         int tx, float acc[8][4]) {
#pragma unroll
  for (int kk = 0; kk < FK; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[kk][ty * 8]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[kk][ty * 8 + 4]);
    const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__global__ void __launch_bounds__(F_THREADS)
fwd_f32_simple(const float* __restrict__ x, const float* __restrict__ wt,
        const float* __restrict__ bias, float* __restrict__ y, int B, int T,
        int C, int N, int kw, int dil, int pl) {
  __shared__ __align__(16) float As[FK][FM + FPAD];   // [k][row]
  __shared__ __align__(16) float Bs[FK][FN + FPAD];   // [k][col]
  const int M = B * T;
  const int m0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // loader: k column lk, rows lr + 16 i (A, i < 8) and cols lr + 16 i (B, i < 4)
  const int lk = tid & 15, lr = tid >> 4;
  int lt[8];
  size_t lbase[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + lr + 16 * i;
    const int b = m / T;
    lt[i] = m < M ? m - b * T : kFar;
    lbase[i] = m < M ? (size_t)b * T * C : 0;
  }
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int j = 0; j < kw; ++j) {
    const int shift = j * dil - pl;
    const float* wj = wt + (size_t)j * N * C;
    for (int c0 = 0; c0 < C; c0 += FK) {
      const int c = c0 + lk;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ts = lt[i] + shift;
        float v = 0.0f;
        if (c < C && ts >= 0 && ts < T) v = x[lbase[i] + (size_t)ts * C + c];
        As[lk][lr + 16 * i] = v;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = n0 + lr + 16 * i;
        Bs[lk][lr + 16 * i] = (c < C && n < N) ? wj[(size_t)n * C + c] : 0.0f;
      }
      __syncthreads();
      fma_tile(As, Bs, ty, tx, acc);
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 8 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) y[(size_t)m * N + n] = acc[i][j] + (bias ? bias[n] : 0.0f);
    }
  }
}

// grid (C tiles, N tiles, kw * S); out is (S, kw, C, N)
__global__ void __launch_bounds__(F_THREADS)
wgrad_f32_simple(const float* __restrict__ x, const float* __restrict__ dy,
          float* __restrict__ out, int B, int T, int C, int N, int kw, int dil,
          int pl, int rows_per_split) {
  __shared__ __align__(16) float As[FK][FM + FPAD];   // [row][c]
  __shared__ __align__(16) float Bs[FK][FN + FPAD];   // [row][n]
  const int M = B * T;
  const int j = blockIdx.z % kw, s = blockIdx.z / kw;
  const int shift = j * dil - pl;
  const int r_begin = s * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int c0 = blockIdx.x * FM, n0 = blockIdx.y * FN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ac = tid & 127, ak = tid >> 7;   // A loads: c ac, rows ak + 2 i
  const int bn = tid & 63, bk = tid >> 6;    // B loads: n bn, rows bk + 4 i
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += FK) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kl = ak + 2 * i, m = r0 + kl, c = c0 + ac;
      float v = 0.0f;
      if (m < r_end && c < C) {
        const int b = m / T, ts = m - b * T + shift;
        if (ts >= 0 && ts < T) v = x[((size_t)b * T + ts) * C + c];
      }
      As[kl][ac] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kl = bk + 4 * i, m = r0 + kl, n = n0 + bn;
      Bs[kl][bn] = (m < r_end && n < N) ? dy[(size_t)m * N + n] : 0.0f;
    }
    __syncthreads();
    fma_tile(As, Bs, ty, tx, acc);
    __syncthreads();
  }
  float* o = out + ((size_t)s * kw + j) * C * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + ty * 8 + i;
    if (c >= C) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tx * 4 + q;
      if (n < N) o[(size_t)c * N + n] = acc[i][q];
    }
  }
}

// ---------------------------------------------------------------------------
// Ragged route: bf16 mma.sync m16n8k16, f32 accumulation
// ---------------------------------------------------------------------------

constexpr int HM = 64, HN = 64, HK = 32, H_THREADS = 128;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Eight consecutive elements src[off + c .. off + c + 7], zero past `len` or
// when !valid. vec: len % 8 == 0 and src 16-byte aligned.
__device__ __forceinline__ uint4 load8(const bf16* src, size_t off, int c,
                                       int len, bool valid, int vec) {
  if (!valid || c >= len) return make_uint4(0u, 0u, 0u, 0u);
  const bf16* p = src + off + c;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  const bf16 z = __ushort_as_bfloat16((unsigned short)0);
  bf16 h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = c + e < len ? p[e] : z;
  return make_uint4(pack2(h[0], h[1]), pack2(h[2], h[3]), pack2(h[4], h[5]),
                    pack2(h[6], h[7]));
}

// Accumulator (mi, ni, h) of warp (wm, wn), lane (g, tg) holds row
// wm*32 + mi*16 + g + 8h and columns col, col + 1, col = wn*32 + ni*8 + 2tg.

__global__ void __launch_bounds__(H_THREADS)
fwd_bf16_simple(const bf16* __restrict__ x, const bf16* __restrict__ wt,
         const float* __restrict__ bias, bf16* __restrict__ y, int B, int T,
         int C, int N, int kw, int dil, int pl, int vec) {
  __shared__ __align__(16) bf16 As[HM][HK + 8];   // [row][k]
  __shared__ __align__(16) bf16 Bs[HN][HK + 8];   // [col][k]
  const int M = B * T;
  const int m0 = blockIdx.x * HM, n0 = blockIdx.y * HN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
  // loader: rows (tid >> 2) + 32 s, eight k values from (tid & 3) * 8
  const int lr = tid >> 2, lc = (tid & 3) * 8;
  int lt[2];
  size_t lbase[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int m = m0 + lr + 32 * s;
    const int b = m / T;
    lt[s] = m < M ? m - b * T : kFar;
    lbase[s] = m < M ? (size_t)b * T * C : 0;
  }
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][q][v] = 0.0f;

  for (int j = 0; j < kw; ++j) {
    const int shift = j * dil - pl;
    const bf16* wj = wt + (size_t)j * N * C;
    for (int c0 = 0; c0 < C; c0 += HK) {
      const int c = c0 + lc;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int ts = lt[s] + shift;
        const bool ok = ts >= 0 && ts < T;
        *reinterpret_cast<uint4*>(&As[lr + 32 * s][lc]) =
            load8(x, ok ? lbase[s] + (size_t)ts * C : 0, c, C, ok, vec);
        const int n = n0 + lr + 32 * s;
        *reinterpret_cast<uint4*>(&Bs[lr + 32 * s][lc]) =
            load8(wj, n < N ? (size_t)n * C : 0, c, C, n < N, vec);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < HK; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = wm * 32 + mi * 16 + g;
          af[mi][0] = ld32(&As[r][kk + tg * 2]);
          af[mi][1] = ld32(&As[r + 8][kk + tg * 2]);
          af[mi][2] = ld32(&As[r][kk + tg * 2 + 8]);
          af[mi][3] = ld32(&As[r + 8][kk + tg * 2 + 8]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int r = wn * 32 + ni * 8 + g;
          bfr[ni][0] = ld32(&Bs[r][kk + tg * 2]);
          bfr[ni][1] = ld32(&Bs[r][kk + tg * 2 + 8]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * tg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        bf16* dst = y + (size_t)row * N + col;
        if (col < N)
          dst[0] = __float2bfloat16_rn(acc[mi][ni][2 * h] +
                                       (bias ? bias[col] : 0.0f));
        if (col + 1 < N)
          dst[1] = __float2bfloat16_rn(acc[mi][ni][2 * h + 1] +
                                       (bias ? bias[col + 1] : 0.0f));
      }
    }
}

// grid (C tiles, N tiles, kw * S); out is (S, kw, C, N) f32
__global__ void __launch_bounds__(H_THREADS)
wgrad_bf16_simple(const bf16* __restrict__ x, const bf16* __restrict__ dy,
           float* __restrict__ out, int B, int T, int C, int N, int kw,
           int dil, int pl, int rows_per_split, int vec_c, int vec_n) {
  // both tiles stored as loaded, rows of the B*T axis first; the fragments
  // are gathered transposed (two 16-bit loads per register)
  __shared__ __align__(16) bf16 As[HK][HM + 8];   // [row][c]
  __shared__ __align__(16) bf16 Bs[HK][HN + 8];   // [row][n]
  const int M = B * T;
  const int j = blockIdx.z % kw, s = blockIdx.z / kw;
  const int shift = j * dil - pl;
  const int r_begin = s * rows_per_split;
  const int r_end = min(M, r_begin + rows_per_split);
  const int c0 = blockIdx.x * HM, n0 = blockIdx.y * HN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;
  const int lk = tid >> 3, lc = (tid & 7) * 8;   // rows lk + 16 s
  // The reduction runs over up to B*T rows. The tensor cores' f32
  // accumulation does not round to nearest, so a long chain inside mma
  // drifts: each HK-row tile is summed by mma into `part`, then added to
  // `acc` with an ordinary (round-to-nearest) f32 add.
  float acc[2][4][4], part[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][q][v] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += HK) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < 4; ++v) part[i][q][v] = 0.0f;
#pragma unroll
    for (int s2 = 0; s2 < 2; ++s2) {
      const int kl = lk + 16 * s2, m = r0 + kl;
      bool ok = m < r_end;
      size_t off = 0;
      if (ok) {
        const int b = m / T, ts = m - b * T + shift;
        ok = ts >= 0 && ts < T;
        off = ok ? ((size_t)b * T + ts) * C : 0;
      }
      *reinterpret_cast<uint4*>(&As[kl][lc]) =
          load8(x, off, c0 + lc, C, ok, vec_c);
      *reinterpret_cast<uint4*>(&Bs[kl][lc]) =
          load8(dy, m < r_end ? (size_t)m * N : 0, n0 + lc, N, m < r_end,
                vec_n);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HK; kk += 16) {
      const int k0 = kk + tg * 2;
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        af[mi][0] = pack2(As[k0][r], As[k0 + 1][r]);
        af[mi][1] = pack2(As[k0][r + 8], As[k0 + 1][r + 8]);
        af[mi][2] = pack2(As[k0 + 8][r], As[k0 + 9][r]);
        af[mi][3] = pack2(As[k0 + 8][r + 8], As[k0 + 9][r + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        bfr[ni][0] = pack2(Bs[k0][n], Bs[k0 + 1][n]);
        bfr[ni][1] = pack2(Bs[k0 + 8][n], Bs[k0 + 9][n]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], af[mi], bfr[ni]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][q][v] += part[i][q][v];
    __syncthreads();
  }

  float* o = out + ((size_t)s * kw + j) * C * N;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * tg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * 32 + mi * 16 + g + 8 * h;
        if (c >= C) continue;
        if (col < N) o[(size_t)c * N + col] = acc[mi][ni][2 * h];
        if (col + 1 < N) o[(size_t)c * N + col + 1] = acc[mi][ni][2 * h + 1];
      }
    }
}

// out[i] = sum_s part[s][i], s in order
__global__ void sum_splits(const float* __restrict__ part,
                           float* __restrict__ out, int S, size_t n) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.0f;
  for (int s = 0; s < S; ++s) a += part[(size_t)s * n + i];
  out[i] = a;
}


// ---------------------------------------------------------------------------
// Fast route, f32: cp.async ring, SIMT FMA
// ---------------------------------------------------------------------------

constexpr int PM = 128, PK = 32, P_THREADS = 256, P_STAGES = 3;
constexpr int PKP = PK + 4;   // forward tiles [row][k]: 144-byte rows, no conflicts

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// grid (B * t_tiles, N tiles). Thread (ty, tx) owns rows ty + 16 i (i < 8)
// and columns tx + 16 q (q < BN / 16). Stage: A [PM][PKP] (rows of x, k
// contiguous), B [BN][PKP] (rows of wt).
template <int BN>
__global__ void __launch_bounds__(P_THREADS, 1)
fwd_f32_pipe(const float* __restrict__ x, const float* __restrict__ wt,
             const float* __restrict__ bias, float* __restrict__ y, int T,
             int C, int N, int kw, int dil, int pl, int t_tiles, int flip) {
  constexpr int TN = BN / 16, A_FL = PM * PKP, STAGE_FL = (PM + BN) * PKP;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x - b * t_tiles) * PM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int kc = (C + PK - 1) / PK, iters = kw * kc;
  const float* xb = x + (size_t)b * T * C;
  const int lr = tid >> 3, lc = (tid & 7) * 4;   // loads: rows lr + 32 q

  auto load = [&](int it, int st) {
    const int j = it / kc, c = (it - j * kc) * PK + lc;
    const int shift = j * dil - pl, jw = flip ? kw - 1 - j : j;
    float* As = sm + st * STAGE_FL;
    float* Bs = As + A_FL;
#pragma unroll
    for (int q = 0; q < PM / 32; ++q) {
      const int t = t0 + lr + 32 * q + shift;
      const bool ok = c < C && t >= 0 && t < T;
      cp_async16(&As[(lr + 32 * q) * PKP + lc],
                 ok ? xb + (size_t)t * C + c : x, ok);
    }
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      const int n = n0 + lr + 32 * q;
      const bool ok = c < C && n < N;
      cp_async16(&Bs[(lr + 32 * q) * PKP + lc],
                 ok ? wt + ((size_t)jw * N + n) * C + c : wt, ok);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.0f;

#pragma unroll
  for (int st = 0; st < P_STAGES - 1; ++st) {
    if (st < iters) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<P_STAGES - 2>();
    __syncthreads();
    const int nxt = it + P_STAGES - 1;
    if (nxt < iters) load(nxt, nxt % P_STAGES);
    cp_async_commit();
    const float* As = sm + (it % P_STAGES) * STAGE_FL;
    const float* Bs = As + A_FL;
    float4 af[2][8], bfr[2][TN];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      af[0][i] = *reinterpret_cast<const float4*>(&As[(ty + 16 * i) * PKP]);
#pragma unroll
    for (int q = 0; q < TN; ++q)
      bfr[0][q] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * q) * PKP]);
#pragma unroll
    for (int kk = 0; kk < PK / 4; ++kk) {
      const int cur = kk & 1, nx = cur ^ 1;
      if (kk + 1 < PK / 4) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          af[nx][i] = *reinterpret_cast<const float4*>(
              &As[(ty + 16 * i) * PKP + 4 * (kk + 1)]);
#pragma unroll
        for (int q = 0; q < TN; ++q)
          bfr[nx][q] = *reinterpret_cast<const float4*>(
              &Bs[(tx + 16 * q) * PKP + 4 * (kk + 1)]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < TN; ++q) fma4(acc[i][q], af[cur][i], bfr[cur][q]);
    }
  }
  cp_async_wait<0>();

  float* yb = y + (size_t)b * T * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int n = n0 + tx + 16 * q;
      if (n < N) yb[(size_t)t * N + n] = acc[i][q] + (bias ? bias[n] : 0.0f);
    }
  }
}

// grid (C tiles, N tiles, kw * S); out is (S, kw, C, N). Tiles of PM
// channels x PWN columns; row tiles of PK rows inside one item; split s
// takes tiles [s * per, (s + 1) * per). Thread (ty, tx) owns channels
// ty*4 + {0..3} (+ 64) and columns tx*4 + {0..3} (+ 64). Stage: A [PK][PM],
// B [PK][PWN], both as loaded (c and n contiguous).
constexpr int PWN = 128;
__global__ void __launch_bounds__(P_THREADS, 1)
wgrad_f32_pipe(const float* __restrict__ x, const float* __restrict__ dy,
               float* __restrict__ out, int T, int C, int N, int kw, int dil,
               int pl, int t_tiles, int row_tiles, int per_split) {
  constexpr int BN = PWN, NH = BN / 64, A_FL = PK * PM;
  constexpr int STAGE_FL = PK * (PM + BN);
  constexpr int BQ = BN / 4;   // float4 chunks in a B row
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int j = blockIdx.z % kw, s = blockIdx.z / kw;
  const int shift = j * dil - pl;
  const int r_begin = s * per_split;
  const int iters = max(0, min(row_tiles, r_begin + per_split) - r_begin);
  const int c0 = blockIdx.x * PM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  auto load = [&](int it, int st) {
    const int r = r_begin + it, b = r / t_tiles;
    const int tb = (r - b * t_tiles) * PK;
    float* As = sm + st * STAGE_FL;
    float* Bs = As + A_FL;
#pragma unroll
    for (int q = 0; q < PM * PK / 4 / P_THREADS; ++q) {
      const int e = tid + q * P_THREADS, row = e / (PM / 4);
      const int c = c0 + (e % (PM / 4)) * 4;
      const int t = tb + row, ts = t + shift;
      const bool ok = c < C && t < T && ts >= 0 && ts < T;
      cp_async16(&As[row * PM + (e % (PM / 4)) * 4],
                 ok ? x + ((size_t)b * T + ts) * C + c : x, ok);
    }
#pragma unroll
    for (int q = 0; q < BQ * PK / P_THREADS; ++q) {
      const int e = tid + q * P_THREADS, row = e / BQ;
      const int n = n0 + (e % BQ) * 4, t = tb + row;
      const bool ok = n < N && t < T;
      cp_async16(&Bs[row * BN + (e % BQ) * 4],
                 ok ? dy + ((size_t)b * T + t) * N + n : dy, ok);
    }
  };

  float acc[8][4 * NH];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int q = 0; q < 4 * NH; ++q) acc[i][q] = 0.0f;

#pragma unroll
  for (int st = 0; st < P_STAGES - 1; ++st) {
    if (st < iters) load(st, st);
    cp_async_commit();
  }
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<P_STAGES - 2>();
    __syncthreads();
    const int nxt = it + P_STAGES - 1;
    if (nxt < iters) load(nxt, nxt % P_STAGES);
    cp_async_commit();
    const float* As = sm + (it % P_STAGES) * STAGE_FL;
    const float* Bs = As + A_FL;
    float4 af[2][2], bfr[2][NH];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      af[0][h] = *reinterpret_cast<const float4*>(&As[ty * 4 + 64 * h]);
#pragma unroll
    for (int h = 0; h < NH; ++h)
      bfr[0][h] = *reinterpret_cast<const float4*>(&Bs[tx * 4 + 64 * h]);
#pragma unroll
    for (int k = 0; k < PK; ++k) {
      const int cur = k & 1, nx = cur ^ 1;
      if (k + 1 < PK) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          af[nx][h] = *reinterpret_cast<const float4*>(
              &As[(k + 1) * PM + ty * 4 + 64 * h]);
#pragma unroll
        for (int h = 0; h < NH; ++h)
          bfr[nx][h] = *reinterpret_cast<const float4*>(
              &Bs[(k + 1) * BN + tx * 4 + 64 * h]);
      }
      const float a[8] = {af[cur][0].x, af[cur][0].y, af[cur][0].z,
                          af[cur][0].w, af[cur][1].x, af[cur][1].y,
                          af[cur][1].z, af[cur][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          acc[i][4 * h + 0] = fmaf(a[i], bfr[cur][h].x, acc[i][4 * h + 0]);
          acc[i][4 * h + 1] = fmaf(a[i], bfr[cur][h].y, acc[i][4 * h + 1]);
          acc[i][4 * h + 2] = fmaf(a[i], bfr[cur][h].z, acc[i][4 * h + 2]);
          acc[i][4 * h + 3] = fmaf(a[i], bfr[cur][h].w, acc[i][4 * h + 3]);
        }
    }
  }
  cp_async_wait<0>();

  float* o = out + ((size_t)s * kw + j) * C * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + ty * 4 + (i & 3) + 64 * (i >> 2);
    if (c >= C) continue;
#pragma unroll
    for (int h = 0; h < NH; ++h) {
      const int n = n0 + tx * 4 + 64 * h;
      if (n < N)
        *reinterpret_cast<float4*>(&o[(size_t)c * N + n]) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Fast route, bf16: TMA + wgmma, warp specialised
// ---------------------------------------------------------------------------

constexpr int GM = 128, GN = 128, GK = 64;   // tile rows, cols, K per stage
constexpr int G_THREADS = 288;   // warps 0-7: two consumer warpgroups; 8: producer
constexpr int G_OPERAND = GM * GK * 2;   // bytes of one 128 x 64 bf16 tile
constexpr int G_STAGE = 2 * G_OPERAND;
constexpr int WGRAD_STAGES = 4;

// forward with BN output columns a tile: x tile 16 KB + weight tile BN x 64;
// BN = 128: 3 stages, two blocks an SM; BN = 256: 4 stages, one block
template <int BN>
struct FwdShape {
  static constexpr int STAGE = G_OPERAND + BN * GK * 2;
  static constexpr int STAGES = BN == 128 ? 3 : 4;
  static constexpr int BLOCKS = BN == 128 ? 2 : 1;
};

constexpr size_t g_smem(int stages, int stage_bytes) {
  return (size_t)stages * stage_bytes + 2 * stages * 8 + 1024;   // + alignment
}

// acc (+)= A B over one 64-deep stage: four k16 steps. A (x) K-major; the
// weight tile K-major ([BN][64], BMN = 0) or MN-major (BN / 64 boxes of
// [64 in-channels][64 out-channels], 8 KB apart, BMN = 1).
template <int BN, int BMN>
__device__ __forceinline__ void fwd_stage_mma(float (&acc)[BN / 2], uint32_t a,
                                              uint32_t w) {
#pragma unroll
  for (int k = 0; k < GK / 16; ++k) {
    const uint64_t da = sw128_desc(a + 32 * k, 0, 1024);
    const uint64_t dw = BMN ? sw128_desc(w + 2048 * k, 8192, 1024)
                            : sw128_desc(w + 32 * k, 0, 1024);
    if constexpr (BN == 256)
      wgmma_m64n256k16<BMN>(acc, da, dw, 1);
    else
      wgmma_m64n128k16<0, BMN>(acc, da, dw, 1);
  }
}

// grid (B * t_tiles, N tiles). mx: x over (C, T, B), box (64, 128, 1).
// BMN = 0: mw over wt (kw, N, C) as (C, N, kw), box (64, BN, 1), tap j read
// at kw - 1 - j when flip; BMN = 1: mw over w (kw, C, N) as (N, C, kw), box
// (64, 64, 1).
template <int BN, int BMN>
__global__ void __launch_bounds__(G_THREADS, FwdShape<BN>::BLOCKS)
fwd_bf16_wgmma(const __grid_constant__ CUtensorMap mx,
               const __grid_constant__ CUtensorMap mw,
               const float* __restrict__ bias, bf16* __restrict__ y, int T,
               int C, int N, int kw, int dil, int pl, int t_tiles, int flip) {
  constexpr int STAGES = FwdShape<BN>::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw, STAGES, FwdShape<BN>::STAGE);
  const int b = blockIdx.x / t_tiles;
  const int t0 = (blockIdx.x - b * t_tiles) * GM, n0 = blockIdx.y * BN;
  const int kc = (C + GK - 1) / GK, iters = kw * kc;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 8) {   // producer
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < iters; ++it) {
        const int j = it / kc, c0 = (it - j * kc) * GK;
        mbar_wait(ring.empty + 8 * s, ph ^ 1);
        mbar_expect_tx(ring.full + 8 * s, FwdShape<BN>::STAGE);
        const uint32_t a = ring.stage(s), bar = ring.full + 8 * s;
        tma_load_3d(a, &mx, bar, c0, t0 + j * dil - pl, b);
        if (BMN) {
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            tma_load_3d(a + G_OPERAND + 8192 * q, &mw, bar, n0 + 64 * q, c0,
                        j);
        } else {
          tma_load_3d(a + G_OPERAND, &mw, bar, c0, n0, flip ? kw - 1 - j : j);
        }
        if (++s == STAGES) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int wg = warp >> 2;   // rows wg * 64 .. + 63 of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  int s = 0, prev = -1;
  uint32_t ph = 0;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(ring.full + 8 * s, ph);
    wgmma_fence();
    fence_acc(acc);
    fwd_stage_mma<BN, BMN>(acc, ring.stage(s) + wg * 64 * 128,
                           ring.stage(s) + G_OPERAND);
    wgmma_commit();
    wgmma_wait<1>();   // the stage before this one is read: release it
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + 8 * prev);
    prev = s;
    if (++s == STAGES) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc(acc);

  // Epilogue through shared memory, so that the stores to y are whole
  // 16-byte runs of a row. The ring is free once both warpgroups are past
  // their last wgmma (every load it held has been consumed).
  constexpr int OS = BN + 8;   // tile row stride in bf16: 16 bytes of padding
  bf16* tile = reinterpret_cast<bf16*>(ring.base);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // fragment: row (warp % 4) * 16 + lane / 4 (+ 8), columns 8 i + 2 (lane % 4)
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    const int col = 8 * i + 2 * (lane & 3), n = n0 + col;
    const float b0 = bias && n < N ? bias[n] : 0.0f;
    const float b1 = bias && n < N ? bias[n + 1] : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<__nv_bfloat162*>(&tile[(row + 8 * h) * OS + col]) =
          __floats2bfloat162_rn(acc[4 * i + 2 * h] + b0,
                                acc[4 * i + 2 * h + 1] + b1);
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  bf16* yb = y + (size_t)b * T * N;
  for (int e = threadIdx.x; e < GM * (BN / 8); e += 256) {
    const int r = e / (BN / 8), c = (e - r * (BN / 8)) * 8;
    if (t0 + r < T && n0 + c < N)
      *reinterpret_cast<uint4*>(&yb[(size_t)(t0 + r) * N + n0 + c]) =
          *reinterpret_cast<const uint4*>(&tile[r * OS + c]);
  }
}

// grid (C tiles, N tiles, kw * S); out is (S, kw, C, N) f32. mx: x over
// (C, T, B), mdy: dy over (N, T, B), both with box (64, 64, 1). A stage
// holds x's two 64-channel halves then dy's two 64-column halves, each
// [64 rows][64], rows along K: the MN-major layout wgmma takes transposed.
__global__ void __launch_bounds__(G_THREADS, 1)
wgrad_bf16_wgmma(const __grid_constant__ CUtensorMap mx,
                 const __grid_constant__ CUtensorMap mdy,
                 float* __restrict__ out, int T, int C, int N, int kw,
                 int dil, int pl, int t_tiles, int row_tiles, int per_split,
                 int kblock) {
  constexpr int HALF = G_OPERAND / 2;   // one [64][64] bf16 tile
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw, WGRAD_STAGES, G_STAGE);
  const int j = blockIdx.z % kw, sp = blockIdx.z / kw;
  const int shift = j * dil - pl;
  const int r_begin = sp * per_split;
  const int iters = max(0, min(row_tiles, r_begin + per_split) - r_begin);
  const int c0 = blockIdx.x * GM, n0 = blockIdx.y * GN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (warp == 8) {   // producer
    if (lane == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int it = 0; it < iters; ++it) {
        const int r = r_begin + it, b = r / t_tiles;
        const int t = (r - b * t_tiles) * GK;
        mbar_wait(ring.empty + 8 * s, ph ^ 1);
        const uint32_t bar = ring.full + 8 * s, a = ring.stage(s);
        mbar_expect_tx(bar, G_STAGE);
        tma_load_3d(a, &mx, bar, c0, t + shift, b);
        tma_load_3d(a + HALF, &mx, bar, c0 + 64, t + shift, b);
        tma_load_3d(a + 2 * HALF, &mdy, bar, n0, t, b);
        tma_load_3d(a + 3 * HALF, &mdy, bar, n0 + 64, t, b);
        if (++s == WGRAD_STAGES) { s = 0; ph ^= 1; }
      }
    }
    return;
  }

  const int wg = warp >> 2;   // channels wg * 64 .. + 63 of the tile
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.0f;
  int s = 0, pend = -1;
  uint32_t ph = 0;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(ring.full + 8 * s, ph);
    const uint32_t a = ring.stage(s) + wg * HALF, g = ring.stage(s) + 2 * HALF;
    const bool first = it % kblock == 0;
    const bool last = it % kblock == kblock - 1 || it == iters - 1;
    wgmma_fence();
    fence_acc(part);
#pragma unroll
    for (int k = 0; k < GK / 16; ++k)   // 16 rows of K = 2048 bytes
      wgmma_m64n128k16<1, 1>(part, sw128_desc(a + 2048 * k, HALF, 1024),
                             sw128_desc(g + 2048 * k, HALF, 1024),
                             (first && k == 0) ? 0 : 1);
    wgmma_commit();
    if (last) {
      wgmma_wait<0>();
      fence_acc(part);
      if (lane == 0) {
        if (pend >= 0) mbar_arrive(ring.empty + 8 * pend);
        mbar_arrive(ring.empty + 8 * s);
      }
      pend = -1;
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    } else {
      wgmma_wait<1>();
      fence_acc(part);
      if (pend >= 0 && lane == 0) mbar_arrive(ring.empty + 8 * pend);
      pend = s;
    }
    if (++s == WGRAD_STAGES) { s = 0; ph ^= 1; }
  }

  float* o = out + ((size_t)sp * kw + j) * C * N;
  const int crow = c0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < GN / 8; ++i) {
    const int n = n0 + 8 * i + 2 * (lane & 3);
    if (n >= N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = crow + 8 * h;
      if (c < C)
        *reinterpret_cast<float2*>(&o[(size_t)c * N + n]) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}


unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }


// w_layout of the fast forward: wt (kw, N, C) ("out, in" per tap), the same
// with the taps read in reverse (the input gradient on the layer's own
// weight), or w (kw, C, N) ("in, out", bf16 only)
constexpr int kOutIn = 0, kTapsReversed = 1, kInOut = 2;


size_t pipe_fwd_smem(int bn) {
  return (size_t)P_STAGES * (PM + bn) * PKP * sizeof(float);
}
constexpr size_t kPipeWgradSmem =
    (size_t)P_STAGES * PK * (PM + PWN) * sizeof(float);

void launch_sum_splits(const float* part, float* dw, int splits, size_t n,
                       cudaStream_t stream) {
  sum_splits<<<cdiv((long)n, 256), 256, 0, stream>>>(part, dw, splits, n);
}

template <int BN, int BMN>
int launch_fwd_bf16(dim3 grid, cudaStream_t stream, const CUtensorMap& mx,
                    const CUtensorMap& mw, const float* bias, void* y, int T,
                    int C, int N, int kw, int dil, int pl, int t_tiles,
                    int flip) {
  constexpr size_t smem = g_smem(FwdShape<BN>::STAGES, FwdShape<BN>::STAGE);
  static cudaError_t attr = allow_smem(fwd_bf16_wgmma<BN, BMN>, smem);
  if (attr != cudaSuccess) return (int)attr;
  fwd_bf16_wgmma<BN, BMN><<<grid, G_THREADS, smem, stream>>>(
      mx, mw, bias, (bf16*)y, T, C, N, kw, dil, pl, t_tiles, flip);
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// Ragged route
// ---------------------------------------------------------------------------

// y (B, T, N) = conv of x (B, T, C) with wt (kw, N, C) ("out, in" per tap),
// padding (pl, (kw-1)*dil - pl), plus bias (N,) f32 when not null.
// bf16 != 0: x, wt and y are bf16, else f32. vec: C % 8 == 0 and x, wt
// 16-byte aligned (bf16 only).
extern "C" int dv3_conv_taps_fwd(const void* x, const void* wt,
                                 const float* bias, void* y, int B, int T,
                                 int C, int N, int kw, int dil, int pl,
                                 int is_bf16, int vec, void* stream_ptr,
                                 int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long M = (long)B * T;
  if (is_bf16) {
    dim3 grid(cdiv(M, HM), cdiv(N, HN));
    fwd_bf16_simple<<<grid, H_THREADS, 0, stream>>>(
        (const bf16*)x, (const bf16*)wt, bias, (bf16*)y, B, T, C, N, kw, dil,
        pl, vec);
  } else {
    dim3 grid(cdiv(M, FM), cdiv(N, FN));
    fwd_f32_simple<<<grid, F_THREADS, 0, stream>>>(
        (const float*)x, (const float*)wt, bias, (float*)y, B, T, C, N, kw,
        dil, pl);
  }
  return (int)cudaGetLastError();
}

// dw (kw, C, N) f32 = weight gradient of the conv for input x (B, T, C) and
// output gradient dy (B, T, N). splits > 1 writes partial sums to part
// (splits, kw, C, N) f32 and adds them in order; rows_per_split * splits
// >= B*T.
extern "C" int dv3_conv_taps_wgrad(const void* x, const void* dy, float* part,
                                   float* dw, int B, int T, int C, int N,
                                   int kw, int dil, int pl, int splits,
                                   int rows_per_split, int is_bf16, int vec_c,
                                   int vec_n, void* stream_ptr, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float* out = splits > 1 ? part : dw;
  if (is_bf16) {
    dim3 grid(cdiv(C, HM), cdiv(N, HN), kw * splits);
    wgrad_bf16_simple<<<grid, H_THREADS, 0, stream>>>(
        (const bf16*)x, (const bf16*)dy, out, B, T, C, N, kw, dil, pl,
        rows_per_split, vec_c, vec_n);
  } else {
    dim3 grid(cdiv(C, FM), cdiv(N, FN), kw * splits);
    wgrad_f32_simple<<<grid, F_THREADS, 0, stream>>>(
        (const float*)x, (const float*)dy, out, B, T, C, N, kw, dil, pl,
        rows_per_split);
  }
  if (splits > 1) launch_sum_splits(part, dw, splits, (size_t)kw * C * N, stream);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Fast route: the same contracts. C and N multiples of 8 (bf16) or 4 (f32),
// x, wt, dy and y 16-byte aligned. bn: the forward tile's columns (f32 128
// or 64, bf16 256 or 128; any other is cudaErrorInvalidValue); the wgrad's
// tiles are 128 x 128. The fast
// forward also takes the weight's layout (w_layout, above): a layer's own
// (kw, C, N) weight serves the forward (bf16, kInOut) and the input
// gradient (kTapsReversed) without a copy.
// ---------------------------------------------------------------------------

extern "C" int dv3_conv_taps_fwd_fast(const void* x, const void* wt,
                                      const float* bias, void* y, int B,
                                      int T, int C, int N, int kw, int dil,
                                      int pl, int is_bf16, int bn,
                                      int w_layout, void* stream_ptr,
                                      int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int flip = w_layout == kTapsReversed;
  if (is_bf16 ? bn != 128 && bn != 256 : bn != 64 && bn != 128)
    return (int)cudaErrorInvalidValue;
  if (is_bf16) {
    const bool mn = w_layout == kInOut;
    CUtensorMap mx, mw;
    int rc = encode_bf16(&mx, x, C, T, B, GK, GM);
    if (rc == 0)
      rc = mn ? encode_bf16(&mw, wt, N, C, kw, 64, GK)
              : encode_bf16(&mw, wt, C, N, kw, GK, bn);
    if (rc != 0) return rc;
    const int t_tiles = (int)cdiv(T, GM);
    dim3 grid((unsigned)B * t_tiles, cdiv(N, bn));
    if (bn == 256 && mn)
      rc = launch_fwd_bf16<256, 1>(grid, stream, mx, mw, bias, y, T, C, N, kw,
                                   dil, pl, t_tiles, flip);
    else if (bn == 256)
      rc = launch_fwd_bf16<256, 0>(grid, stream, mx, mw, bias, y, T, C, N, kw,
                                   dil, pl, t_tiles, flip);
    else if (mn)
      rc = launch_fwd_bf16<128, 1>(grid, stream, mx, mw, bias, y, T, C, N, kw,
                                   dil, pl, t_tiles, flip);
    else
      rc = launch_fwd_bf16<128, 0>(grid, stream, mx, mw, bias, y, T, C, N, kw,
                                   dil, pl, t_tiles, flip);
    if (rc != 0) return rc;
  } else {
    if (w_layout == kInOut) return (int)cudaErrorInvalidValue;
    const int t_tiles = (int)cdiv(T, PM);
    dim3 grid((unsigned)B * t_tiles, cdiv(N, bn));
    if (bn == 128) {
      static cudaError_t attr = allow_smem(fwd_f32_pipe<128>, pipe_fwd_smem(128));
      if (attr != cudaSuccess) return (int)attr;
      fwd_f32_pipe<128><<<grid, P_THREADS, pipe_fwd_smem(128), stream>>>(
          (const float*)x, (const float*)wt, bias, (float*)y, T, C, N, kw,
          dil, pl, t_tiles, flip);
    } else {
      static cudaError_t attr = allow_smem(fwd_f32_pipe<64>, pipe_fwd_smem(64));
      if (attr != cudaSuccess) return (int)attr;
      fwd_f32_pipe<64><<<grid, P_THREADS, pipe_fwd_smem(64), stream>>>(
          (const float*)x, (const float*)wt, bias, (float*)y, T, C, N, kw,
          dil, pl, t_tiles, flip);
    }
  }
  return (int)cudaGetLastError();
}

// per_split row tiles (64 rows bf16, 32 f32, inside one item) a split;
// splits * per_split >= B * ceil(T / rows). kblock: row tiles summed by
// wgmma before each f32 add (bf16).
extern "C" int dv3_conv_taps_wgrad_fast(const void* x, const void* dy,
                                        float* part, float* dw, int B, int T,
                                        int C, int N, int kw, int dil, int pl,
                                        int splits, int per_split,
                                        int is_bf16, int kblock,
                                        void* stream_ptr, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  float* out = splits > 1 ? part : dw;
  if (is_bf16) {
    CUtensorMap mx, mdy;
    int rc = encode_bf16(&mx, x, C, T, B, 64, GK);
    if (rc == 0) rc = encode_bf16(&mdy, dy, N, T, B, 64, GK);
    if (rc != 0) return rc;
    static cudaError_t attr =
        allow_smem(wgrad_bf16_wgmma, g_smem(WGRAD_STAGES, G_STAGE));
    if (attr != cudaSuccess) return (int)attr;
    const int t_tiles = (int)cdiv(T, GK);
    dim3 grid(cdiv(C, GM), cdiv(N, GN), kw * splits);
    wgrad_bf16_wgmma<<<grid, G_THREADS, g_smem(WGRAD_STAGES, G_STAGE),
                       stream>>>(
        mx, mdy, out, T, C, N, kw, dil, pl, t_tiles, B * t_tiles, per_split,
        kblock > 0 ? kblock : 1);
  } else {
    static cudaError_t attr = allow_smem(wgrad_f32_pipe, kPipeWgradSmem);
    if (attr != cudaSuccess) return (int)attr;
    const int t_tiles = (int)cdiv(T, PK);
    dim3 grid(cdiv(C, PM), cdiv(N, PWN), kw * splits);
    wgrad_f32_pipe<<<grid, P_THREADS, kPipeWgradSmem, stream>>>(
        (const float*)x, (const float*)dy, out, T, C, N, kw, dil, pl, t_tiles,
        B * t_tiles, per_split);
  }
  if (splits > 1) launch_sum_splits(part, dw, splits, (size_t)kw * C * N, stream);
  return (int)cudaGetLastError();
}

// Host nanoseconds of `reps` encodes of one bf16 tensor map (the forward's x
// map of a (64, 128, 512) tensor at p), or a negative error code.
extern "C" int dv3_conv_taps_encode_ns(const void* p, int reps) {
  CUtensorMap m;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    const int rc = encode_bf16(&m, p, 512, 128, 64, GK, GM);
    if (rc != 0) return -rc;
  }
  const auto t1 = std::chrono::steady_clock::now();
  return (int)std::chrono::duration_cast<std::chrono::nanoseconds>(t1 - t0)
      .count();
}

extern "C" const char* dv3_error_string(int e) {
  const char* s = encode_error_string(e);
  return s != nullptr ? s : cudaGetErrorString((cudaError_t)e);
}
