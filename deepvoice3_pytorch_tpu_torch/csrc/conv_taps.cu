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
// Design. Both are implicit GEMMs over the flattened B*T rows; a row's batch
// item and time are recomputed from its index, so a shifted tap never reads
// the neighbouring item.
//   * forward: M = B*T output rows, N output channels, K = kw*C walked tap by
//     tap. The weight operand is laid out (kw, N, C) ("out, in"), so each
//     tap's K runs contiguous in memory for both operands.
//   * wgrad:  M = C (one tap per grid z), N, K = the B*T rows. The TPU kernel
//     accumulates one (kw, C, N) block over a sequential grid; here blocks run
//     in parallel and in no order, so each block owns a (tap, C tile, N tile)
//     and loops over its share of the rows. When that gives too few blocks to
//     fill the card the rows are split into S contiguous ranges written to a
//     (S, kw, C, N) f32 workspace and summed in a fixed order by a second
//     pass. No atomics: the gradient is the same from run to run.
//   * f32 inputs: SIMT FMA in f32 (no TF32), 128 x 64 tiles, 8 x 4 outputs a
//     thread from shared memory.
//   * bf16 inputs: mma.sync m16n8k16 with f32 accumulation, 64 x 64 tiles,
//     four warps of 32 x 32; one rounding to bf16 at the store (forward) or an
//     f32 result (wgrad; the wrapper casts to the weight's type). The wgrad's
//     reduction over B*T rows is summed 32 rows at a time in the tensor cores
//     and across those tiles with f32 adds: measured on the H100, one mma
//     chain over 32768 rows drifted 4e-5 of the largest gradient from a
//     float64 sum, 80x the f32 plain version's error.
//   * bias is added in f32 in the forward epilogue.
//
// What bounds it. At the train step's shapes every one of these products has
// an arithmetic intensity far above the H100's ridge (about 295 FLOP/byte in
// bf16, 20 in f32), so the floor is the arithmetic rate: 67 TFLOP/s for f32
// FMA, 989 TFLOP/s for bf16 tensor cores. These are the simple forms: no
// cp.async/TMA pipelining and no wgmma, so they run well below either peak;
// making them fast is later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kFar = -(1 << 29);   // time of a row past the end: every tap misses

// ---------------------------------------------------------------------------
// f32: SIMT FMA
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
fwd_f32(const float* __restrict__ x, const float* __restrict__ wt,
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
wgrad_f32(const float* __restrict__ x, const float* __restrict__ dy,
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
// bf16: mma.sync m16n8k16, f32 accumulation
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
fwd_bf16(const bf16* __restrict__ x, const bf16* __restrict__ wt,
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
wgrad_bf16(const bf16* __restrict__ x, const bf16* __restrict__ dy,
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

unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }

}  // namespace

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
    fwd_bf16<<<grid, H_THREADS, 0, stream>>>(
        (const bf16*)x, (const bf16*)wt, bias, (bf16*)y, B, T, C, N, kw, dil,
        pl, vec);
  } else {
    dim3 grid(cdiv(M, FM), cdiv(N, FN));
    fwd_f32<<<grid, F_THREADS, 0, stream>>>((const float*)x, (const float*)wt,
                                            bias, (float*)y, B, T, C, N, kw,
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
    wgrad_bf16<<<grid, H_THREADS, 0, stream>>>(
        (const bf16*)x, (const bf16*)dy, out, B, T, C, N, kw, dil, pl,
        rows_per_split, vec_c, vec_n);
  } else {
    dim3 grid(cdiv(C, FM), cdiv(N, FN), kw * splits);
    wgrad_f32<<<grid, F_THREADS, 0, stream>>>((const float*)x,
                                              (const float*)dy, out, B, T, C,
                                              N, kw, dil, pl, rows_per_split);
  }
  if (splits > 1) {
    const size_t n = (size_t)kw * C * N;
    sum_splits<<<cdiv((long)n, 256), 256, 0, stream>>>(part, dw, splits, n);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* dv3_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
