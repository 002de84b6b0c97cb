// Momentum Griffin-Lim for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of deepvoice3_pytorch_tpu/dsp/gl_pallas.py
// (`_make_kernel`, launched by `griffin_lim_pallas`) with all its options,
// and the probe kernel of tools/gl_pallas2_probe.py (`make_gl2`), which is
// the same retrieval with the windows left out of the DFT matrices
// (`fold` = 0 here). It follows their numerics: the synthesis and analysis
// products take bf16 operands and accumulate in f32; overlap-add is f32
// times the pre-inverted normaliser; the re-framed signal is cast to bf16
// before analysis; momentum and the magnitude projection
// (rsqrt(a^2 + 1e-30)) run in f32 against the bf16 previous projection; the
// carries are stored in bf16; the SPSI increments are wrapped mod 2 pi
// before the frame cumsum.
//
// Windows. fold = 1 (gl_pallas's default): the windows are folded into the
// bf16 DFT matrices. fold = 0 (the probe's schedule): the matrices are the
// plain bf16 DFT, the synthesis window multiplies each frame chunk in f32
// before overlap-add, and the analysis window multiplies the f32 overlap-add
// signal as the analysis GEMM loads it, before the cast to bf16.
//
// Start. init = zero phase, SPSI, or a given (re, im) spectrum on which the
// magnitudes are re-imposed: c = bf16(i * S * rsqrt(i_re^2 + i_im^2 + 1e-30)).
// The first n_pinned frames of each item keep those start values through
// every iteration (the analysis epilogue writes them instead of the
// projection; the previous projection is still updated), so a streaming
// window stays consistent with audio already played. With spec_re/spec_im
// set, the final carry is returned de-interleaved as f32.
//
// Design. The TPU kernel keeps one item's whole retrieval in VMEM (about
// 13 MB at n = 600); that does not fit in an SM's 227 KB of shared memory,
// so here every iteration is a short sequence of launches over the whole
// batch, all issued by one call of `dv3_griffin_lim` on the caller's stream:
//   1. spsi_init: one thread per (item, bin), a sequential wrapped phase
//      cumsum over the frames (zero phase: the magnitudes); or given_init:
//      one thread per (frame, bin);
//   2. gemm<SYNTH>: frames (B*n, fft) f32 = carry (B*n, 2F) bf16 x inverse
//      DFT (2F, fft) bf16;
//   3. ola: sums the k = fft/hop overlapping chunks into y (B, n+k-1, hop),
//      times the inverse normaliser; one thread per output sample, so the
//      sum is deterministic (no atomics);
//   4. gemm<ANALYSIS>: reads frames straight from y (A[f, t] =
//      bf16(y_item[f*hop + t])) against the forward DFT, with momentum,
//      projection, pinning and the bf16 carry writes in its epilogue;
//   and after the last iteration a final gemm<SYNTH> + ola into the output,
//   then spec_out when the carry is returned.
// The spectra are stored with re/im interleaved per bin ((B*n, 2F) bf16),
// so the products need no concatenation and each thread of the analysis
// epilogue holds the (re, im) pair of a bin in adjacent accumulators.
//
// What bounds it. At LJSpeech shapes (B = 32, n = 400, F = 513, fft = 1024)
// each iteration is two GEMMs of about 28 GFLOP each, so the loop is bound by
// tensor-core throughput. The GEMMs here are the simple form: 64 x 64 tiles,
// four warps issuing mma.sync m16n8k16 bf16 from shared memory, no
// multi-stage pipelining; wgmma and TMA are later work. A streaming window
// at B = 1 (40 to 152 frames) gives each GEMM only 16 to 51 blocks on 132
// SMs, each walking the whole K = 1024 or 1056; measured on the H100, the
// device is busy for most of such a window's host time despite its ~100
// launches (PERF.md), so more blocks per GEMM (split K) come before a CUDA
// graph of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Field order and types match dsp/gl_cuda.py:_Args.
struct GriffinLimArgs {
  const float* S;              // (B, n, F) magnitudes
  const float* inorm;          // (n + k - 1, hop) inverse OLA normaliser
  const __nv_bfloat16* synT;   // (fft, Kp): row t, col 2f|2f+1 = inv re|im
  const __nv_bfloat16* anaT;   // (Np, fft): row 2f|2f+1 = fwd re|im
  const float* win;            // (fft) window, applied here when fold == 0
  const float* init_re;        // (B, n, F) given start (init == INIT_GIVEN)
  const float* init_im;
  __nv_bfloat16* c;            // (B*n, Kp) spectrum carry, pad columns zero
  __nv_bfloat16* tp;           // (B*n, 2F) previous projection carry
  __nv_bfloat16* pin;          // (B, n_pinned, 2F) pinned start values
  float* frames;               // (B*n, fft) scratch
  float* y;                    // (B, n + k - 1, hop) scratch
  float* out;                  // (B, n + k - 1, hop) waveform
  float* spec_re;              // (B, n, F) final carry, or null
  float* spec_im;
  int B, n, F, fft, hop, Kp, Np, n_iters, init, n_pinned, fold;
  float momentum, omega_scale; // omega_scale = 2 pi hop / fft
};

namespace {

constexpr int BM = 64, BN = 64, BK = 32, LDS = BK + 8;
constexpr int GEMM_THREADS = 128;
// at most 72 registers a thread, so that seven blocks fit on an SM: left
// alone, ptxas gave the synthesis GEMM 80 registers, six blocks per SM, and
// the 3200 blocks of a (32 x 400)-row synthesis a fifth, nearly empty wave
// (PERF.md)
constexpr int GEMM_MIN_BLOCKS = 7;
enum { SYNTH = 0, ANALYSIS = 1 };
enum { INIT_ZERO = 0, INIT_SPSI = 1, INIT_GIVEN = 2 };  // dsp/gl_cuda.py

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void spsi_init(const GriffinLimArgs a) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= a.B * a.F) return;
  const int b = idx / a.F, bin = idx % a.F;
  const float two_pi = 6.28318530717958647692f;
  float phi = 0.0f;
  for (int f = 0; f < a.n; ++f) {
    const size_t m_row = (size_t)b * a.n + f;
    const float* row = a.S + m_row * a.F;
    const float m = row[bin];
    float re = m, im = 0.0f;
    if (a.init == INIT_SPSI) {
      const float left = bin > 0 ? row[bin - 1] : m;
      const float right = bin < a.F - 1 ? row[bin + 1] : m;
      const float denom = left - 2.0f * m + right;
      float p = fabsf(denom) > 1e-12f ? 0.5f * (left - right) / denom : 0.0f;
      p = fminf(fmaxf(p, -0.5f), 0.5f);
      float om = a.omega_scale * ((float)bin + p);
      om = om - two_pi * floorf(om / two_pi);
      phi += om;
      re = m * cosf(phi);
      im = m * sinf(phi);
    }
    *reinterpret_cast<uint32_t*>(a.c + m_row * a.Kp + 2 * bin) =
        pack_bf16(re, im);
  }
}

// one thread per (row, bin): re-impose S on the given start; pinned frames
// keep a copy, because c is overwritten every iteration
__global__ void given_init(const GriffinLimArgs a) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)a.B * a.n * a.F) return;
  const size_t m_row = idx / a.F;
  const int bin = idx % a.F;
  const float re = a.init_re[idx], im = a.init_im[idx];
  const float scale = a.S[idx] * rsqrtf(re * re + im * im + 1e-30f);
  const uint32_t v = pack_bf16(re * scale, im * scale);
  *reinterpret_cast<uint32_t*>(a.c + m_row * a.Kp + 2 * bin) = v;
  const int f = m_row % a.n;
  if (f < a.n_pinned)
    *reinterpret_cast<uint32_t*>(
        a.pin + ((m_row / a.n) * a.n_pinned + f) * 2 * a.F + 2 * bin) = v;
}

// the final carry, de-interleaved to f32 (B, n, F) re and im
__global__ void spec_out(const GriffinLimArgs a) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)a.B * a.n * a.F) return;
  const size_t m_row = idx / a.F;
  const int bin = idx % a.F;
  const __nv_bfloat162 v =
      *reinterpret_cast<const __nv_bfloat162*>(a.c + m_row * a.Kp + 2 * bin);
  a.spec_re[idx] = __low2float(v);
  a.spec_im[idx] = __high2float(v);
}

// FOLD = 0: the analysis window multiplies the A operand (unfolded mode)
template <int MODE, bool FOLD = true>
__global__ void __launch_bounds__(GEMM_THREADS, GEMM_MIN_BLOCKS)
    gemm(const GriffinLimArgs a) {
  __shared__ __align__(16) __nv_bfloat16 As[BM][LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[BN][LDS];
  const int M = a.B * a.n;
  const int K = MODE == SYNTH ? a.Kp : a.fft;
  const __nv_bfloat16* BT = MODE == SYNTH ? a.synT : a.anaT;
  const int nb = a.n + a.fft / a.hop - 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp >> 1, wn = warp & 1, g = lane >> 2, tg = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK / 8; i += GEMM_THREADS) {
      const int r = i >> 2, c8 = (i & 3) * 8, m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) {
        if (MODE == SYNTH) {
          v = *reinterpret_cast<const uint4*>(a.c + (size_t)m * a.Kp + k0 +
                                              c8);
        } else {
          // frame f of item b is y_b[f*hop : f*hop + fft]
          const int b = m / a.n, f = m % a.n;
          const float* src =
              a.y + ((size_t)b * nb + f) * a.hop + k0 + c8;
          float4 lo = *reinterpret_cast<const float4*>(src);
          float4 hi = *reinterpret_cast<const float4*>(src + 4);
          if (!FOLD) {  // analysis window in f32, then the bf16 cast
            const float4 wl = *reinterpret_cast<const float4*>(a.win + k0 + c8);
            const float4 wh =
                *reinterpret_cast<const float4*>(a.win + k0 + c8 + 4);
            lo = make_float4(lo.x * wl.x, lo.y * wl.y, lo.z * wl.z,
                             lo.w * wl.w);
            hi = make_float4(hi.x * wh.x, hi.y * wh.y, hi.z * wh.z,
                             hi.w * wh.w);
          }
          v = make_uint4(pack_bf16(lo.x, lo.y), pack_bf16(lo.z, lo.w),
                         pack_bf16(hi.x, hi.y), pack_bf16(hi.z, hi.w));
        }
      }
      *reinterpret_cast<uint4*>(&As[r][c8]) = v;
    }
    for (int i = tid; i < BN * BK / 8; i += GEMM_THREADS) {
      const int r = i >> 2, c8 = (i & 3) * 8;
      *reinterpret_cast<uint4*>(&Bs[r][c8]) = *reinterpret_cast<const uint4*>(
          BT + (size_t)(n0 + r) * K + k0 + c8);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
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

  // accumulator (mi, ni, h): row m0 + wm*32 + mi*16 + g + 8h,
  // columns col, col + 1 with col = n0 + wn*32 + ni*8 + 2*tg
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * tg;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * h;
        if (row >= M) continue;
        const float v0 = acc[mi][ni][2 * h], v1 = acc[mi][ni][2 * h + 1];
        if (MODE == SYNTH) {
          *reinterpret_cast<float2*>(a.frames + (size_t)row * a.fft + col) =
              make_float2(v0, v1);
        } else {
          const int bin = col >> 1;
          if (bin >= a.F) continue;
          // v0, v1 = re, im of the re-analysed frame
          const float mag = a.S[(size_t)row * a.F + bin];
          __nv_bfloat16* tp = a.tp + (size_t)row * 2 * a.F + 2 * bin;
          const __nv_bfloat162 prev = *reinterpret_cast<__nv_bfloat162*>(tp);
          const float ar = v0 + a.momentum * (v0 - __low2float(prev));
          const float ai = v1 + a.momentum * (v1 - __high2float(prev));
          const float scale = mag * rsqrtf(ar * ar + ai * ai + 1e-30f);
          uint32_t cv = pack_bf16(ar * scale, ai * scale);
          // already-played frame: keep its start value
          if (a.n_pinned && row % a.n < a.n_pinned)
            cv = *reinterpret_cast<const uint32_t*>(
                a.pin + ((size_t)(row / a.n) * a.n_pinned + row % a.n) * 2 *
                            a.F + 2 * bin);
          *reinterpret_cast<uint32_t*>(a.c + (size_t)row * a.Kp + 2 * bin) =
              cv;
          *reinterpret_cast<uint32_t*>(tp) = pack_bf16(v0, v1);
        }
      }
    }
  }
}

__global__ void ola(const GriffinLimArgs a, float* dst) {
  const int k = a.fft / a.hop, nb = a.n + k - 1;
  const size_t total = (size_t)a.B * nb * a.hop;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int j = idx % a.hop;
  const int r = (idx / a.hop) % nb;
  const int b = idx / ((size_t)a.hop * nb);
  float acc = 0.0f;
  for (int c = 0; c < k; ++c) {
    const int f = r - c;
    if (f < 0 || f >= a.n) continue;
    const float v = a.frames[((size_t)b * a.n + f) * a.fft + c * a.hop + j];
    // unfolded: synthesis window in f32, rounded before the sum (no FMA)
    acc += a.fold ? v : __fmul_rn(v, a.win[c * a.hop + j]);
  }
  dst[idx] = acc * a.inorm[r * a.hop + j];
}

}  // namespace

extern "C" int dv3_griffin_lim(const GriffinLimArgs* args, void* stream_ptr,
                               int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const GriffinLimArgs a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int M = a.B * a.n;
  const int nb = a.n + a.fft / a.hop - 1;
  const dim3 synth_grid((M + BM - 1) / BM, a.fft / BN);
  const dim3 ana_grid((M + BM - 1) / BM, a.Np / BN);
  const size_t ola_total = (size_t)a.B * nb * a.hop;
  const int ola_blocks = (int)((ola_total + 255) / 256);
  const int bin_blocks = (int)(((size_t)M * a.F + 255) / 256);

  if (a.init == INIT_GIVEN)
    given_init<<<bin_blocks, 256, 0, stream>>>(a);
  else
    spsi_init<<<(a.B * a.F + 255) / 256, 256, 0, stream>>>(a);
  for (int it = 0; it < a.n_iters; ++it) {
    gemm<SYNTH><<<synth_grid, GEMM_THREADS, 0, stream>>>(a);
    ola<<<ola_blocks, 256, 0, stream>>>(a, a.y);
    if (a.fold)
      gemm<ANALYSIS, true><<<ana_grid, GEMM_THREADS, 0, stream>>>(a);
    else
      gemm<ANALYSIS, false><<<ana_grid, GEMM_THREADS, 0, stream>>>(a);
  }
  gemm<SYNTH><<<synth_grid, GEMM_THREADS, 0, stream>>>(a);
  ola<<<ola_blocks, 256, 0, stream>>>(a, a.out);
  if (a.spec_re != nullptr) spec_out<<<bin_blocks, 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* dv3_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
