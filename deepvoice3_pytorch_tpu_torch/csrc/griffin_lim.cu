// Momentum Griffin-Lim for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of deepvoice3_pytorch_tpu/dsp/gl_pallas.py
// (`_make_kernel`, launched by `griffin_lim_pallas`) with all its options,
// and the probe kernel of tools/gl_pallas2_probe.py (`make_gl2`), which is
// the same retrieval with the windows left out of the DFT matrices
// (`fold` = 0 here). It follows their numerics: the synthesis and analysis
// products take bf16 operands and accumulate in f32; overlap-add is f32
// times the pre-inverted normaliser; the re-framed signal is cast to bf16
// before analysis (after the f32 analysis window when unfolded); momentum
// and the magnitude projection (rsqrt(a^2 + 1e-30)) run in f32 against the
// bf16 previous projection; the carries are stored in bf16; the SPSI
// increments are wrapped mod 2 pi before the frame cumsum, which
// accumulates in f64.
//
// Windows. fold = 1 (gl_pallas's default): the windows are folded into the
// bf16 DFT matrices. fold = 0 (the probe's schedule): the matrices are the
// plain bf16 DFT, the synthesis window multiplies each frame chunk in f32
// before overlap-add, and the analysis window multiplies the f32 overlap-add
// signal before the cast to bf16.
//
// Start. init = zero phase; SPSI; a given (re, im) spectrum on which the
// magnitudes are re-imposed, c = bf16(i * S * rsqrt(i_re^2 + i_im^2 +
// 1e-30)); or anchored, the start of a streaming window: its first n_pinned
// frames take the previous window's retrieved spectrum (init_re / init_im,
// item stride init_stride) and the later ones the SPSI phase shifted per
// bin by atan2(im, re) of the last context frame minus the SPSI phase
// there, both with the magnitudes re-imposed (streaming.gl_window's start,
// formerly built from eager ops around the call). The first n_pinned frames
// of each item keep their start values through every iteration (the
// analysis epilogue writes them instead of the projection; the previous
// projection is still updated), so a streaming window stays consistent with
// audio already played. With spec_re/spec_im set, the final carry is
// returned de-interleaved as f32.
//
// Layout. M = B*n frames. The spectra are (M, 2F) bf16 with re/im
// interleaved per bin, rows Kp apart, so that each thread of the analysis
// epilogue holds the (re, im) pair of a bin in adjacent accumulators. An
// iteration is three steps:
//   1. synthesis GEMM: frames (M, fs) f32 = carry (M, 2F) x synT^T, synT
//      (fft, 2F) the inverse DFT transposed (K-major);
//   2. overlap-add: one thread per 4 output samples (per sample when hop %
//      4 != 0) sums the k = fft/hop overlapping chunks in chunk order, four
//      chunk loads in flight at a time (any k; k <= 4 with hop % 4 == 0,
//      the usual fft / 4 hop, in kernels of their own), times the inverse
//      normaliser, and writes the bf16 re-framed signal a16
//      (M, fs): a16[b*n + f, c*hop + j] = bf16(y_b[f + c, j]) (times the
//      window in f32 first when unfolded), so that the analysis is a plain
//      GEMM for any hop;
//   3. analysis GEMM: a16 x anaT^T, anaT (2F, fft) the forward DFT, with
//      momentum, projection, pinning and the two bf16 carry writes in its
//      epilogue.
// A start step precedes the first iteration, and a last synthesis and
// overlap-add into the f32 waveform (with the returned spectrum) follows the
// last. No sum uses atomics: two runs of a call are bit-equal.
//
// Shapes. Any hop that divides fft (the Pallas kernel's own rule). frames
// and a16 rows are fs = fft rounded up to 64 apart (16-byte TMA rows for any
// fft); the synthesis tiles past fft read zero-filled rows of synT and
// write zeros that nothing reads, and the analysis reads a16 and anaT
// (rows fft rounded up to 8 apart) with their true K extent, fft, so TMA's
// zero fill covers the K tail of both.
//
// What bounds it. At LJSpeech shapes (B = 32, n = 400, F = 513, fft = 1024)
// each iteration is two GEMMs of about 28 GFLOP each: the bf16 tensor cores
// bound it. A streaming or serving window (40 to 1240 rows) is bound by
// latency: its GEMMs are tens of MFLOP, and every output tile needs the
// window's whole K of both operands brought into one SM.
//
// Design. Both GEMMs are TMA + wgmma, warp specialised (hopper.cuh): one
// producer warp keeps cp.async.bulk.tensor loads of 64-deep K stages in
// flight on an mbarrier ring, 128-byte swizzle; consumer warpgroups run
// wgmma.mma_async on the stages that have arrived. The tensor maps read the
// 2F-wide spectra with their true width, so TMA's zero fill makes the K and
// N tails free and no pad column is ever read. Two routes, chosen from the
// shape by dsp/gl_cuda.py:gl_plan:
//   * batch (B*n fills the card with 128-row tiles): one launch per step,
//     two consumer warpgroups on 128 x 256 synthesis tiles (m64n256) and
//     128 x 208 analysis tiles (m64n208: 5 tiles cover the 1026 columns),
//     4-stage rings (clusters of two CTAs sharing their B tile by TMA
//     multicast, and two CTAs an SM on 128 x 128 / 128 x 104 tiles,
//     measured slower on the H100);
//   * window: the whole retrieval in ONE cooperative launch of a persistent
//     kernel (every block co-resident; grid sized from the occupancy), one
//     consumer warpgroup on 64-row tiles 32 or 64 columns wide, or two on
//     128 x 128 tiles for the larger windows. Neither GEMM is split along
//     K: the partial sums cost more than the idle SMs they would fill. A
//     grid barrier separates the steps; it traps after ten seconds, like
//     the mbarrier waits, rather than hang the card. The epilogues' generic
//     stores are read by the next step's TMA loads (the async proxy), so
//     each barrier is fenced with fence.proxy.async; data written during
//     the launch is read with ld.global.cg (L2), never through a stale L1.
//     The same kernel also runs one launch per step (one_launch = 0): a
//     CUDA graph of those launches measured no faster than the one launch.
// The start, overlap-add and returned-spectrum steps are plain one-thread-
// per-element code: a few percent of a call.

#include <algorithm>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

// Field order and types match dsp/gl_cuda.py:_Args.
struct GriffinLimArgs {
  const float* S;              // (B, n, F) magnitudes
  const float* inorm;          // (n + k - 1, hop) inverse OLA normaliser
  const bf16* synT;            // (fft, Kp): row t, col 2f|2f+1 = inv re|im
  const bf16* anaT;            // (2F, fft8): row 2f|2f+1 = fwd re|im,
                               //   fft8 = fft rounded up to 8
  const float* win;            // (fft) window, applied here when fold == 0
  const float* init_re;        // given: (B, n, F); anchored: (B, n_pinned, F)
  const float* init_im;        //   context, items init_stride apart
  bf16* c;                     // (M, Kp) spectrum carry
  bf16* tp;                    // (M, 2F) previous projection carry
  bf16* pin;                   // (B, n_pinned, 2F) pinned start values
  float* frames;               // (M, fs) synthesised frames
  bf16* a16;                   // (M, fs) re-framed signal for the analysis
  float* out;                  // (B, n + k - 1, hop) waveform
  float* spec_re;              // (B, n, F) final carry, or null
  float* spec_im;
  unsigned* sync;              // window route, one launch: 2 counters, zero
  unsigned long long* trace;   // window route: (steps + 1, 1024, 2) stamps,
                               //   or null (see gl_window)
  long long init_stride;       // elements between items of init_re / init_im
  int B, n, F, fft, hop, Kp, fs, n_iters, init, n_pinned, fold;
  int route, bm, bn, one_launch;
  float momentum, omega_scale; // omega_scale = 2 pi hop / fft
};

namespace {

constexpr int GK = 64;        // K per stage: 64 bf16, one 128-byte row
constexpr int BATCH_BM = 128, BATCH_THREADS = 288;   // 2 warpgroups + producer
constexpr int BATCH_BN_SYN = 256, BATCH_BN_ANA = 208;
constexpr int BATCH_STAGES = 4;
// The window route's tiles: 64 rows (one consumer warpgroup) 32 or 64
// columns wide, or 128 x 128 (two) for the larger windows, where it
// measured fastest (narrow tiles re-read the window's rows once per column
// tile). The ring holds all or most of a tile's 16-17 K-stages: 16 stages
// of 12 KB at 32 columns (one block an SM), 6 of 16 KB at 64 (two blocks
// an SM: their tiles outnumber the SMs), 6 of 32 KB at 128 x 128 (one).
template <int NWG>
__host__ __device__ constexpr int win_threads() { return 128 * NWG + 32; }
template <int BN>
__host__ __device__ constexpr int win_stages() {
  return BN == 32 ? 16 : 6;
}
template <int BN>
__host__ __device__ constexpr int win_blocks() { return BN == 64 ? 2 : 1; }
constexpr int TRACE_BLOCKS = 1024;   // trace stamps kept for blocks below
enum { SYNTH = 0, ANALYSIS = 1 };
enum { INIT_ZERO = 0, INIT_SPSI = 1, INIT_GIVEN = 2, INIT_ANCHORED = 3 };
enum { ROUTE_BATCH = 0, ROUTE_WINDOW = 1 };          // dsp/gl_cuda.py

__host__ __device__ constexpr uint32_t stage_bytes(int bm, int bn) {
  return (bm + bn) * GK * 2;
}
constexpr size_t ring_smem(int stages, int bm, int bn) {
  return (size_t)stages * stage_bytes(bm, bn) + 2 * stages * 8 + 1024;
}

unsigned cdiv(long a, long b) { return (unsigned)((a + b - 1) / b); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ __nv_bfloat162 unpack_bf16(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}

// a 32-bit (re, im) pair written earlier in this launch, read from L2
__device__ __forceinline__ uint32_t ldcg_pair(const bf16* p) {
  return __ldcg(reinterpret_cast<const unsigned int*>(p));
}

// ---------------------------------------------------------------------------
// start, overlap-add, returned spectrum: one thread per element
// ---------------------------------------------------------------------------

// The start is the plain version's (gl_cuda.py) as torch computes it on the
// card, operation by operation and bit for bit: each operation rounded once
// (no contraction into FMAs), the same cosf / sinf / atan2f / rsqrtf, and
// the SPSI phase the cumsum of the wrapped increments accumulated in f64 and
// rounded per frame (stft.spsi_phase). The start is pinned or fed back to
// the next window, and Griffin-Lim amplifies a bf16 rounding that differs
// there into the whole streamed signal.
__device__ __forceinline__ uint32_t reimpose(float m, float re, float im) {
  const float ss = __fadd_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)),
                             1e-30f);
  const float scale = __fmul_rn(m, rsqrtf(ss));
  return pack_bf16(__fmul_rn(re, scale), __fmul_rn(im, scale));
}

// zero, SPSI or anchored start of one (item, bin): the SPSI phase is a
// cumsum over the frames, so one thread walks them in order
__device__ void init_sequential(const GriffinLimArgs& a, int b, int bin) {
  const float two_pi = 6.28318530717958647692f;
  const int F2 = 2 * a.F;
  double phi_sum = 0.0;
  float delta = 0.0f;
  for (int f = 0; f < a.n; ++f) {
    const size_t m_row = (size_t)b * a.n + f;
    const float* row = a.S + m_row * a.F;
    const float m = row[bin];
    uint32_t v = pack_bf16(m, 0.0f);
    if (a.init != INIT_ZERO) {
      const float left = bin > 0 ? row[bin - 1] : m;
      const float right = bin < a.F - 1 ? row[bin + 1] : m;
      const float denom = __fadd_rn(__fsub_rn(left, __fmul_rn(2.0f, m)),
                                    right);
      float p = fabsf(denom) > 1e-12f
                    ? __fdiv_rn(__fmul_rn(0.5f, __fsub_rn(left, right)), denom)
                    : 0.0f;
      p = fminf(fmaxf(p, -0.5f), 0.5f);
      float om = __fmul_rn(a.omega_scale, __fadd_rn((float)bin, p));
      om = __fsub_rn(om, __fmul_rn(two_pi, floorf(__fdiv_rn(om, two_pi))));
      phi_sum += (double)om;
      const float phi = (float)phi_sum;
      if (a.init == INIT_SPSI) {
        v = pack_bf16(__fmul_rn(m, cosf(phi)), __fmul_rn(m, sinf(phi)));
      } else if (f < a.n_pinned) {   // anchored, a context frame
        const size_t ci = (size_t)b * a.init_stride + (size_t)f * a.F + bin;
        const float re = a.init_re[ci], im = a.init_im[ci];
        if (f == a.n_pinned - 1) delta = __fsub_rn(atan2f(im, re), phi);
        v = reimpose(m, re, im);
      } else {                         // anchored, a later frame
        const float ph = __fadd_rn(phi, delta);
        v = reimpose(m, __fmul_rn(m, cosf(ph)), __fmul_rn(m, sinf(ph)));
      }
    }
    *reinterpret_cast<uint32_t*>(a.c + m_row * a.Kp + 2 * bin) = v;
    if (f < a.n_pinned)
      *reinterpret_cast<uint32_t*>(
          a.pin + ((size_t)b * a.n_pinned + f) * F2 + 2 * bin) = v;
    *reinterpret_cast<uint32_t*>(a.tp + m_row * F2 + 2 * bin) = 0u;
  }
}

// given start of one (row, bin): re-impose S; pinned frames keep a copy,
// because c is overwritten every iteration
__device__ void init_given(const GriffinLimArgs& a, unsigned idx) {
  const unsigned m_row = idx / a.F;
  const int bin = idx - m_row * a.F, F2 = 2 * a.F;
  const uint32_t v = reimpose(a.S[idx], a.init_re[idx], a.init_im[idx]);
  *reinterpret_cast<uint32_t*>(a.c + (size_t)m_row * a.Kp + 2 * bin) = v;
  const int f = m_row % a.n;
  if (f < a.n_pinned)
    *reinterpret_cast<uint32_t*>(
        a.pin + ((size_t)(m_row / a.n) * a.n_pinned + f) * F2 + 2 * bin) = v;
  *reinterpret_cast<uint32_t*>(a.tp + (size_t)m_row * F2 + 2 * bin) = 0u;
}

// 32-bit indices: the wrapper keeps every plane below 2^31 elements
__device__ __forceinline__ void init_elem(const GriffinLimArgs& a,
                                          unsigned idx) {
  if (a.init == INIT_GIVEN) {
    if (idx < (unsigned)(a.B * a.n * a.F)) init_given(a, idx);
  } else if (idx < (unsigned)(a.B * a.F)) {
    init_sequential(a, idx / a.F, idx % a.F);
  }
}

// Overlap-add, the k <= 4 path (hop % 4 == 0, k = fft / hop <= KMAX, the
// shapes of fft / 4 hops): one thread per 4 output samples q .. of (B, n + k
// - 1, hop); ola_load issues the k chunk loads, ola_store sums them in chunk
// order, times the inverse normaliser, into the waveform (final) or into
// the bf16 re-framed copies of a16. Its register arrays are sized for k <=
// 4; ola_units below takes every other framing.
constexpr int KMAX = 4;
struct OlaPos {
  int j, r, b;
};

__device__ __forceinline__ OlaPos ola_pos4(const GriffinLimArgs& a,
                                           unsigned q) {
  const int nb = a.n + a.fft / a.hop - 1, hq = a.hop / 4;
  const unsigned row = q / hq, rb = row / nb;
  return {4 * (int)(q - row * hq), (int)(row - rb * nb), (int)rb};
}

__device__ __forceinline__ void ola_load4(const GriffinLimArgs& a, OlaPos o,
                                          float4 (&v)[KMAX]) {
  const int k = a.fft / a.hop;
  // frame r - c, chunk c
  const float* src = a.frames + ((size_t)o.b * a.n + o.r) * a.fs + o.j;
#pragma unroll
  for (int c = 0; c < KMAX; ++c)
    if (c < k && o.r - c >= 0 && o.r - c < a.n)
      v[c] = __ldcg(reinterpret_cast<const float4*>(
          src - (size_t)c * a.fs + c * a.hop));
}

__device__ __forceinline__ float4 mul4(float4 x, float4 w) {
  return make_float4(__fmul_rn(x.x, w.x), __fmul_rn(x.y, w.y),
                     __fmul_rn(x.z, w.z), __fmul_rn(x.w, w.w));
}

__device__ __forceinline__ void ola_store4(const GriffinLimArgs& a,
                                           unsigned q, OlaPos o,
                                           const float4 (&v)[KMAX],
                                           bool final) {
  const int k = a.fft / a.hop;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    if (c >= k || o.r - c < 0 || o.r - c >= a.n) continue;
    // unfolded: synthesis window in f32, rounded before the sum (no FMA)
    const float4 x =
        a.fold ? v[c]
               : mul4(v[c], *reinterpret_cast<const float4*>(a.win + c * a.hop +
                                                             o.j));
    acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
  }
  const float4 y = mul4(
      acc, *reinterpret_cast<const float4*>(a.inorm + o.r * a.hop + o.j));
  if (final) {
    *reinterpret_cast<float4*>(a.out + 4 * (size_t)q) = y;
    return;
  }
#pragma unroll
  for (int c = 0; c < KMAX; ++c) {
    const int f = o.r - c;
    if (c >= k || f < 0 || f >= a.n) continue;
    // unfolded: analysis window in f32, then the bf16 cast
    const float4 z = a.fold ? y : mul4(y, *reinterpret_cast<const float4*>(
                                              a.win + c * a.hop + o.j));
    *reinterpret_cast<uint2*>(
        a.a16 + ((size_t)o.b * a.n + f) * a.fs + c * a.hop + o.j) =
        make_uint2(pack_bf16(z.x, z.y), pack_bf16(z.z, z.w));
  }
}

// quads first, first + stride, ... below quads, Q at a time: all their
// loads issued before any sum, so a thread waits on memory once per Q
template <int Q>
__device__ __forceinline__ void ola_quads4(const GriffinLimArgs& a,
                                           unsigned first, unsigned stride,
                                           unsigned quads, bool final) {
  for (unsigned q0 = first; q0 < quads; q0 += Q * stride) {
    float4 v[Q][KMAX];
    OlaPos o[Q];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const unsigned q = q0 + u * stride;
      if (q >= quads) continue;
      o[u] = ola_pos4(a, q);
      ola_load4(a, o[u], v[u]);
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const unsigned q = q0 + u * stride;
      if (q < quads) ola_store4(a, q, o[u], v[u], final);
    }
  }
}

// Overlap-add, every other framing: output samples V q .. V q + V - 1 of
// (B, n + k - 1, hop), k = fft / hop any size: V = 4 (float4 loads and
// stores, 16-byte aligned) when hop % 4 == 0, else V = 1. The k
// overlapping chunks are loaded KG at a time, all of a group's loads issued
// before any sum, and summed in chunk order (the plain version's order);
// the sum times the inverse normaliser goes into the waveform (final) or
// into the bf16 re-framed copies of a16.
constexpr int KG = 4;

template <int V>
__device__ __forceinline__ OlaPos ola_pos(const GriffinLimArgs& a,
                                          unsigned q) {
  const int nb = a.n + a.fft / a.hop - 1, hq = a.hop / V;
  const unsigned row = q / hq, rb = row / nb;
  return {V * (int)(q - row * hq), (int)(row - rb * nb), (int)rb};
}

// V floats at p: written earlier in this launch (L2) or constant
template <int V>
__device__ __forceinline__ void ld_cg(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = __ldcg(p);
  }
}

template <int V>
__device__ __forceinline__ void ld_const(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

// y = x times the f32 window (inorm or win) at p, each product rounded once
template <int V>
__device__ __forceinline__ void mul_const(const float (&x)[V], const float* p,
                                          float (&y)[V]) {
  float w[V];
  ld_const<V>(p, w);
#pragma unroll
  for (int i = 0; i < V; ++i) y[i] = __fmul_rn(x[i], w[i]);
}

template <int V>
__device__ __forceinline__ void ola_store(const GriffinLimArgs& a, unsigned q,
                                          OlaPos o, const float (&acc)[V],
                                          bool final) {
  float y[V];
  mul_const<V>(acc, a.inorm + o.r * a.hop + o.j, y);
  if (final) {
    float* dst = a.out + (size_t)V * q;
    if constexpr (V == 4)
      *reinterpret_cast<float4*>(dst) = make_float4(y[0], y[1], y[2], y[3]);
    else
      *dst = y[0];
    return;
  }
  const int k = a.fft / a.hop;
  const int c_lo = max(0, o.r - a.n + 1), c_hi = min(k - 1, o.r);
  for (int c = c_lo; c <= c_hi; ++c) {
    const int f = o.r - c;
    // unfolded: analysis window in f32, then the bf16 cast
    float z[V];
    if (a.fold) {
#pragma unroll
      for (int i = 0; i < V; ++i) z[i] = y[i];
    } else {
      mul_const<V>(y, a.win + c * a.hop + o.j, z);
    }
    bf16* dst = a.a16 + ((size_t)o.b * a.n + f) * a.fs + c * a.hop + o.j;
    if constexpr (V == 4)
      *reinterpret_cast<uint2*>(dst) =
          make_uint2(pack_bf16(z[0], z[1]), pack_bf16(z[2], z[3]));
    else
      *dst = __float2bfloat16_rn(z[0]);
  }
}

// units first, first + stride, ... below units, Q at a time: each group of
// KG chunks of all Q units loaded before any of them is summed, so a thread
// waits on memory once per group
template <int Q, int V>
__device__ __forceinline__ void ola_units(const GriffinLimArgs& a,
                                          unsigned first, unsigned stride,
                                          unsigned units, bool final) {
  const int k = a.fft / a.hop;
  for (unsigned q0 = first; q0 < units; q0 += Q * stride) {
    OlaPos o[Q];
    float acc[Q][V];
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const unsigned q = q0 + u * stride;
      o[u] = q < units ? ola_pos<V>(a, q) : OlaPos{0, -k, 0};
#pragma unroll
      for (int i = 0; i < V; ++i) acc[u][i] = 0.0f;
    }
    for (int c0 = 0; c0 < k; c0 += KG) {
      float v[Q][KG][V];
#pragma unroll
      for (int u = 0; u < Q; ++u) {
        // frame r - c, chunk c
        const float* src =
            a.frames + ((size_t)o[u].b * a.n + o[u].r) * a.fs + o[u].j;
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          const int c = c0 + g, f = o[u].r - c;
          if (c < k && f >= 0 && f < a.n)
            ld_cg<V>(src - (size_t)c * a.fs + c * a.hop, v[u][g]);
        }
      }
#pragma unroll
      for (int u = 0; u < Q; ++u) {
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          const int c = c0 + g, f = o[u].r - c;
          if (c >= k || f < 0 || f >= a.n) continue;
          // unfolded: synthesis window in f32, rounded before the sum
          float x[V];
          if (a.fold) {
#pragma unroll
            for (int i = 0; i < V; ++i) x[i] = v[u][g][i];
          } else {
            mul_const<V>(v[u][g], a.win + c * a.hop + o[u].j, x);
          }
#pragma unroll
          for (int i = 0; i < V; ++i) acc[u][i] = __fadd_rn(acc[u][i], x[i]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < Q; ++u) {
      const unsigned q = q0 + u * stride;
      if (q < units) ola_store<V>(a, q, o[u], acc[u], final);
    }
  }
}

// Which overlap-add a kernel compiles: ANY = false the k <= 4 path, true
// the general one. They are separate instantiations of the kernels that
// run them: compiled into one persistent window kernel, the general path's
// registers spilled its k <= 4 path and GEMM tiles (an (8, 152) x 32
// window measured 1.21-1.37 -> 1.48-1.76 ms on the H100, inlined or
// called).
__host__ __device__ constexpr bool ola_any(int fft, int hop) {
  return hop % 4 != 0 || fft / hop > KMAX;
}

// the overlap-add step over the whole batch, threads first, first + stride
template <bool ANY>
__device__ __forceinline__ void ola_step(const GriffinLimArgs& a,
                                         unsigned first, unsigned stride,
                                         bool final) {
  const unsigned samples = a.B * (a.n + a.fft / a.hop - 1) * a.hop;
  if constexpr (!ANY)
    ola_quads4<2>(a, first, stride, samples / 4, final);
  else if (a.hop % 4 == 0)
    ola_units<2, 4>(a, first, stride, samples / 4, final);
  else
    ola_units<4, 1>(a, first, stride, samples, final);
}

// the final carry of (row, bin), de-interleaved to f32
__device__ __forceinline__ void spec_elem(const GriffinLimArgs& a,
                                          unsigned idx) {
  const unsigned m_row = idx / a.F;
  const int bin = idx - m_row * a.F;
  const __nv_bfloat162 v =
      unpack_bf16(ldcg_pair(a.c + (size_t)m_row * a.Kp + 2 * bin));
  a.spec_re[idx] = __low2float(v);
  a.spec_im[idx] = __high2float(v);
}

// ---------------------------------------------------------------------------
// GEMM pieces: producer, consumer warpgroup, epilogues
// ---------------------------------------------------------------------------

// K-steps [kb, ke) of one tile: A box (64, BM) at (k, m0) of ma, B box
// (64, BN) at (k, n0) of mb, into the ring's stages
template <int STAGES>
__device__ __forceinline__ void produce(const Ring& ring, int& s, uint32_t& ph,
                                        const CUtensorMap* ma,
                                        const CUtensorMap* mb, int m0, int n0,
                                        int kb, int ke, uint32_t b_off,
                                        uint32_t bytes) {
  for (int ks = kb; ks < ke; ++ks) {
    mbar_wait(ring.empty + 8 * s, ph ^ 1);
    const uint32_t bar = ring.full + 8 * s, st = ring.stage(s);
    mbar_expect_tx(bar, bytes);
    tma_load_3d(st, ma, bar, ks * GK, m0, 0);
    tma_load_3d(st + b_off, mb, bar, ks * GK, n0, 0);
    if (++s == STAGES) { s = 0; ph ^= 1; }
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_kmajor(float (&d)[BN / 2], uint64_t da,
                                             uint64_t db) {
  if constexpr (BN == 32)
    wgmma_m64n32k16<0>(d, da, db, 1);
  else if constexpr (BN == 64)
    wgmma_m64n64k16<0>(d, da, db, 1);
  else if constexpr (BN == 128)
    wgmma_m64n128k16<0, 0>(d, da, db, 1);
  else if constexpr (BN == 208)
    wgmma_m64n208k16<0>(d, da, db, 1);
  else
    wgmma_m64n256k16<0>(d, da, db, 1);
}

// acc += A B over nk stages of the ring: this warpgroup's 64 rows of A at
// a_off in each stage, the whole B tile at b_off; every stage is released
// once read, the last one too (a persistent block reuses the ring)
template <int BN, int STAGES>
__device__ __forceinline__ void consume(float (&acc)[BN / 2], const Ring& ring,
                                        int& s, uint32_t& ph, int nk,
                                        uint32_t a_off, uint32_t b_off,
                                        int lane) {
  int prev = -1;
  for (int it = 0; it < nk; ++it) {
    mbar_wait(ring.full + 8 * s, ph);
    const uint32_t st = ring.stage(s);
    wgmma_fence();
    fence_acc(acc);
#pragma unroll
    for (int k = 0; k < GK / 16; ++k)
      wgmma_kmajor<BN>(acc, sw128_desc(st + a_off + 32 * k, 0, 1024),
                       sw128_desc(st + b_off + 32 * k, 0, 1024));
    wgmma_commit();
    wgmma_wait<1>();   // the stage before this one is read: release it
    fence_acc(acc);
    if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + 8 * prev);
    prev = s;
    if (++s == STAGES) { s = 0; ph ^= 1; }
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (prev >= 0 && lane == 0) mbar_arrive(ring.empty + 8 * prev);
}

// a warpgroup's 64 x BN accumulator tile at rows m_base.., columns n0..:
// fragment (i, h) is row (warp % 4) * 16 + lane / 4 + 8 h, columns
// 8 i + 2 (lane % 4) and the next (re, im of one bin in the analysis).
// The analysis epilogue (momentum, projection onto the magnitudes, pinning,
// the two bf16 carries) takes G column groups at a time and issues all
// their loads (magnitude, previous projection, pinned value) before any
// store: one memory round trip for G groups, not one per bin.
template <int BN, int MODE>
__device__ __forceinline__ void epilogue(const GriffinLimArgs& a,
                                         const float (&acc)[BN / 2],
                                         int m_base, int n0, float* frames,
                                         int warp, int lane) {
  const int M = a.B * a.n, F2 = 2 * a.F;
  const int row0 = m_base + (warp & 3) * 16 + (lane >> 2);
  if (MODE == SYNTH) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M)
          *reinterpret_cast<float2*>(frames + (size_t)row * a.fs + col) =
              make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
    return;
  }
  // 8 groups at once for the narrow tiles; 4 for the wide ones, whose
  // accumulators already hold 64-104 registers
  constexpr int G = BN <= 64 ? BN / 8 : 4;
  int f_row[2];
  size_t pin_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    f_row[h] = row % a.n;
    pin_row[h] = ((size_t)(row / a.n) * a.n_pinned + f_row[h]) * F2;
  }
#pragma unroll
  for (int i0 = 0; i0 < BN / 8; i0 += G) {
    float mag[G][2];
    uint32_t prev[G][2], pinned[G][2];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int bin = (n0 + 8 * (i0 + g) + 2 * (lane & 3)) >> 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        const bool ok = i0 + g < BN / 8 && row < M && bin < a.F;
        mag[g][h] = ok ? a.S[(size_t)row * a.F + bin] : 0.0f;
        prev[g][h] = ok ? ldcg_pair(a.tp + (size_t)row * F2 + 2 * bin) : 0u;
        pinned[g][h] = ok && f_row[h] < a.n_pinned
                           ? ldcg_pair(a.pin + pin_row[h] + 2 * bin)
                           : 0u;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int i = i0 + g;
      const int bin = (n0 + 8 * i + 2 * (lane & 3)) >> 1;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (i >= BN / 8 || row >= M || bin >= a.F) continue;
        // (v0, v1) = re, im of the re-analysed frame
        const float v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
        const __nv_bfloat162 p = unpack_bf16(prev[g][h]);
        const float ar = v0 + a.momentum * (v0 - __low2float(p));
        const float ai = v1 + a.momentum * (v1 - __high2float(p));
        const float scale = mag[g][h] * rsqrtf(ar * ar + ai * ai + 1e-30f);
        // an already-played frame keeps its start value
        const uint32_t cv = f_row[h] < a.n_pinned
                                ? pinned[g][h]
                                : pack_bf16(ar * scale, ai * scale);
        *reinterpret_cast<uint32_t*>(a.c + (size_t)row * a.Kp + 2 * bin) =
            cv;
        *reinterpret_cast<uint32_t*>(a.tp + (size_t)row * F2 + 2 * bin) =
            pack_bf16(v0, v1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// batch route: one launch per step
// ---------------------------------------------------------------------------

__global__ void init_kernel(const GriffinLimArgs a) {
  init_elem(a, blockIdx.x * blockDim.x + threadIdx.x);
}

// one thread per output unit (4 samples, or 1 when hop % 4 != 0)
template <bool ANY>
__global__ void ola_kernel(const GriffinLimArgs a, int final) {
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned samples = a.B * (a.n + a.fft / a.hop - 1) * a.hop;
  // stride = units: one unit a thread
  if constexpr (!ANY) {
    if (q < samples / 4)
      ola_quads4<1>(a, q, samples / 4, samples / 4, final != 0);
  } else if (a.hop % 4 == 0) {
    if (q < samples / 4)
      ola_units<1, 4>(a, q, samples / 4, samples / 4, final != 0);
  } else if (q < samples) {
    ola_units<1, 1>(a, q, samples, samples, final != 0);
  }
}

__global__ void spec_kernel(const GriffinLimArgs a) {
  const unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < (unsigned)(a.B * a.n * a.F)) spec_elem(a, idx);
}

// grid (M tiles of 128 rows, N tiles); ma: A over (K, M), mb: B over (K, N)
template <int BN, int MODE>
__global__ void __launch_bounds__(BATCH_THREADS, 1)
    gemm_batch(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap mb,
               const GriffinLimArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const Ring ring(smem_raw, BATCH_STAGES, stage_bytes(BATCH_BM, BN));
  const int m0 = blockIdx.x * BATCH_BM, n0 = blockIdx.y * BN;
  const int nk = ((MODE == SYNTH ? 2 * a.F : a.fft) + GK - 1) / GK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr uint32_t A_BYTES = BATCH_BM * GK * 2;
  int s = 0;
  uint32_t ph = 0;
  if (warp == 8) {   // producer
    if (lane == 0)
      produce<BATCH_STAGES>(ring, s, ph, &ma, &mb, m0, n0, 0, nk, A_BYTES,
                            stage_bytes(BATCH_BM, BN));
    return;
  }
  const int wg = warp >> 2;   // rows wg * 64 .. + 63 of the tile
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  consume<BN, BATCH_STAGES>(acc, ring, s, ph, nk, wg * 64 * GK * 2,
                            A_BYTES, lane);
  epilogue<BN, MODE>(a, acc, m0 + wg * 64, n0, a.frames, warp, lane);
}

// ---------------------------------------------------------------------------
// window route: one persistent cooperative launch (or one launch a step)
// ---------------------------------------------------------------------------

struct WindowMaps {
  CUtensorMap c, syn, a16, ana;
};

// steps [p_begin, p_end): 0 the start; 1 + 3 it + (0 synthesis, 1 overlap-
// add, 2 analysis) for it < n_iters; 3 n_iters + 1 the last synthesis;
// 3 n_iters + 2 the waveform and the returned spectrum. Warps 0 .. 4 NWG - 1
// are the consumer warpgroups, the last warp the producer; all threads
// share the element-wise steps. trace (blocks below TRACE_BLOCKS): the
// globaltimer at the start and the end of each step p at [p][block], and
// the block's SM at [steps][block][0].
template <int BN, int NWG, bool ANY>
__global__ void __launch_bounds__(win_threads<NWG>(), win_blocks<BN>())
    gl_window(const __grid_constant__ WindowMaps maps, const GriffinLimArgs a,
              int p_begin, int p_end) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int BM = 64 * NWG, STAGES = win_stages<BN>();
  constexpr uint32_t A_BYTES = BM * GK * 2, STAGE = stage_bytes(BM, BN);
  const Ring ring(smem_raw, STAGES, STAGE, 4 * NWG);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool producer = warp == 4 * NWG;
  const int wg = warp >> 2;
  const int M = a.B * a.n, F2 = 2 * a.F;
  const int m_tiles = (M + BM - 1) / BM;
  const int syn_n = (a.fft + BN - 1) / BN, ana_n = (F2 + BN - 1) / BN;
  const int nk_syn = (F2 + GK - 1) / GK, nk_ana = (a.fft + GK - 1) / GK;
  const int last = 3 * a.n_iters + 2;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned nthreads = gridDim.x * blockDim.x;
  unsigned long long* trace =
      a.trace != nullptr && blockIdx.x < TRACE_BLOCKS && threadIdx.x == 0
          ? a.trace + 2 * (size_t)blockIdx.x : nullptr;
  if (trace != nullptr) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    trace[(size_t)2 * TRACE_BLOCKS * (last + 1)] = smid;
  }
  int s = 0;
  uint32_t ph = 0;
  unsigned target = 0;
  for (int p = p_begin; p < p_end; ++p) {
    if (p > p_begin) grid_sync(a.sync, target);
    if (trace != nullptr)
      trace[(size_t)2 * TRACE_BLOCKS * p] = globaltimer();
    if (p == 0) {
      const unsigned n_init = a.init == INIT_GIVEN ? M * a.F : a.B * a.F;
      for (unsigned i = tid; i < n_init; i += nthreads) init_elem(a, i);
    } else if (p == last) {
      ola_step<ANY>(a, tid, nthreads, true);
      if (a.spec_re != nullptr)
        for (unsigned i = tid; i < (unsigned)(M * a.F); i += nthreads)
          spec_elem(a, i);
    } else if ((p - 1) % 3 == 1) {
      ola_step<ANY>(a, tid, nthreads, false);
    } else {   // a GEMM: synthesis or analysis
      const bool syn = (p - 1) % 3 == 0;
      const int n_tiles = syn ? syn_n : ana_n, nk = syn ? nk_syn : nk_ana;
      for (int t = blockIdx.x; t < m_tiles * n_tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * BM, n0 = (t / m_tiles) * BN;
        if (producer) {
          if (lane == 0)
            produce<STAGES>(ring, s, ph, syn ? &maps.c : &maps.a16,
                            syn ? &maps.syn : &maps.ana, m0, n0, 0, nk,
                            A_BYTES, STAGE);
        } else {
          float acc[BN / 2];
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
          consume<BN, STAGES>(acc, ring, s, ph, nk, wg * 64 * GK * 2,
                              A_BYTES, lane);
          if (syn)
            epilogue<BN, SYNTH>(a, acc, m0 + wg * 64, n0, a.frames, warp,
                                lane);
          else
            epilogue<BN, ANALYSIS>(a, acc, m0 + wg * 64, n0, nullptr, warp,
                                   lane);
        }
      }
    }
    // the whole block finishes the step before any of it enters the grid
    // barrier: without this, the one launch measured slower on the H100
    // than the same steps launched one by one from a CUDA graph
    __syncthreads();
    if (trace != nullptr)
      trace[(size_t)2 * TRACE_BLOCKS * p + 1] = globaltimer();
  }
  if (a.one_launch) {
    // the last block out leaves the counters at zero for the next call
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      if (atomicAdd(a.sync + 1, 1u) == gridDim.x - 1) {
        atomicExch(a.sync, 0u);
        atomicExch(a.sync + 1, 0u);
      }
    }
  }
}

int run_batch(const GriffinLimArgs& a, const WindowMaps& maps,
              cudaStream_t stream) {
  constexpr size_t smem_syn =
      ring_smem(BATCH_STAGES, BATCH_BM, BATCH_BN_SYN);
  constexpr size_t smem_ana =
      ring_smem(BATCH_STAGES, BATCH_BM, BATCH_BN_ANA);
  static cudaError_t attr_syn =
      allow_smem(gemm_batch<BATCH_BN_SYN, SYNTH>, smem_syn);
  static cudaError_t attr_ana =
      allow_smem(gemm_batch<BATCH_BN_ANA, ANALYSIS>, smem_ana);
  if (attr_syn != cudaSuccess) return (int)attr_syn;
  if (attr_ana != cudaSuccess) return (int)attr_ana;
  const long M = (long)a.B * a.n, nb = a.n + a.fft / a.hop - 1;
  const dim3 syn_grid(cdiv(M, BATCH_BM), cdiv(a.fft, BATCH_BN_SYN));
  const dim3 ana_grid(cdiv(M, BATCH_BM), cdiv(2 * a.F, BATCH_BN_ANA));
  const unsigned ola_blocks =
      cdiv((long)a.B * nb * a.hop / (a.hop % 4 == 0 ? 4 : 1), 256);
  const unsigned init_blocks =
      cdiv(a.init == INIT_GIVEN ? M * a.F : (long)a.B * a.F, 256);

  init_kernel<<<init_blocks, 256, 0, stream>>>(a);
  for (int it = 0; it <= a.n_iters; ++it) {   // the last: the waveform
    gemm_batch<BATCH_BN_SYN, SYNTH>
        <<<syn_grid, BATCH_THREADS, smem_syn, stream>>>(maps.c, maps.syn, a);
    if (ola_any(a.fft, a.hop))
      ola_kernel<true><<<ola_blocks, 256, 0, stream>>>(a, it == a.n_iters);
    else
      ola_kernel<false><<<ola_blocks, 256, 0, stream>>>(a, it == a.n_iters);
    if (it == a.n_iters) break;
    gemm_batch<BATCH_BN_ANA, ANALYSIS>
        <<<ana_grid, BATCH_THREADS, smem_ana, stream>>>(maps.a16, maps.ana,
                                                        a);
  }
  if (a.spec_re != nullptr)
    spec_kernel<<<cdiv(M * a.F, 256), 256, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BN, int NWG, bool ANY>
int run_window(const GriffinLimArgs& a, const WindowMaps& maps,
               cudaStream_t stream, int device) {
  constexpr int BM = 64 * NWG, THREADS = win_threads<NWG>();
  constexpr size_t smem = ring_smem(win_stages<BN>(), BM, BN);
  static cudaError_t attr = allow_smem(gl_window<BN, NWG, ANY>, smem);
  if (attr != cudaSuccess) return (int)attr;
  static int per_sm = 0;
  if (per_sm == 0) {
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gl_window<BN, NWG, ANY>, THREADS, smem);
    if (e != cudaSuccess) return (int)e;
  }
  int sms = 0;
  cudaError_t e =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  const long M = (long)a.B * a.n, m_tiles = cdiv(M, BM);
  const long tiles = std::max(m_tiles * (long)cdiv(a.fft, BN),
                              m_tiles * (long)cdiv(2 * a.F, BN));
  const int grid = (int)std::max(1L, std::min((long)per_sm * sms, tiles));
  const int phases = 3 * a.n_iters + 3;
  if (a.one_launch) {
    int pb = 0, pe = phases;
    void* params[] = {(void*)&maps, (void*)&a, (void*)&pb, (void*)&pe};
    e = cudaLaunchCooperativeKernel((const void*)gl_window<BN, NWG, ANY>,
                                    dim3(grid), dim3(THREADS), params, smem,
                                    stream);
    if (e != cudaSuccess) return (int)e;
  } else {
    for (int p = 0; p < phases; ++p)
      gl_window<BN, NWG, ANY><<<grid, THREADS, smem, stream>>>(maps, a, p,
                                                               p + 1);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One whole retrieval on the caller's stream.
extern "C" int dv3_griffin_lim(const GriffinLimArgs* args, void* stream_ptr,
                               int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const GriffinLimArgs a = *args;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const bool batch = a.route == ROUTE_BATCH;
  const bool tiles_ok = (a.bm == 64 && (a.bn == 32 || a.bn == 64)) ||
                        (a.bm == 128 && a.bn == 128);
  if (!batch && !tiles_ok) return (int)cudaErrorInvalidValue;
  // hop | fft; the synthesis tiles' columns stay inside the fs-wide rows
  const int bn_syn = batch ? BATCH_BN_SYN : a.bn;
  if (a.hop <= 0 || a.fft % a.hop != 0 || a.fs % 64 != 0 || a.fs < a.fft ||
      a.fs % bn_syn != 0)
    return (int)cudaErrorInvalidValue;
  const int bm = batch ? BATCH_BM : a.bm;
  const long M = (long)a.B * a.n, F2 = 2 * a.F;
  const long ana_row = ((long)a.fft + 7) / 8 * 8;   // 16-byte rows
  WindowMaps maps;
  int rc = encode_bf16_rows(&maps.c, a.c, F2, M, 1, (long)a.Kp * 2, GK, bm);
  if (rc == 0)
    rc = encode_bf16_rows(&maps.syn, a.synT, F2, a.fft, 1, (long)a.Kp * 2, GK,
                          bn_syn);
  if (rc == 0)
    rc = encode_bf16_rows(&maps.a16, a.a16, a.fft, M, 1, (long)a.fs * 2, GK,
                          bm);
  if (rc == 0)
    rc = encode_bf16_rows(&maps.ana, a.anaT, a.fft, F2, 1, ana_row * 2, GK,
                          batch ? BATCH_BN_ANA : a.bn);
  if (rc != 0) return rc;
  if (batch) return run_batch(a, maps, stream);
  if (ola_any(a.fft, a.hop)) {
    switch (a.bn) {
      case 32: return run_window<32, 1, true>(a, maps, stream, device);
      case 64: return run_window<64, 1, true>(a, maps, stream, device);
      default: return run_window<128, 2, true>(a, maps, stream, device);
    }
  }
  switch (a.bn) {
    case 32: return run_window<32, 1, false>(a, maps, stream, device);
    case 64: return run_window<64, 1, false>(a, maps, stream, device);
    default: return run_window<128, 2, false>(a, maps, stream, device);
  }
}

extern "C" const char* dv3_error_string(int e) {
  const char* s = encode_error_string(e);
  return s != nullptr ? s : cudaGetErrorString((cudaError_t)e);
}
