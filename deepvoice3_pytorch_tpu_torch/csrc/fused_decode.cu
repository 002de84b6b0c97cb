// Fused autoregressive decoder for Hopper (sm_90a): the DeepVoice3 decoder
// (single- and multi-speaker) and the nyanko decoder.
//
// Replaces the Pallas TPU kernel of deepvoice3_pytorch_tpu/ops/fused_decode.py
// (`_make_kernel`, launched by `_Prepared.launch`): for each step of a chunk
// it runs the decoder's op table (ops/fused_decode.py:build_plan):
//   LINEAR    1x1 conv + activation;
//   GLU       causal GLU conv against the layer's ring buffer, with an
//             optional per-row speaker softsign bias added to the value half
//             before the gate (multi-speaker);
//   HIGHWAY   causal highway conv against the ring buffer: sigma(g)*a +
//             (1-sigma(g))*x, or (a*sigma(g) + x)*sqrt(1/2) (nyanko);
//   ATTN      windowed single-head attention (query + position encoding ->
//             projection -> masked softmax -> first-argmax `last_attended`
//             -> context * sqrt(Tk) -> out-projection, (x + q)*sqrt(1/2));
//   SAVE_RES / RESIDUAL   the outer residual * sqrt(1/2) (DeepVoice3);
//   SAVE_Q / LINEAR2      keep the audio encoder's output Q, then
//             x @ W_top + Q @ W_bot + b, i.e. [R, Q] @ W (nyanko);
// then `last_conv` -> sigmoid frame fed back as the next input, done =
// sigmoid(fc). The query position row is either raw angles (per-row rate,
// sin on even / cos on odd columns: DeepVoice3) or a finished encoding used
// as it stands (nyanko). f32 throughout.
//
// Two modes serve continuous batching (the Pallas kernel's fpe_per_sample
// and per_sample_scale), where every row is a slot at its own point of its
// own utterance:
//   per-row positions  `pos` (B,) holds the frames each row has decoded;
//                      step s of row b reads row min(pos[b] + s + 1,
//                      fpe_rows - 1) of the whole position table, and the
//                      launch advances pos[b] by `steps` (capped at 2^30);
//   per-row scale      `row_scale` (B,) replaces the one context scale.
// With both pointers null the kernel reads rows t0 .. t0+steps-1 of a table
// shared by every row and scales by `ctx_scale`.
//
// Design. A decode step is a chain of dependent matrix-vector products
// over every row, whose folded weights (3.1 M f32 at the LJSpeech preset,
// 6.9 M at nyanko's) are the bytes to move. The kernel is ONE persistent
// cooperative launch a chunk over the whole card (a block an SM), and the
// host compiles the op table into stages (ops/fused_decode.py:b1_stages),
// a grid barrier (hopper.cuh:grid_sync) after each:
//   MV   a matrix-vector product whose N output columns are split among the
//        blocks (paired value / gate columns stay together for GLU and
//        highway); each block computes its columns for ALL rows, so every
//        weight is read once a step for the whole batch, in f32 FMA. Its
//        slice of every stage's weights, with the columns' biases as one
//        more row, is packed once per parameter set and kept in shared
//        memory for the launch as far as the budget allows; the rest is
//        read from device memory (L2) each step. The epilogue (activation,
//        GLU / highway gate, speaker bias, the outer residual) is fused
//        into the stage; the last stage is last_conv with fc folded in as
//        one more column (W_last w_fc), so done needs no stage of its own;
//   ATT  one attention layer, a block a row: its query and out projections
//        are folded into the keys and values once a decode (K Wq^T, K bq,
//        V Wo: ops/fused_decode.py:attention_operands), so the layer is one
//        stage: scores of the query (x + the position row) against the
//        folded keys, softmax, last_attended, the output sum_k p_k (V Wo)[k]
//        and the attention and outer residuals. A monotonic window that
//        holds an unpadded key is computed over its keys alone: outside it
//        the plain version's scores are -1e9 and their exp is exactly 0 in
//        f32, so the softmax, the first argmax and the output are the same.
//        Otherwise (not monotonic, or no unpadded key in the window) all Tk
//        keys.
// What bounds a stage is the barrier and its trips to L2 (their latency,
// and for a wide stage L2's bandwidth), so a stage reads its tables and
// the block's last_attended from shared memory, copied there at the
// launch's start, and writes all it makes in one epilogue: its output,
// the ring row of the conv after it, the decoder state. Activations live
// in a workspace in device memory between stages (a buffer per stage,
// read through L2); inside a stage a warp's lanes split the reduction
// dimension, the warps split rows and column quads (and the reduction too
// when there are few rows), and partial sums are added in a fixed order,
// so a run is deterministic. A lane reads its inputs FB values a row at
// once and issues the next chunk's loads before the FMAs of the one it
// holds (dot_rows), so that a stage of several input segments (a k = 3
// conv's two past taps and its incoming frame: 96 KB a block from L2)
// waits on L2 about once rather than once a segment. The past taps are
// final before the barrier that precedes the stage, but loading them
// while that barrier is pending measured slower: every block reads every
// row's input, so the stage's reads are bound by L2's bandwidth, and moved
// into the barrier they delayed it by about what they saved. Registers
// are the budget (one 512-thread block an SM: 128 a thread): what lives
// through the stage loop is read where used rather than kept. Ring
// buffers of every row live in device memory for the launch: copied in
// from the carry (logical order) at the start, and stored back in logical
// order at the end, so the carry has the JAX kernel's layout.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int RB = 32;           // rows of a stage's matvec in one pass
constexpr int WIN_MAX = 64;      // most keys of a window computed as one
constexpr int ST_WORDS = 32;     // ops/fused_decode.py:ST_WORDS
constexpr int FB = 4;            // input values a lane loads of each row at
                                 // once
constexpr int RING_WORDS = 4;    // rows, width, offset in a carry row,
                                 // offset in a scratch row

enum { K_MV = 0, K_ATT = 1 };
enum { E_LIN = 0, E_GLU = 1, E_HW = 2, E_LAST = 3 };
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };
// words of a stage (ops/fused_decode.py mirrors these indices)
enum {
  S_KIND = 0, S_EPI, S_K, S_U, S_PAIRED, S_IN, S_IN2, S_OUT, S_RES,
  S_RING, S_KW, S_DIL, S_CIN, S_FLAG, S_SLOT, S_BIAS, S_NCP, S_WOFF,
  S_RESIDENT, S_ROT, S_AIDX, S_MONO, S_BACK, S_AHEAD, S_RINGW, S_DSTATE,
  S_QOUT
};
// fixed buffers of the workspace; stage outputs follow
enum { BUF_PREV0 = 0, BUF_PREV1 = 1, BUF_FPE = 2 };
constexpr int IN_PREV = -1;      // a stage input: this step's previous frame
constexpr float SQRT_HALF = 0.70710678118654752440f;
constexpr float MASK = -1.0e9f;

}  // namespace

// Field order and types match ops/fused_decode.py:_B1Args.
struct B1Args {
  const int* stages;     // (n_stages, ST_WORDS)
  const int* rings;      // (n_ring, RING_WORDS)
  const int* widths;     // (n_bufs,) widths of the workspace's buffers
  const float* wpack;    // (grid, per_block) stage weights split by column,
                         // each slice's biases in its last row
  const float* fpe;      // (>= t0 + steps, C) query-position rows; with
                         // `pos`, the whole table (fpe_rows, C)
  const float* wq;       // (B,) query position rates (fpe_raw only)
  const float* addmask;  // (B, Tk): 0 valid, -1e9 padded
  const float* kv;       // (n_att, 2, B, Tk, C + 1): K [Wq^T | bq] (the
                         // keys through the query projection and its
                         // bias), V [Wo | 0] (the values through the out
                         // projection)
  const float* weights;  // build_plan's folded weights (the out biases)
  const float* sp;       // (n_sp, B, sp_width) speaker softsign biases
  const float* row_scale;  // (B,) per-row context scales, or null
  float* prev;           // (B, out_dim) carry: previous frame
  int* la;               // (B, n_la) carry: last_attended per attention layer
  float* ring;           // (B, ring_floats) carry: ring buffers, logical order
  float* scratch;        // (B, scratch_floats) the rings during the launch,
                         // each with one row more than in the carry
  float* ws;             // workspace: buffer i is (B, round4(widths[i]))
  float* att;            // (2, B, Tk): alignment sums, full-path scores
  float* out;            // (B, T_total, out_dim)
  float* align;          // (B, T_total, Tk)
  float* done;           // (B, T_total)
  float* dstate;         // (B, T_total, C)
  int* pos;              // (B,) per-row positions, or null (shared rows)
  unsigned* sync;        // two zeroed counters: grid barrier, exit
  unsigned long long* trace;  // null, or 2 + 3 * steps * n_stages stamps
  int n_stages, n_bufs, n_ring, B, Tk, C, out_dim, n_att, n_la, ring_floats;
  int scratch_floats, sp_width, fpe_raw, T_total, t0, steps, fpe_rows;
  int per_block, resident, max_ncp;
  float ctx_scale;       // Tk * sqrt(1 / Tk) on the padded Tk
};

namespace {

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of a block, in 4-byte words: the stage table, buffer table,
// ring table, the block's units of each stage, the rings' heads and the
// last_attended of the block's rows (ints), then the resident weights, the
// stage's results for RB rows, the warps' partial sums, a window's
// probabilities, a reduction scratch (floats). ops/fused_decode.py:
// b1_meta_ints and b1_smem_floats mirror it.
__host__ __device__ inline int meta_ints(int n_stages, int n_bufs, int n_ring,
                                         int la_ints) {
  return round4(n_stages * (ST_WORDS + 2) + 2 * n_bufs +
                (RING_WORDS + 1) * n_ring + la_ints);
}
__host__ __device__ inline int smem_floats(int meta, int resident,
                                           int max_ncp) {
  return meta + round4(resident) + RB * max_ncp + NW * 8 + WIN_MAX + 40;
}

extern __shared__ float4 smem4[];

// the tables, copied into shared memory at the launch's start, and what
// the block derives from them once
__device__ __forceinline__ int* sm_stages() {
  return reinterpret_cast<int*>(smem4);
}
__device__ __forceinline__ int* sm_bufs(const B1Args& a) {
  return sm_stages() + a.n_stages * ST_WORDS;
}
__device__ __forceinline__ int* sm_rings(const B1Args& a) {
  return sm_bufs(a) + 2 * a.n_bufs;
}
// the block's output units [u0, u1) of stage s at [2 s], [2 s + 1]
__device__ __forceinline__ int* sm_units(const B1Args& a) {
  return sm_rings(a) + RING_WORDS * a.n_ring;
}
// the slot of each ring's oldest frame at the current step
__device__ __forceinline__ int* sm_heads(const B1Args& a) {
  return sm_units(a) + 2 * a.n_stages;
}
// last_attended of row blockIdx.x + r * gridDim.x at [r * n_la + layer]
__device__ __forceinline__ int* sm_la(const B1Args& a) {
  return sm_heads(a) + a.n_ring;
}
__device__ __forceinline__ int la_ints(const B1Args& a) {
  return (a.B + gridDim.x - 1) / gridDim.x * a.n_la;
}

// ceil(log2(n)) for n >= 1
__device__ __forceinline__ int ceil_log2(int n) {
  return n <= 1 ? 0 : 32 - __clz(n - 1);
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__device__ __forceinline__ float* buf_ptr(const B1Args& a, int id, int step,
                                          int* stride) {
  if (id == IN_PREV) id = BUF_PREV0 + (step & 1);
  const int* bufs = sm_bufs(a);
  *stride = bufs[2 * id + 1];
  return a.ws + bufs[2 * id];
}

// One segment of a stage's input: row b's values are p[b * stride + k] for
// k < len. Conv stages read kw segments: the past taps j < kw-1 (ring rows
// j*dil of the layer's buffer), then the incoming frame; LINEAR2 reads x
// and the saved Q. A ring of `rows` past frames has rows + 1 slots: at
// step s its oldest frame sits in slot s % (rows + 1) (sm_heads), and the
// stage before the conv writes frame s into slot (s + rows) % (rows + 1),
// which no tap of step s reads.
struct Seg {
  const float* p;
  size_t stride;
  int len;
};

__device__ __forceinline__ int n_taps(const int* st) {
  return st[S_RING] >= 0 ? st[S_KW] - 1 : 0;
}

// Segment g of the stage's input, from the tables in shared memory (kept
// in registers: an array of segments would live in local memory).
__device__ __forceinline__ Seg segment(const B1Args& a, const int* st,
                                       int step, int g) {
  Seg sg;
  int stride;
  const int taps = n_taps(st);
  if (g < taps) {
    const int* r = sm_rings(a) + RING_WORDS * st[S_RING];
    const int slots = r[0] + 1, cin = st[S_CIN];
    int slot = sm_heads(a)[st[S_RING]] + g * st[S_DIL];   // < 2 slots
    if (slot >= slots) slot -= slots;
    sg.p = a.scratch + r[3] + (size_t)slot * cin;
    sg.stride = a.scratch_floats;
    sg.len = cin;
  } else if (g == taps) {
    sg.p = buf_ptr(a, st[S_IN], step, &stride);
    sg.stride = stride;
    sg.len = st[S_IN2] >= 0 ? st[S_K] / 2 : st[S_K] - taps * st[S_CIN];
  } else {
    sg.p = buf_ptr(a, st[S_IN2], step, &stride);
    sg.stride = stride;
    sg.len = st[S_K] / 2;
  }
  return sg;
}

// This block's output units [u0, u1) of a stage with U units: the units are
// cut into gridDim.x contiguous parts, and block j takes part (j - rot) mod
// grid (rot spreads the larger parts of successive stages over the grid).
// Computed once a launch, into sm_units.
__device__ __forceinline__ void block_units(const int* st, int* u0, int* u1) {
  const int G = gridDim.x, U = st[S_U];
  const int p = (blockIdx.x + G - st[S_ROT] % G) % G;
  *u0 = U * p / G;
  *u1 = U * (p + 1) / G;
}

template <int QW>
__device__ __forceinline__ void load_w(const float* w, float* v) {
  if constexpr (QW == 4) {
    const float4 t = *reinterpret_cast<const float4*>(w);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (QW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(w);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *w;
  }
}

// FB values of each row a lane, from k on by the lane stride, below hi
// (zero past it): all loads at once, so that their trips to L2 overlap.
__device__ __forceinline__ void load_batch(const float* x0, const float* x1,
                                           int k, int hi, float (&v0)[FB],
                                           float (&v1)[FB]) {
#pragma unroll
  for (int i = 0; i < FB; ++i) {
    const int ki = k + 32 * i;
    v0[i] = ki < hi ? __ldcg(x0 + ki) : 0.0f;
    v1[i] = ki < hi ? __ldcg(x1 + ki) : 0.0f;
  }
}

// acc{0,1}[c] += v{0,1}[i] * W[k + 32 i][c] for the batch's values below hi,
// in k order.
template <int QW>
__device__ __forceinline__ void fma_batch(const float* W, int ncp, int k,
                                          int hi, const float (&v0)[FB],
                                          const float (&v1)[FB], float* acc0,
                                          float* acc1) {
#pragma unroll
  for (int i = 0; i < FB; ++i) {
    const int ki = k + 32 * i;
    if (ki < hi) {
      float w[QW];
      load_w<QW>(W + (size_t)ki * ncp, w);
#pragma unroll
      for (int c = 0; c < QW; ++c) {
        acc0[c] = fmaf(v0[i], w[c], acc0[c]);
        acc1[c] = fmaf(v1[i], w[c], acc1[c]);
      }
    }
  }
}

// acc{0,1}[c] += sum over k in [k0, k1) of in(row r{0,1}, k) * W[k][c] for
// the QW columns at W; a warp's lanes take every 32nd k. The warp's range
// is read in chunks of 32 FB consecutive k of one segment, FB values a lane
// and row (load_batch), and each chunk's loads are issued before the
// previous chunk's FMAs: the trips to L2 of a stage's segments (a k = 3
// conv's two past taps and its incoming frame, LINEAR2's x and Q) overlap,
// so the stage waits on L2 about once. Each accumulator still takes its
// terms in k order, so the sums are those of a load per k.
template <int QW>
__device__ __forceinline__ void dot_rows(const B1Args& a, const int* st,
                                         int step, int r0, int r1,
                                         const float* W, int ncp, int k0,
                                         int k1, int lane, float* acc0,
                                         float* acc1) {
  const int nseg = n_taps(st) + 1 + (st[S_IN2] >= 0);
  // the chunk [base, min(base + 32 FB, hi)) of segment g; next() moves to
  // the warp's next chunk, false past its last
  int g = -1, kb = 0, len = 0, base = 0, hi = 0;
  const float *x0 = nullptr, *x1 = nullptr;
  auto next = [&]() {
    base += 32 * FB;
    while (base >= hi) {
      kb += len;
      if (++g >= nseg) return false;
      const Seg sg = segment(a, st, step, g);
      len = sg.len;
      base = max(k0, kb);
      hi = min(k1, kb + len);
      x0 = sg.p + r0 * sg.stride - kb;
      x1 = sg.p + r1 * sg.stride - kb;
    }
    return true;
  };
  if (!next()) return;
  float v0[FB], v1[FB];
  load_batch(x0, x1, base + lane, hi, v0, v1);
  while (true) {
    const int k = base + lane, k_hi = hi;
    const bool more = next();
    float n0[FB], n1[FB];
    if (more) load_batch(x0, x1, base + lane, hi, n0, n1);
    fma_batch<QW>(W, ncp, k, k_hi, v0, v1, acc0, acc1);
    if (!more) break;
#pragma unroll
    for (int i = 0; i < FB; ++i) {
      v0[i] = n0[i];
      v1[i] = n1[i];
    }
  }
}

// ys[r][c] = sum_k in(b0 + r, k) * W[k][c] for r < nrows and the block's
// ncp packed columns. Work items are (row pair, column quad); when there
// are fewer items than warps, each item's K range is split over several
// warps, and the partial sums are added in slice order.
template <int QW>
__device__ void matvec_rows(const B1Args& a, const int* st, int step,
                            int K, int b0, int nrows, const float* W, int ncp,
                            float* ys, float* part) {
  // powers of two throughout (ncp above 4 is one), so that no division
  // sits on the stage's critical path
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lg_nq = ceil_log2(ncp / QW);
  const int items = ((nrows + 1) / 2) << lg_nq;
  const int lg_nks = items >= NW ? 0 : ceil_log2(NW) - ceil_log2(items);
  const int per_round = NW >> lg_nks;
  for (int base = 0; base < items; base += per_round) {
    // every warp runs the shuffles (an idle one over an empty K range), so
    // they stay warp-uniform
    const int it = base + (warp >> lg_nks), ks = warp & ((1 << lg_nks) - 1);
    const bool active = it < items;
    const int pr = active ? it >> lg_nq : 0;
    const int cq = active ? it & ((1 << lg_nq) - 1) : 0;
    const int r0 = b0 + 2 * pr, r1 = b0 + min(2 * pr + 1, nrows - 1);
    float acc0[QW], acc1[QW];
#pragma unroll
    for (int c = 0; c < QW; ++c) acc0[c] = acc1[c] = 0.0f;
    dot_rows<QW>(a, st, step, r0, r1, W + cq * QW, ncp,
                 active ? (K * ks) >> lg_nks : 0,
                 active ? (K * (ks + 1)) >> lg_nks : 0, lane, acc0, acc1);
#pragma unroll
    for (int c = 0; c < QW; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc0[c] += __shfl_xor_sync(0xffffffffu, acc0[c], off);
        acc1[c] += __shfl_xor_sync(0xffffffffu, acc1[c], off);
      }
    }
    if (lg_nks == 0) {
      // one warp an item: its sums are the results
      if (active && lane == 0) {
        const int r = 2 * pr;
#pragma unroll
        for (int c = 0; c < QW; ++c) {
          ys[r * ncp + cq * QW + c] = acc0[c];
          if (r + 1 < nrows) ys[(r + 1) * ncp + cq * QW + c] = acc1[c];
        }
      }
      __syncthreads();
      continue;
    }
    if (active && lane == 0) {
#pragma unroll
      for (int c = 0; c < QW; ++c) {
        part[warp * 8 + c] = acc0[c];
        part[warp * 8 + QW + c] = acc1[c];
      }
    }
    __syncthreads();
    const int n_out = min(per_round, items - base) * 2 * QW;
    for (int t = threadIdx.x; t < n_out; t += NT) {
      const int li = t / (2 * QW), e = t % (2 * QW);
      const int it2 = base + li;
      const int pr = it2 >> lg_nq, cq = it2 & ((1 << lg_nq) - 1);
      const int r = 2 * pr + e / QW;
      if (r >= nrows) continue;
      float s = 0.0f;
      for (int k = 0; k < (1 << lg_nks); ++k)
        s += part[((li << lg_nks) + k) * 8 + e];
      ys[r * ncp + cq * QW + e % QW] = s;
    }
    __syncthreads();
  }
}

// Where a stage's epilogue writes row b's value v of column o: its output
// buffer, and as the stage's words ask the ring row of the conv after it,
// the query (v + the position row) of the attention after it, the
// decoder state of frame t.
struct Outs {
  float* out;
  float* ring;
  float* qout;
  const float* fpe;
  int out_stride, ring_slot, qo_stride, fpe_stride;
};

__device__ __forceinline__ Outs stage_outs(const B1Args& a, const int* st,
                                           int step) {
  Outs w;
  w.out = buf_ptr(a, st[S_OUT], step, &w.out_stride);
  w.ring = nullptr;
  w.ring_slot = 0;
  if (st[S_RINGW] >= 0) {
    // the slot before the ring's oldest frame: frame `step` goes there
    const int* r = sm_rings(a) + RING_WORDS * st[S_RINGW];
    const int h = sm_heads(a)[st[S_RINGW]];
    w.ring = a.scratch + r[3];
    w.ring_slot = (h == 0 ? r[0] : h - 1) * r[1];
  }
  w.qout = nullptr;
  w.fpe = nullptr;
  w.qo_stride = w.fpe_stride = 0;
  if (st[S_QOUT] >= 0) {
    w.qout = buf_ptr(a, st[S_QOUT], step, &w.qo_stride);
    w.fpe = buf_ptr(a, BUF_FPE, step, &w.fpe_stride);
  }
  return w;
}

// fpe_v: the position row's value, read beforehand when w.qout is set
__device__ __forceinline__ void write_outs(const B1Args& a, const int* st,
                                           const Outs& w, int b, int o,
                                           int t, float v, float fpe_v) {
  w.out[b * w.out_stride + o] = v;
  if (w.ring != nullptr)
    w.ring[(size_t)b * a.scratch_floats + w.ring_slot + o] = v;
  if (w.qout != nullptr) w.qout[b * w.qo_stride + o] = v + fpe_v;
  if (st[S_DSTATE]) a.dstate[((size_t)b * a.T_total + t) * a.C + o] = v;
}

__device__ __forceinline__ void stamp(const B1Args& a, int i) {
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[i] = globaltimer();
}

// One MV stage: this block's output units for every row, with the fused
// epilogue.
__device__ void mv_stage(const B1Args& a, const int* st, int s, int step,
                         const float* wsm, float* ys, float* part, int mid) {
  const int u0 = sm_units(a)[2 * s], nu = sm_units(a)[2 * s + 1] - u0;
  if (nu <= 0) {
    stamp(a, mid);
    return;
  }
  const int ncp = st[S_NCP], K = st[S_K], epi = st[S_EPI];
  const float* W = st[S_RESIDENT]
                       ? wsm + st[S_WOFF]
                       : a.wpack + (size_t)blockIdx.x * a.per_block +
                             st[S_WOFF];
  const float* bias = W + (size_t)K * ncp;   // the slice's last row
  const Seg xin = segment(a, st, step, n_taps(st));
  const bool use_x = epi == E_HW || (epi == E_GLU && st[S_FLAG]);
  int res_stride = 0, nx_stride = 0;
  const float* res =
      st[S_RES] >= 0 ? buf_ptr(a, st[S_RES], step, &res_stride) : nullptr;
  const float* sp = st[S_SLOT] >= 0
                        ? a.sp + (size_t)st[S_SLOT] * a.B * a.sp_width
                        : nullptr;
  float* next = nullptr;
  Outs w{};
  if (epi == E_LAST)
    next = buf_ptr(a, BUF_PREV0 + ((step + 1) & 1), step, &nx_stride);
  else
    w = stage_outs(a, st, step);
  const int t = a.t0 + step;
  // element i of the epilogue: row i >> lg, unit i & (2^lg - 1) (< nu)
  const int lg = ceil_log2(nu);
  for (int b0 = 0; b0 < a.B; b0 += RB) {
    const int nrows = min(RB, a.B - b0), n_el = nrows << lg;
    // this thread's first element's operands, loaded before the products so
    // that their trip to L2 overlaps them
    float p_x = 0.0f, p_res = 0.0f, p_fpe = 0.0f, p_sp = 0.0f;
    {
      const int i = threadIdx.x, u = i & ((1 << lg) - 1);
      if (i < n_el && u < nu) {
        const int b = b0 + (i >> lg), o = u0 + u;
        if (use_x) p_x = __ldcg(xin.p + b * xin.stride + o);
        if (res != nullptr) p_res = __ldcg(res + b * res_stride + o);
        if (epi != E_LAST && w.qout != nullptr)
          p_fpe = __ldcg(w.fpe + b * w.fpe_stride + o);
        if (sp != nullptr) p_sp = __ldg(sp + (size_t)b * a.sp_width + o);
      }
    }
    if (ncp == 1)
      matvec_rows<1>(a, st, step, K, b0, nrows, W, ncp, ys, part);
    else if (ncp == 2)
      matvec_rows<2>(a, st, step, K, b0, nrows, W, ncp, ys, part);
    else
      matvec_rows<4>(a, st, step, K, b0, nrows, W, ncp, ys, part);
    stamp(a, mid);
    for (int i = threadIdx.x; i < n_el; i += NT) {
      const int r = i >> lg, u = i & ((1 << lg) - 1), b = b0 + r, o = u0 + u;
      if (u >= nu) continue;
      const bool pre = i == threadIdx.x;
      const float y = ys[r * ncp + u] + bias[u];
      float v;
      switch (epi) {
        default:   // E_LIN
          v = st[S_FLAG] == ACT_RELU ? fmaxf(y, 0.0f)
              : st[S_FLAG] == ACT_SIGMOID ? sigmoid_f(y) : y;
          break;
        case E_GLU: {
          const float val =
              sp == nullptr ? y
                            : y + (pre ? p_sp
                                       : __ldg(sp + (size_t)b * a.sp_width +
                                               o));
          const float g = ys[r * ncp + nu + u] + bias[nu + u];
          v = val * sigmoid_f(g);
          if (use_x)
            v = (v + (pre ? p_x : __ldcg(xin.p + b * xin.stride + o))) *
                SQRT_HALF;
          break;
        }
        case E_HW: {
          const float g = sigmoid_f(ys[r * ncp + nu + u] + bias[nu + u]);
          const float inp = pre ? p_x : __ldcg(xin.p + b * xin.stride + o);
          v = st[S_FLAG] ? (y * g + inp) * SQRT_HALF
                         : g * y + (1.0f - g) * inp;
          break;
        }
        case E_LAST: {
          // units 0 .. out_dim-1: the frame; unit out_dim: fc folded in
          v = sigmoid_f(y);
          if (o == a.out_dim) {
            a.done[(size_t)b * a.T_total + t] = v;
          } else {
            a.out[((size_t)b * a.T_total + t) * a.out_dim + o] = v;
            next[b * nx_stride + o] = v;
          }
          continue;
        }
      }
      if (res != nullptr)
        v = (v + (pre ? p_res : __ldcg(res + b * res_stride + o))) *
            SQRT_HALF;
      write_outs(a, st, w, b, o, t, v,
                 w.qout == nullptr ? 0.0f
                                   : pre ? p_fpe
                                         : __ldcg(w.fpe + b * w.fpe_stride +
                                                  o));
    }
    if (b0 + RB < a.B) __syncthreads();   // ys is reused by the next rows
  }
}

// Block-wide reduction; every thread gets the result.
template <bool IS_MAX>
__device__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < NW ? red[lane] : (IS_MAX ? -INFINITY : 0.0f);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float o = __shfl_xor_sync(0xffffffffu, v, off);
      v = IS_MAX ? fmaxf(v, o) : v + o;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// One attention layer for row b (the block's r-th row). Its query and out
// projections are folded into the keys and values once a decode
// (ops/fused_decode.py:attention_operands): the scores are q . (K Wq^T)[k]
// + (K bq)[k] for the query q = x + the position row (written by the stage
// before), then the masked softmax, last_attended, and the layer's output
// scale * sum_k p_k (V Wo)[k] + bo, (output + q) * sqrt(1/2) and the
// stage's residual, written as an MV epilogue writes; the row's alignment
// is summed over the layers and divided by n_la after the last. A
// monotonic window of at most WIN_MAX keys is scored first; when it holds
// no unpadded key, every key is.
__device__ void att_row(const B1Args& a, const int* st, int step, int b,
                        int r, float* win, float* red, int mid) {
  const int ai = st[S_AIDX], mono = st[S_MONO];
  const int Tk = a.Tk, C = a.C, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int t = a.t0 + step;
  int qs, res_stride = 0;
  const float* q = buf_ptr(a, st[S_IN], step, &qs);
  q += (size_t)b * qs;
  const float* res =
      st[S_RES] >= 0 ? buf_ptr(a, st[S_RES], step, &res_stride) : nullptr;
  const Outs w = stage_outs(a, st, step);
  const int KS = C + 1;    // row stride of the folded keys and values
  const float* keys = a.kv + ((size_t)(2 * ai) * a.B + b) * (size_t)Tk * KS;
  const float* vals =
      a.kv + ((size_t)(2 * ai + 1) * a.B + b) * (size_t)Tk * KS;
  const float* bo = a.weights + st[S_BIAS];
  const float* am = a.addmask + (size_t)b * Tk;
  int* la = sm_la(a) + r * a.n_la + ai;
  float* ave = a.att + (size_t)b * Tk;
  float* sc = a.att + ((size_t)a.B + b) * Tk;
  const float scale = a.row_scale ? __ldg(a.row_scale + b) : a.ctx_scale;
  const bool first_layer = ai == 0, last_layer = ai == a.n_att - 1;
  float* arow = a.align + ((size_t)b * a.T_total + t) * Tk;
  const int la_i = *la;
  const int lo = mono ? max(0, la_i - st[S_BACK]) : 0;
  const int hi = mono ? min(Tk, la_i + st[S_AHEAD]) : Tk;
  const int n = hi - lo;
  // this thread's first column's operands, loaded before the scores
  const int c0 = tid < C ? tid : 0;
  const float q0 = __ldcg(q + c0), bo0 = __ldg(bo + c0);
  const float res0 = res != nullptr ? __ldcg(res + b * res_stride + c0) : 0.0f;
  const float fpe0 =
      w.qout != nullptr ? __ldcg(w.fpe + b * w.fpe_stride + c0) : 0.0f;
  const float ave0 = !first_layer && tid < Tk ? __ldcg(ave + tid) : 0.0f;
  __syncthreads();   // win and red are free again
  constexpr int VPRE = 4;     // a 1-back / 3-ahead window's keys
  float vpre[VPRE];
  bool windowed = false;
  if (mono && n > 0 && n <= WIN_MAX) {
    // the window's values (first VPRE keys), loaded before the scores
#pragma unroll
    for (int k = 0; k < VPRE; ++k)
      vpre[k] = k < n ? __ldg(vals + (size_t)(lo + k) * KS + c0) : 0.0f;
    for (int k0 = 0; k0 < n; k0 += NW) {       // warp-uniform shuffles
      const int k = k0 + warp;
      const float* kr = keys + (size_t)(lo + min(k, n - 1)) * KS;
      float acc = 0.0f;
      if (k < n)
#pragma unroll 8
        for (int c = lane; c < C; c += 32) acc += __ldg(kr + c) * __ldcg(q + c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (k < n && lane == 0)
        win[k] = acc + __ldg(kr + C) + __ldg(am + lo + k);
    }
    __syncthreads();
    stamp(a, mid);
    // warp 0 takes the softmax of the window's n <= WIN_MAX scores, two a
    // lane, into win; an unpadded key scores above MASK / 2
    if (warp == 0) {
      const float s0 = lane < n ? win[lane] : -INFINITY;
      const float s1 = lane + 32 < n ? win[lane + 32] : -INFINITY;
      const bool valid = __any_sync(0xffffffffu, s0 > 0.5f * MASK ||
                                                     s1 > 0.5f * MASK);
      float m = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e0 = lane < n ? expf(s0 - m) : 0.0f;
      const float e1 = lane + 32 < n ? expf(s1 - m) : 0.0f;
      float sum = e0 + e1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float p0 = e0 / sum, p1 = e1 / sum;
      float pmax = fmaxf(p0, p1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        pmax = fmaxf(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
      // first index of the row max (jnp.argmax semantics)
      const unsigned lo_hits =
          __ballot_sync(0xffffffffu, lane < n && p0 >= pmax);
      const unsigned hi_hits =
          __ballot_sync(0xffffffffu, lane + 32 < n && p1 >= pmax);
      if (valid) {
        if (lane < n) win[lane] = p0;
        if (lane + 32 < n) win[lane + 32] = p1;
        if (lane == 0)
          *la = lo + (lo_hits ? __ffs(lo_hits) - 1 : 31 + __ffs(hi_hits));
      }
      if (lane == 0) red[36] = valid ? 1.0f : 0.0f;
    }
    __syncthreads();
    windowed = red[36] != 0.0f;
  }
  const float* p;   // probabilities of keys lo .. hi-1
  int k_lo = lo, k_n = n;
  if (windowed) {
    p = win;
  } else {
    // every key: the plain version's masked softmax over Tk, in sc
    for (int k0 = 0; k0 < Tk; k0 += NW) {      // warp-uniform shuffles
      const int k = k0 + warp;
      const float* kr = keys + (size_t)min(k, Tk - 1) * KS;
      float acc = 0.0f;
      if (k < Tk)
        for (int c = lane; c < C; c += 32) acc += __ldg(kr + c) * __ldcg(q + c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (k < Tk && lane == 0) sc[k] = acc + __ldg(kr + C) + __ldg(am + k);
    }
    __syncthreads();
    float m = -INFINITY;
    for (int k = tid; k < Tk; k += NT) {
      float s = __ldcg(sc + k);
      if (mono && (k < la_i - st[S_BACK] || k >= la_i + st[S_AHEAD]))
        s = MASK;
      sc[k] = s;
      m = fmaxf(m, s);
    }
    m = block_reduce<true>(m, red);
    float sum = 0.0f;
    for (int k = tid; k < Tk; k += NT) {
      const float e = expf(__ldcg(sc + k) - m);
      sc[k] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    float pmax = -INFINITY;
    for (int k = tid; k < Tk; k += NT) {
      const float e = __ldcg(sc + k) / sum;
      sc[k] = e;
      pmax = fmaxf(pmax, e);
    }
    if (mono) {
      pmax = block_reduce<true>(pmax, red);
      float first = (float)Tk;
      for (int k = tid; k < Tk; k += NT)
        if (__ldcg(sc + k) >= pmax) first = fminf(first, (float)k);
      first = -block_reduce<true>(-first, red);
      if (tid == 0) *la = (int)first;
    }
    __syncthreads();
    p = sc;
    k_lo = 0;
    k_n = Tk;
  }
  // the layer's output for each column c, its residuals, its writes
  for (int c = tid; c < C; c += NT) {
    const bool pre = c == tid;
    float acc = 0.0f;
    if (windowed) {
#pragma unroll
      for (int k = 0; k < VPRE; ++k)
        if (k < k_n)
          acc += p[k] * (pre ? vpre[k]
                             : __ldg(vals + (size_t)(k_lo + k) * KS + c));
      for (int k = VPRE; k < k_n; ++k)
        acc += p[k] * __ldg(vals + (size_t)(k_lo + k) * KS + c);
    } else {
      for (int k = 0; k < k_n; ++k)
        acc += __ldcg(p + k) * __ldg(vals + (size_t)k * KS + c);
    }
    const float o = acc * scale + (pre ? bo0 : __ldg(bo + c));
    float v = (o + (pre ? q0 : __ldcg(q + c))) * SQRT_HALF;
    if (res != nullptr)
      v = (v + (pre ? res0 : __ldcg(res + b * res_stride + c))) * SQRT_HALF;
    write_outs(a, st, w, b, c, t, v,
               w.qout == nullptr ? 0.0f
                                 : pre ? fpe0
                                       : __ldcg(w.fpe + b * w.fpe_stride + c));
  }
  for (int k = tid; k < Tk; k += NT) {
    float v = k >= k_lo && k < k_lo + k_n
                  ? (windowed ? p[k - k_lo] : __ldcg(p + k))
                  : 0.0f;
    if (!first_layer) v = (k == tid ? ave0 : __ldcg(ave + k)) + v;
    if (last_layer) arow[k] = v / (float)a.n_la;
    else ave[k] = v;
  }
}

// A thread's index in the grid, and the grid's threads: read where used
// rather than kept through the stage loop.
__device__ __forceinline__ unsigned grid_tid() {
  return blockIdx.x * NT + threadIdx.x;
}
__device__ __forceinline__ unsigned grid_threads() { return gridDim.x * NT; }

// Rows of the batch a block attends to: blockIdx.x + r * gridDim.x.
__device__ __forceinline__ int rows_here(const B1Args& a) {
  return (a.B - (int)blockIdx.x + gridDim.x - 1) / gridDim.x;
}

// The query-position rows of `step` for every row, into the workspace.
__device__ void fpe_rows(const B1Args& a, int step) {
  int stride;
  float* fpe = buf_ptr(a, BUF_FPE, step, &stride);
  for (unsigned i = grid_tid(); i < (unsigned)(a.B * a.C);
       i += grid_threads()) {
    const int b = i / a.C, c = i % a.C;
    const int t = a.pos ? min(__ldcg(a.pos + b) + step + 1, a.fpe_rows - 1)
                        : a.t0 + step;
    const float v = __ldg(a.fpe + (size_t)t * a.C + c);
    if (a.fpe_raw) {
      const float x = __ldg(a.wq + b) * v;
      fpe[b * stride + c] = (c & 1) ? cosf(x) : sinf(x);
    } else {
      fpe[b * stride + c] = v;
    }
  }
}


__global__ void __launch_bounds__(NT, 1) fused_decode_kernel(const B1Args a) {
  const int meta = meta_ints(a.n_stages, a.n_bufs, a.n_ring, la_ints(a));
  float* sm = reinterpret_cast<float*>(smem4);
  float* wsm = sm + meta;
  float* ys = wsm + round4(a.resident);
  float* part = ys + RB * a.max_ncp;
  float* win = part + NW * 8;
  float* red = win + WIN_MAX;
  unsigned target = 0;
  stamp(a, 0);

  // the tables and this block's last_attended rows into shared memory; the
  // resident weights; carry in (ring buffers in logical order: every
  // buffer's oldest frame in slot 0); the first step's position rows
  int* ism = sm_stages();
  for (int i = threadIdx.x; i < a.n_stages * ST_WORDS; i += NT)
    ism[i] = __ldg(a.stages + i);
  if (threadIdx.x == 0)   // each buffer's offset and row stride
    for (int i = 0, off = 0; i < a.n_bufs; ++i) {
      const int stride = round4(__ldg(a.widths + i));
      sm_bufs(a)[2 * i] = off;
      sm_bufs(a)[2 * i + 1] = stride;
      off += a.B * stride;
    }
  for (int i = threadIdx.x; i < RING_WORDS * a.n_ring; i += NT)
    sm_rings(a)[i] = __ldg(a.rings + i);
  for (int i = threadIdx.x; i < a.n_ring; i += NT) sm_heads(a)[i] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < a.n_stages; s += NT)
    block_units(ism + s * ST_WORDS, sm_units(a) + 2 * s,
                sm_units(a) + 2 * s + 1);
  for (int i = threadIdx.x; i < rows_here(a) * a.n_la; i += NT)
    sm_la(a)[i] = a.la[(blockIdx.x + (i / a.n_la) * gridDim.x) * a.n_la +
                       i % a.n_la];
  const float4* wsrc = reinterpret_cast<const float4*>(
      a.wpack + (size_t)blockIdx.x * a.per_block);
  float4* wdst = reinterpret_cast<float4*>(wsm);
  for (int i = threadIdx.x; i < round4(a.resident) / 4; i += NT)
    wdst[i] = __ldg(wsrc + i);
  for (int r = 0; r < a.n_ring; ++r) {
    const int* d = a.rings + RING_WORDS * r;
    const unsigned n = __ldg(d) * __ldg(d + 1);
    for (unsigned i = grid_tid(); i < (unsigned)a.B * n;
         i += grid_threads()) {
      const int b = i / n, local = i % n;
      a.scratch[(size_t)b * a.scratch_floats + __ldg(d + 3) + local] =
          a.ring[(size_t)b * a.ring_floats + __ldg(d + 2) + local];
    }
  }
  __syncthreads();
  int ps;
  float* prev0 = buf_ptr(a, BUF_PREV0, 0, &ps);
  for (unsigned i = grid_tid(); i < (unsigned)(a.B * a.out_dim);
       i += grid_threads())
    prev0[(i / a.out_dim) * ps + i % a.out_dim] = a.prev[i];
  fpe_rows(a, 0);
  grid_sync<false>(a.sync, target);
  stamp(a, 1);

  for (int step = 0; step < a.steps; ++step) {
    for (int s = 0; s < a.n_stages; ++s) {
      const int* st = ism + s * ST_WORDS;
      const int mid = 2 + 3 * (step * a.n_stages + s);   // trace stamps
      if (st[S_KIND] == K_MV) {
        mv_stage(a, st, s, step, wsm, ys, part, mid);
        // beside the last stage: the next step's position rows
        if (st[S_EPI] == E_LAST && step + 1 < a.steps)
          fpe_rows(a, step + 1);
      } else {
        for (int b = blockIdx.x, r = 0; b < a.B; b += gridDim.x, ++r)
          att_row(a, st, step, b, r, win, red, mid);
      }
      stamp(a, mid + 1);
      if (s + 1 == a.n_stages)   // every ring's oldest frame moves a slot
        for (int i = threadIdx.x; i < a.n_ring; i += NT) {
          const int h = sm_heads(a)[i] + 1;
          sm_heads(a)[i] = h == sm_rings(a)[RING_WORDS * i] + 1 ? 0 : h;
        }
      grid_sync<false>(a.sync, target);
      stamp(a, mid + 2);
    }
  }

  // carry out: ring buffers back in logical order, the last frame,
  // last_attended, the advanced positions
  for (int r = 0; r < a.n_ring; ++r) {
    const int* d = sm_rings(a) + RING_WORDS * r;
    const int rows = d[0], width = d[1];
    const unsigned n = rows * width;
    for (unsigned i = grid_tid(); i < (unsigned)a.B * n;
         i += grid_threads()) {
      const int b = i / n, local = i % n, row = local / width;
      a.ring[(size_t)b * a.ring_floats + d[2] + local] = __ldcg(
          a.scratch + (size_t)b * a.scratch_floats + d[3] +
          ((a.steps + row) % (rows + 1)) * width + local % width);
    }
  }
  int ls;
  const float* last = buf_ptr(a, BUF_PREV0 + (a.steps & 1), 0, &ls);
  for (unsigned i = grid_tid(); i < (unsigned)(a.B * a.out_dim);
       i += grid_threads())
    a.prev[i] = __ldcg(last + (i / a.out_dim) * ls + i % a.out_dim);
  for (int i = threadIdx.x; i < rows_here(a) * a.n_la; i += NT)
    a.la[(blockIdx.x + (i / a.n_la) * gridDim.x) * a.n_la + i % a.n_la] =
        sm_la(a)[i];
  if (a.pos != nullptr)
    for (unsigned b = grid_tid(); b < (unsigned)a.B; b += grid_threads())
      a.pos[b] = min(__ldcg(a.pos + b) + a.steps, 1 << 30);

  // the last block out leaves the counters at zero for the next launch
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(a.sync + 1, 1u) == gridDim.x - 1) {
      atomicExch(a.sync, 0u);
      atomicExch(a.sync + 1, 0u);
    }
  }
}

}  // namespace

// Dynamic shared memory of a launch, in bytes.
extern "C" int dv3_b1_smem_bytes(int n_stages, int n_bufs, int n_ring,
                                 int la_ints, int resident, int max_ncp) {
  return smem_floats(meta_ints(n_stages, n_bufs, n_ring, la_ints), resident,
                     max_ncp) *
         (int)sizeof(float);
}

// out[0] = SMs, out[1] = the most dynamic shared memory a block may have,
// in bytes.
extern "C" int dv3_b1_device_info(int device, int* out) {
  cudaError_t e = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount,
                                         device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(
        out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)e;
}

// One chunk: a cooperative launch of `grid` blocks. A grid that cannot be
// co-resident is refused (cudaErrorCooperativeLaunchTooLarge), never run.
extern "C" int dv3_fused_decode(const B1Args* a, int grid, int smem_bytes,
                                void* stream, int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  // set on every launch: the attribute is per device, and launches come
  // from several host threads
  e = cudaFuncSetAttribute(fused_decode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem_bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  void* params[] = {(void*)a};
  e = cudaLaunchCooperativeKernel((const void*)fused_decode_kernel,
                                  dim3(grid), dim3(NT), params,
                                  (size_t)smem_bytes, (cudaStream_t)stream);
  // a refused launch is reported here; take it off the runtime's last
  // error, which the next launch reads
  if (e != cudaSuccess) cudaGetLastError();
  return (int)e;
}

extern "C" const char* dv3_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
