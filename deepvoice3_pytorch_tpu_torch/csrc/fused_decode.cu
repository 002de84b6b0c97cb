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
//                      launch advances pos[b] by `steps` (capped at 2^30,
//                      so a retired slot that keeps decoding never wraps);
//   per-row scale      `row_scale` (B,) replaces the one context scale, so
//                      a slot keeps the scale of the text length it was
//                      admitted at when the batch's text dimension grows.
// With both pointers null the kernel reads rows t0 .. t0+steps-1 of a table
// shared by every row and scales by `ctx_scale`.
//
// Design. One thread block per batch row; the block loops over the chunk's
// steps, which takes the place of the TPU's sequential grid. The row's
// activations and `last_attended` live in dynamic shared memory, and so do
// its ring buffers as far as a budget allows: the host (FusedDecoder)
// places the smallest buffers in shared memory first and the rest in a
// per-row scratch in device memory, which stays in L2 (at the nyanko preset
// the buffers take 256 rows x 256 x 4 B = 256 KiB a row, more than the
// 227 KB a block may have). Every step touches kw taps of each buffer
// whatever its length, so the long, dilated buffers are the ones that leave.
// Ring buffers are circular (one head index each) and are stored back in
// logical order (oldest row first) at the end of the launch, so the carry
// has the JAX kernel's layout. The decoder is a small int op table plus one
// packed f32 weight buffer (weight norm folded on the host).
//
// What bounds it. Every step is a chain of matrix-vector products whose
// weights (3.1 M f32 at the LJSpeech preset, 6.9 M at nyanko's) are read
// from global memory and stay in the 50 MB L2; each block re-reads all of
// them once per step, so the arithmetic intensity is 0.5 FLOP/byte of L2
// traffic. The matvec reads 16-byte float4 columns, coalesced across
// threads, and splits the reduction dimension across thread groups so that
// many loads are in flight per SM. Splitting weights across SMs, several
// rows per block or a persistent grid would cut the L2 traffic; they are
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 512;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int OP_WORDS = 10;
constexpr int BUF_WORDS = 5;     // rows, width, carry offset, place, smem?
enum { OP_LINEAR = 0, OP_GLU = 1, OP_ATTN = 2, OP_SAVE_RES = 3,
       OP_RESIDUAL = 4, OP_HIGHWAY = 5, OP_LINEAR2 = 6, OP_SAVE_Q = 7 };
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_SIGMOID = 2 };
constexpr float SQRT_HALF = 0.70710678118654752440f;
constexpr float MASK = -1.0e9f;

}  // namespace

// Field order and types match ops/fused_decode.py:_Args.
struct FusedDecodeArgs {
  const int* ops;        // (n_ops, OP_WORDS)
  const int* bufs;       // (n_buf, BUF_WORDS): rows, width, offset in the
                         // carry row, offset in its place, 1 = shared memory
  const float* weights;  // packed folded weights, each block 16-byte aligned
  const float* fpe;      // (>= t0 + steps, C) query-position rows; with
                         // `pos`, the whole table (fpe_rows, C)
  const float* wq;       // (B,) query position rates (fpe_raw only)
  const float* addmask;  // (B, Tk): 0 valid, -1e9 padded
  const float* kv;       // (n_att, 2, B, Tk, E) projected keys, values
  const float* sp;       // (n_sp, B, sp_width) speaker softsign biases
  float* prev;           // (B, out_dim) carry: previous frame
  int* la;               // (B, n_la) carry: last_attended per attention layer
  float* ring;           // (B, ring_floats) carry: ring buffers, logical order
  float* scratch;        // (B, scratch_floats) ring buffers placed off-chip
  float* out;            // (B, T_total, out_dim)
  float* align;          // (B, T_total, Tk)
  float* done;           // (B, T_total)
  float* dstate;         // (B, T_total, C)
  int n_ops, n_buf, B, Tk, E, C, out_dim, n_att, n_la, ring_floats;
  int ring_smem_floats, scratch_floats, sp_width, fpe_raw;
  int T_total, t0, steps, last_w, last_b, fc_w, fc_b, act_dim, cat_dim;
  float ctx_scale;       // Tk * sqrt(1 / Tk) on the padded Tk
  int* pos;              // (B,) per-row positions, or null (shared rows)
  const float* row_scale;  // (B,) per-row context scales, or null
  int fpe_rows;          // rows of the whole table (per-row positions)
};

namespace {

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout, in floats; each region starts 16-byte aligned.
// ops/fused_decode.py:smem_floats mirrors it.
struct Layout {
  int ring, x, inp, y, cat, res, q, qs, fpe, qp, ctx, s, ave, part, red, ints,
      total;
};

__host__ __device__ inline Layout layout(const FusedDecodeArgs& a) {
  Layout l;
  int o = 0;
  l.ring = o; o += round4(a.ring_smem_floats);
  l.x = o;    o += round4(a.act_dim);
  l.inp = o;  o += round4(a.act_dim);
  l.y = o;    o += round4(a.act_dim);
  l.cat = o;  o += round4(a.cat_dim);
  l.res = o;  o += round4(a.C);
  l.q = o;    o += round4(a.C);
  l.qs = o;   o += round4(a.C);
  l.fpe = o;  o += round4(a.C);
  l.qp = o;   o += round4(a.E);
  l.ctx = o;  o += round4(a.E);
  l.s = o;    o += round4(a.Tk);
  l.ave = o;  o += round4(a.Tk);
  l.part = o; o += 4 * NT;
  l.red = o;  o += 64;
  l.ints = o; o += round4(a.n_buf + a.n_la);
  l.total = o;
  return l;
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[v] += sum_{k in [k0, k1)} x[k] * W[k*N + o*V + v]
template <int V>
__device__ __forceinline__ void accumulate(const float* __restrict__ W,
                                           const float* x, int k0, int k1,
                                           int N, int o, float* acc) {
  if constexpr (V == 4) {
    const float4* W4 = reinterpret_cast<const float4*>(W);
    const int NG = N / 4;
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float4 w = __ldg(W4 + (size_t)k * NG + o);
      const float xv = x[k];
      acc[0] += xv * w.x;
      acc[1] += xv * w.y;
      acc[2] += xv * w.z;
      acc[3] += xv * w.w;
    }
  } else {
#pragma unroll 4
    for (int k = k0; k < k1; ++k)
      acc[0] += x[k] * __ldg(W + (size_t)k * N + o);
  }
}

// y[o] = act(sum_k in[k] * W[k*N + o] + bias[o]) for o < N, where the
// input is x1 (K1 values, rows of W1) followed by x2 (K2 values, rows of
// W2); x and y in shared memory, W and bias in global memory. The K range
// is split over G thread groups; partial sums go through `part` and are
// added in group order.
template <int V>
__device__ void matvec_v(const float* __restrict__ W1, const float* x1,
                         int K1, const float* __restrict__ W2,
                         const float* x2, int K2,
                         const float* __restrict__ bias, int N, float* y,
                         float* part, int act) {
  const int NG = N / V, K = K1 + K2;
  int G = NT / NG;
  if (G < 1) G = 1;
  if (G > K) G = K;
  for (int idx = threadIdx.x; idx < G * NG; idx += NT) {
    const int g = idx / NG, o = idx % NG;
    const int k0 = (K * g) / G, k1 = (K * (g + 1)) / G;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.0f;
    accumulate<V>(W1, x1, k0, min(k1, K1), N, o, acc);
    if (k1 > K1)
      accumulate<V>(W2, x2, max(k0, K1) - K1, k1 - K1, N, o, acc);
#pragma unroll
    for (int v = 0; v < V; ++v) part[g * N + o * V + v] = acc[v];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < N; o += NT) {
    float s = 0.0f;
    for (int g = 0; g < G; ++g) s += part[g * N + o];
    s += __ldg(bias + o);
    if (act == ACT_RELU) s = fmaxf(s, 0.0f);
    else if (act == ACT_SIGMOID) s = sigmoid_f(s);
    y[o] = s;
  }
  __syncthreads();
}

__device__ void matvec2(const float* W1, const float* x1, int K1,
                        const float* W2, const float* x2, int K2,
                        const float* bias, int N, float* y, float* part,
                        int act) {
  if ((N & 3) == 0)
    matvec_v<4>(W1, x1, K1, W2, x2, K2, bias, N, y, part, act);
  else
    matvec_v<1>(W1, x1, K1, W2, x2, K2, bias, N, y, part, act);
}

__device__ void matvec(const float* W, const float* bias, const float* x,
                       int K, int N, float* y, float* part, int act) {
  matvec2(W, x, K, W, x, 0, bias, N, y, part, act);
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

__device__ float block_min(float v, float* red) {
  return -block_reduce<true>(-v, red);
}

// Where ring buffer `buf` of this row lives: shared memory or the row's
// scratch in device memory (a generic pointer either way).
__device__ __forceinline__ float* ring_at(const FusedDecodeArgs& a, int buf,
                                          float* ring_sm, float* scratch) {
  const int* d = a.bufs + buf * BUF_WORDS;
  return (d[4] ? ring_sm : scratch) + d[3];
}

// The conv of a GLU or highway layer: y (2*cout) <- W * [taps | x] + b,
// inp <- x. With a ring buffer, past tap j (j < kw-1) is logical row j*dil
// and the incoming frame is tap kw-1, which then replaces the oldest row.
__device__ void causal_conv(const FusedDecodeArgs& a, const float* W,
                            int w_off, int b_off, int kw, int dil, int buf,
                            int cin, int cout, float* x, float* inp,
                            float* cat, float* y, float* part, int* heads,
                            float* ring_sm, float* scratch) {
  const int tid = threadIdx.x;
  for (int c = tid; c < cin; c += NT) inp[c] = x[c];
  if (buf >= 0) {
    const int rows = a.bufs[buf * BUF_WORDS];
    float* rb = ring_at(a, buf, ring_sm, scratch);
    const int h = heads[buf];
    for (int idx = tid; idx < (kw - 1) * cin; idx += NT) {
      const int j = idx / cin, c = idx % cin;
      cat[idx] = rb[((h + j * dil) % rows) * cin + c];
    }
    for (int c = tid; c < cin; c += NT) cat[(kw - 1) * cin + c] = x[c];
    __syncthreads();
    matvec(W + w_off, W + b_off, cat, kw * cin, 2 * cout, y, part, ACT_NONE);
    for (int c = tid; c < cin; c += NT) rb[h * cin + c] = inp[c];
    __syncthreads();
    if (tid == 0) heads[buf] = (h + 1) % rows;
  } else {
    __syncthreads();
    matvec(W + w_off, W + b_off, x, cin, 2 * cout, y, part, ACT_NONE);
  }
}

// Copy every ring buffer of row b between the carry (logical order) and its
// place; to_carry undoes the rotation by the buffer's head.
__device__ void ring_copy(const FusedDecodeArgs& a, int b, float* ring_sm,
                          float* scratch, const int* heads, bool to_carry) {
  float* carry = a.ring + (size_t)b * a.ring_floats;
  for (int buf = 0; buf < a.n_buf; ++buf) {
    const int* d = a.bufs + buf * BUF_WORDS;
    const int rows = d[0], width = d[1];
    float* place = ring_at(a, buf, ring_sm, scratch);
    const int h = to_carry ? heads[buf] : 0;
    for (int idx = threadIdx.x; idx < rows * width; idx += NT) {
      const int r = idx / width, c = idx % width;
      float* phys = place + ((h + r) % rows) * width + c;
      if (to_carry) carry[d[2] + idx] = *phys;
      else *phys = carry[d[2] + idx];
    }
  }
}

__global__ void __launch_bounds__(NT, 1)
fused_decode_kernel(const FusedDecodeArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout L = layout(a);
  float* ring_sm = sm + L.ring;
  float* x = sm + L.x;
  float* inp = sm + L.inp;
  float* y = sm + L.y;
  float* cat = sm + L.cat;
  float* res = sm + L.res;
  float* q = sm + L.q;
  float* qs = sm + L.qs;
  float* fpe = sm + L.fpe;
  float* qp = sm + L.qp;
  float* ctx = sm + L.ctx;
  float* s = sm + L.s;
  float* ave = sm + L.ave;
  float* part = sm + L.part;
  float* red = sm + L.red;
  int* heads = reinterpret_cast<int*>(sm + L.ints);
  int* la = heads + a.n_buf;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const float* W = a.weights;
  // read before the barrier below; thread 0 writes the advanced count last
  const int pos0 = a.pos ? a.pos[b] : 0;
  const float ctx_scale = a.row_scale ? a.row_scale[b] : a.ctx_scale;
  const float* addmask = a.addmask + (size_t)b * a.Tk;
  float* scratch = a.scratch + (size_t)b * a.scratch_floats;

  // carry in: ring buffers arrive in logical order, so every head is 0
  ring_copy(a, b, ring_sm, scratch, heads, false);
  if (tid < a.n_buf) heads[tid] = 0;
  if (tid < a.n_la) la[tid] = a.la[b * a.n_la + tid];
  for (int i = tid; i < a.out_dim; i += NT) x[i] = a.prev[b * a.out_dim + i];
  __syncthreads();

  for (int step = 0; step < a.steps; ++step) {
    const int t = a.t0 + step;
    const float* row =
        a.fpe + (size_t)(a.pos ? min(pos0 + step + 1, a.fpe_rows - 1) : t) *
                    a.C;
    if (a.fpe_raw) {
      const float wq = a.wq[b];
      for (int c = tid; c < a.C; c += NT) {
        const float v = wq * row[c];
        fpe[c] = (c & 1) ? cosf(v) : sinf(v);
      }
    } else {
      for (int c = tid; c < a.C; c += NT) fpe[c] = row[c];
    }
    for (int k = tid; k < a.Tk; k += NT) ave[k] = 0.0f;
    __syncthreads();

    for (int i = 0; i < a.n_ops; ++i) {
      const int* op = a.ops + i * OP_WORDS;
      switch (op[0]) {
        case OP_LINEAR: {
          const int act = op[1], K = op[2], N = op[3];
          matvec(W + op[4], W + op[5], x, K, N, y, part, act);
          for (int o = tid; o < N; o += NT) x[o] = y[o];
          __syncthreads();
          break;
        }
        case OP_LINEAR2: {
          const int act = op[1], K = op[2], N = op[3];
          matvec2(W + op[4], x, K, W + op[5], qs, K, W + op[6], N, y, part,
                  act);
          for (int o = tid; o < N; o += NT) x[o] = y[o];
          __syncthreads();
          break;
        }
        case OP_GLU: {
          const int resid = op[3], cout = op[6], slot = op[9];
          causal_conv(a, W, op[7], op[8], op[1], op[2], op[4], op[5], cout,
                      x, inp, cat, y, part, heads, ring_sm, scratch);
          const float* bias =
              slot >= 0 ? a.sp + ((size_t)slot * a.B + b) * a.sp_width
                        : nullptr;
          for (int o = tid; o < cout; o += NT) {
            const float val = bias ? y[o] + bias[o] : y[o];
            float v = val * sigmoid_f(y[cout + o]);
            if (resid) v = (v + inp[o]) * SQRT_HALF;
            x[o] = v;
          }
          __syncthreads();
          break;
        }
        case OP_HIGHWAY: {
          const int glu = op[4], width = op[5];
          causal_conv(a, W, op[6], op[7], op[1], op[2], op[3], width, width,
                      x, inp, cat, y, part, heads, ring_sm, scratch);
          for (int o = tid; o < width; o += NT) {
            const float gate = sigmoid_f(y[width + o]);
            x[o] = glu ? (y[o] * gate + inp[o]) * SQRT_HALF
                       : gate * y[o] + (1.0f - gate) * inp[o];
          }
          __syncthreads();
          break;
        }
        case OP_SAVE_RES: {
          for (int c = tid; c < a.C; c += NT) res[c] = x[c];
          __syncthreads();
          break;
        }
        case OP_RESIDUAL: {
          for (int c = tid; c < a.C; c += NT) x[c] = (x[c] + res[c]) * SQRT_HALF;
          __syncthreads();
          break;
        }
        case OP_SAVE_Q: {
          for (int c = tid; c < a.C; c += NT) qs[c] = x[c];
          __syncthreads();
          break;
        }
        case OP_ATTN: {
          const int a_idx = op[1], mono = op[2], back = op[3], ahead = op[4];
          const int Tk = a.Tk, E = a.E;
          for (int c = tid; c < a.C; c += NT) q[c] = x[c] + fpe[c];
          __syncthreads();
          matvec(W + op[5], W + op[6], q, a.C, E, qp, part, ACT_NONE);
          const float* keys =
              a.kv + ((size_t)(2 * a_idx) * a.B + b) * (size_t)Tk * E;
          const float* vals =
              a.kv + ((size_t)(2 * a_idx + 1) * a.B + b) * (size_t)Tk * E;
          for (int k = warp; k < Tk; k += NW) {
            float acc = 0.0f;
            for (int e = lane; e < E; e += 32)
              acc += __ldg(keys + (size_t)k * E + e) * qp[e];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
              acc += __shfl_xor_sync(0xffffffffu, acc, off);
            if (lane == 0) s[k] = acc + addmask[k];
          }
          __syncthreads();
          const int la_i = la[a_idx];
          float m = -INFINITY;
          for (int k = tid; k < Tk; k += NT) {
            if (mono && (k < la_i - back || k >= la_i + ahead)) s[k] = MASK;
            m = fmaxf(m, s[k]);
          }
          m = block_reduce<true>(m, red);
          float sum = 0.0f;
          for (int k = tid; k < Tk; k += NT) {
            const float p = expf(s[k] - m);
            s[k] = p;
            sum += p;
          }
          sum = block_reduce<false>(sum, red);
          float pmax = -INFINITY;
          for (int k = tid; k < Tk; k += NT) {
            s[k] = s[k] / sum;
            pmax = fmaxf(pmax, s[k]);
          }
          if (mono) {
            // first index of the row max (jnp.argmax semantics)
            pmax = block_reduce<true>(pmax, red);
            float first = (float)Tk;
            for (int k = tid; k < Tk; k += NT)
              if (s[k] >= pmax) first = fminf(first, (float)k);
            first = block_min(first, red);
            if (tid == 0) la[a_idx] = (int)first;
          }
          __syncthreads();
          for (int e = tid; e < E; e += NT) {
            float acc = 0.0f;
            for (int k = 0; k < Tk; ++k)
              acc += s[k] * __ldg(vals + (size_t)k * E + e);
            ctx[e] = acc * ctx_scale;
          }
          for (int k = tid; k < Tk; k += NT) ave[k] += s[k];
          __syncthreads();
          matvec(W + op[7], W + op[8], ctx, E, a.C, y, part, ACT_NONE);
          for (int c = tid; c < a.C; c += NT) x[c] = (y[c] + q[c]) * SQRT_HALF;
          __syncthreads();
          break;
        }
        default:
          break;
      }
    }

    const size_t orow = (size_t)b * a.T_total + t;
    for (int c = tid; c < a.C; c += NT) a.dstate[orow * a.C + c] = x[c];
    matvec(W + a.last_w, W + a.last_b, x, a.C, a.out_dim, y, part, ACT_NONE);
    matvec(W + a.fc_w, W + a.fc_b, y, a.out_dim, 1, inp, part, ACT_NONE);
    for (int o = tid; o < a.out_dim; o += NT) {
      const float v = sigmoid_f(y[o]);
      a.out[orow * a.out_dim + o] = v;
      x[o] = v;
    }
    if (tid == 0) a.done[orow] = sigmoid_f(inp[0]);
    for (int k = tid; k < a.Tk; k += NT)
      a.align[orow * a.Tk + k] = ave[k] / (float)a.n_la;
    __syncthreads();
  }

  // carry out, ring buffers back in logical order
  for (int i = tid; i < a.out_dim; i += NT) a.prev[b * a.out_dim + i] = x[i];
  if (tid < a.n_la) a.la[b * a.n_la + tid] = la[tid];
  if (a.pos && tid == 0) a.pos[b] = min(pos0 + a.steps, 1 << 30);
  ring_copy(a, b, ring_sm, scratch, heads, true);
}

}  // namespace

// Dynamic shared memory one launch with these arguments takes, in bytes.
extern "C" int dv3_fused_decode_smem_bytes(const FusedDecodeArgs* a) {
  return layout(*a).total * (int)sizeof(float);
}

// The most dynamic shared memory a block may have on `device`, in bytes
// (negative: a CUDA error code).
extern "C" int dv3_fused_decode_max_smem(int device) {
  int bytes = 0;
  const cudaError_t e = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return e == cudaSuccess ? bytes : -(int)e;
}

extern "C" int dv3_fused_decode(const FusedDecodeArgs* a, void* stream,
                                int device) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const int bytes = layout(*a).total * (int)sizeof(float);
  e = cudaFuncSetAttribute(fused_decode_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  fused_decode_kernel<<<a->B, NT, bytes, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

extern "C" const char* dv3_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
