# coding: utf-8
"""Fused autoregressive decode: kernel B1, counterpart of
deepvoice3_pytorch_tpu/ops/fused_decode.py.

`fused_decode` dispatches on the device of its tensors:
  * CPU  -> `fused_decode_plain`: the same host loop over `PlainDecoder`,
    the decoder family's eager `make_decoder_step` (models/deepvoice3.py
    or models/nyanko.py);
  * CUDA -> the hand-written kernel `csrc/fused_decode.cu`, driven chunk by
    chunk from the host through `FusedDecoder`; nothing falls back.

Both run `chunk` frames between checks of the done latch (the rule
`done > 0.5 and t+1 > min_steps`, at chunk granularity) and stop after the
first chunk in which every sample has finished; the latch costs one small
device-to-host read per chunk. Given `test_inputs` (B, T, out_dim), both
run teacher-forced instead (the JAX package's `decode_scan(test_inputs=)`):
T frames, one a launch, the carry's previous frame set to the teacher's
frame t before frame t; the kernel is the same, since it reads its input
frame from the carry at every launch.

`FusedDecoder` is the public launch-and-carry interface: it takes the
packed plan (`packed_plan`: the op table compiled into the kernel's stages,
`b1_stages`, and the folded weights split by output column over the
launch's blocks, `b1_layout`; built once per parameter set and cached on
the parameter tensors' identities and version counters), packs K/V and
mask, and launches one chunk at a time, one cooperative launch over the
whole card, from an explicit `DecodeCarry` (previous frame, last_attended,
ring buffers), so a streaming caller can resume a decode where it stopped.
`PlainDecoder` has the same interface over the plain step for CPU tensors;
`make_decoder` picks the one for the inputs' device.

Continuous batching (serving.py) decodes a batch of slots, each at its own
point of its own utterance. `SlotDecoder` is B1 in its serving modes: the
packed plan is shared with every decoder of the same parameters, the
per-slot inputs (`SlotInputs`: K/V, additive mask, position rates, speaker
biases, context scales, and for the kernel the K/V folded with the
attention projections) belong to the caller, which rewrites and folds one
row at each admission (`write_slot_row`) and pads the text dimension when
a longer text arrives (`grow_slot_inputs`; the attention scratch follows the
new Tk at the next launch), and every row reads the position-table row of
its own decoded count, which the launch advances (`SlotCarry.pos`).
`PlainSlotDecoder` is its plain version with the same interface;
`make_slot_decoder` picks the one for the device.
"""

import ctypes
import math
import weakref
from collections import OrderedDict
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import _build
from ..models import deepvoice3 as dv3
from ..models import nyanko as nk
from ..models.decode import chunk_latch
from ..utils import profiling
from . import core

MASK = -1.0e9
DEFAULT_CHUNK = 32

OP_WORDS = 10
(OP_LINEAR, OP_GLU, OP_ATTN, OP_SAVE_RES, OP_RESIDUAL, OP_HIGHWAY,
 OP_LINEAR2, OP_SAVE_Q) = range(8)
_ACT = {None: 0, "relu": 1, "sigmoid": 2}


class FusedDecodeOut(NamedTuple):
    outputs: Any          # (B, max_steps, out_dim); frames past the stop zero
    alignments: Any       # (B, max_steps, Tk)
    done: Any             # (B, max_steps)
    decoder_states: Any   # (B, max_steps, C)
    num_steps: int        # frames computed: min(launches x chunk, max_steps)
    last_attended: Any    # (B, n_att) int32 after the last computed frame


class DecodeCarry(NamedTuple):
    prev: Any             # (B, out_dim) f32 previous frame
    last_attended: Any    # (B, max(n_att, 1)) int32
    ring: Any             # (B, ring_floats) f32, ring buffers in logical order


class SlotCarry(NamedTuple):
    prev: Any             # (S, out_dim) f32 previous frame
    last_attended: Any    # (S, max(n_att, 1)) int32
    ring: Any             # (S, ring_floats) f32, ring buffers in logical order
    pos: Any              # (S,) int32 frames each slot has decoded


def family(cfg):
    """The model module of a decoder config: models.nyanko or
    models.deepvoice3."""
    return nk if isinstance(cfg, nk.NyankoDecoderConfig) else dv3


def state_dim(cfg):
    """Width of the decoder state (the input of last_conv)."""
    if family(cfg) is nk:
        return cfg.channels
    return cfg.convolutions[0][0]


# ---------------------------------------------------------------------------
# plan: op table + packed folded weights
# ---------------------------------------------------------------------------


class Plan(NamedTuple):
    ops: Any              # (n_ops, OP_WORDS) int32
    buffers: tuple        # ((rows, width, offset), ...) ring buffers
    weights: Any          # (n,) f32, every block 16-byte aligned
    last: tuple           # (w offset, b offset) of last_conv
    fc: tuple             # (w offset, b offset) of fc
    n_att: int
    sp_widths: tuple      # cout of each speaker-bias slot (multi-speaker GLU)


def build_plan(params, cfg):
    """Decoder params + config -> Plan (weight norms folded here).

    Ops, as OP_WORDS ints each:
      LINEAR   act, K, N, w, b                 x <- act(x @ W + b)
      GLU      kw, dil, residual, buf, cin, cout, w, b, speaker slot (-1
               none)                           causal GLU conv vs ring buf
      HIGHWAY  kw, dil, buf, glu, width, w, b  causal highway conv
      ATTN     layer, monotonic, back, ahead, wq, bq, wo, bo
      SAVE_RES / RESIDUAL                      outer residual * sqrt(1/2)
      SAVE_Q                                   keep x as Q (nyanko)
      LINEAR2  act, K, N, w_top, w_bot, b      x <- act(x @ W_top
                                               + Q @ W_bot + b)
    Dispatches on the config's family, as the JAX build_plan does: the
    DeepVoice3 prenet / conv+attention stack, or nyanko's audio encoder /
    attention / audio decoder.
    """
    chunks, offset = [], [0]
    ops, buffers = [], []
    sp_widths = []

    def push(t):
        flat = t.reshape(-1).float()
        start = offset[0]
        pad = (-flat.numel()) % 4
        chunks.append(flat)
        if pad:
            chunks.append(flat.new_zeros(pad))
        offset[0] += flat.numel() + pad
        return start

    def op(*words):
        ops.append(list(words) + [0] * (OP_WORDS - len(words)))

    def conv(p, s):
        """Folded (kw, cin, 2*cout) weights and the layer's ring buffer
        (-1 for kw = 1)."""
        w = core.conv1d_weight(p["conv"])
        buf = -1
        if s.kernel_size > 1:
            rows = (s.kernel_size - 1) * s.dilation
            ring_off = sum(r * c for r, c, _ in buffers)
            buffers.append((rows, s.in_channels, ring_off))
            buf = len(buffers) - 1
        return w, buf

    def linear(p, s):
        w = core.conv1d_weight(p["conv"])[0]
        op(OP_LINEAR, _ACT[s.activation], w.shape[0], w.shape[1], push(w),
           push(p["conv"]["b"]))

    def glu(p, s, residual):
        w, buf = conv(p, s)
        slot = -1
        if s.speaker_proj:
            slot = len(sp_widths)
            sp_widths.append(s.out_channels)
        op(OP_GLU, s.kernel_size, s.dilation, int(residual), buf,
           s.in_channels, s.out_channels, push(w), push(p["conv"]["b"]), slot)

    def highway(p, s):
        if s.in_channels != s.out_channels:
            raise ValueError("fused decode: a highway layer keeps its width "
                             "(%d -> %d)" % (s.in_channels, s.out_channels))
        w, buf = conv(p, s)
        op(OP_HIGHWAY, s.kernel_size, s.dilation, buf, int(s.highway_glu),
           s.in_channels, push(w), push(p["conv"]["b"]))

    def attn(p_attn, idx, monotonic, spec):
        wq = core.linear_weight(p_attn["query_proj"])
        wo = core.linear_weight(p_attn["out_proj"])
        op(OP_ATTN, idx, int(monotonic), spec.window_backward,
           spec.window_ahead, push(wq), push(p_attn["query_proj"]["b"]),
           push(wo), push(p_attn["out_proj"]["b"]))

    def stack(plist, specs):
        for p, s in zip(plist, specs):
            if s.kind == "conv1x1":
                linear(p, s)
            elif s.kind == "glu":
                glu(p, s, s.residual)
            elif s.kind == "highway":
                highway(p, s)
            else:
                raise ValueError("fused decode: spec kind %s" % s.kind)

    if family(cfg) is nk:
        stack(params["audio_encoder"], cfg.audio_encoder)
        op(OP_SAVE_Q)
        attn(params["attention"], 0, cfg.force_monotonic_attention,
             cfg.attention_spec)
        n_att = 1
        # the first audio-decoder layer takes concat([R, Q]): its (2D -> D)
        # weight is split into the R and Q halves
        s0 = cfg.audio_decoder[0]
        if s0.kind != "conv1x1":
            raise ValueError("fused decode: nyanko's audio decoder must "
                             "start with a 1x1 conv")
        p0 = params["audio_decoder"][0]
        w = core.conv1d_weight(p0["conv"])[0]           # (2D, D)
        D = w.shape[0] // 2
        op(OP_LINEAR2, _ACT[s0.activation], D, w.shape[1], push(w[:D]),
           push(w[D:]), push(p0["conv"]["b"]))
        stack(params["audio_decoder"][1:], cfg.audio_decoder[1:])
    else:
        stack(params["prenet"], cfg.prenet_specs)
        n_att = 0
        for idx, (p, s, p_attn, a_spec) in enumerate(zip(
                params["convs"], cfg.conv_specs,
                dv3.attention_params(params, cfg),
                cfg.attention_specs)):
            op(OP_SAVE_RES)
            glu(p, s, False)
            if a_spec is not None:
                attn(p_attn, n_att, cfg.force_monotonic_attention[idx],
                     a_spec)
                n_att += 1
            op(OP_RESIDUAL)

    w_last = core.conv1d_weight(params["last_conv"])[0]
    last = (push(w_last), push(params["last_conv"]["b"]))
    fc = (push(core.linear_weight(params["fc"])), push(params["fc"]["b"]))
    device = w_last.device
    return Plan(torch.tensor(ops, dtype=torch.int32, device=device),
                tuple(buffers), torch.cat(chunks).contiguous(), last, fc,
                n_att, tuple(sp_widths))


# ---------------------------------------------------------------------------
# the kernel's stages: the op table compiled for one persistent launch
# ---------------------------------------------------------------------------

ST_WORDS = 32           # csrc/fused_decode.cu:ST_WORDS
(K_MV, K_ATT) = range(2)
(E_LIN, E_GLU, E_HW, E_LAST) = range(4)
(S_KIND, S_EPI, S_K, S_U, S_PAIRED, S_IN, S_IN2, S_OUT, S_RES, S_RING,
 S_KW, S_DIL, S_CIN, S_FLAG, S_SLOT, S_BIAS, S_NCP, S_WOFF, S_RESIDENT,
 S_ROT, S_AIDX, S_MONO, S_BACK, S_AHEAD, S_RINGW, S_DSTATE,
 S_QOUT) = range(27)
BUF_PREV0, BUF_PREV1, BUF_FPE = range(3)
IN_PREV = -1            # a stage input: the step's previous frame
_THREADS = 512          # csrc/fused_decode.cu:NT
_WARPS = _THREADS // 32
_RB = 32                # csrc/fused_decode.cu:RB
_WIN_MAX = 64           # csrc/fused_decode.cu:WIN_MAX
SMEM_LIMIT = 232448     # dynamic shared memory a block may have on an H100


class Stage(NamedTuple):
    words: list           # ST_WORDS ints; layout fields filled by b1_layout
    ops: tuple            # indices of the op-table entries it carries out
    w_offs: tuple         # offsets in plan.weights of its weights: the
                          # (K, N) matrix, LINEAR2's two halves, last_conv's
                          # and fc's, an attention's wq, bq and wo


def b1_stages(plan, C, out_dim):
    """The op table as the kernel's stages, a grid barrier after each:
    every matrix-vector product is an MV stage (LINEAR, LINEAR2, the GLU /
    highway conv over [taps | x], last_conv), its elementwise ops fused
    into its epilogue (SAVE_RES / RESIDUAL, SAVE_Q become buffer
    references); each attention layer is one ATT stage, its query and out
    projections folded into the keys and values once a decode
    (`attention_operands`); the last stage is last_conv with fc folded in
    as one more output unit. The stage before a conv writes its output
    into the conv's ring buffer (S_RINGW), the stage before an attention
    also its output plus the position rows, the query (S_QOUT), and the
    stage before the last one the decoder state (S_DSTATE). Returns
    (stages, widths of the workspace buffers: the three fixed ones, then
    one per stage output and query)."""
    widths = [out_dim, out_dim, C]               # BUF_PREV0/1, FPE
    stages = []

    def new_buf(width):
        widths.append(width)
        return len(widths) - 1

    def stage(kind, epi, ops, w_offs=(), **kw):
        words = [0] * ST_WORDS
        for i in (S_IN2, S_OUT, S_RES, S_RING, S_SLOT, S_RINGW, S_QOUT):
            words[i] = -1
        words[S_KIND], words[S_EPI] = kind, epi
        for name, value in kw.items():
            words[globals()["S_" + name.upper()]] = value
        stages.append(Stage(words, tuple(ops), tuple(w_offs)))
        return words

    x, res, qs, pending = IN_PREV, None, None, []
    producer = None          # words of the stage that made x
    for i, op in enumerate(plan.ops.tolist()):
        kind = op[0]
        if kind == OP_SAVE_RES:
            res = x
            pending.append(i)
            continue
        if kind == OP_SAVE_Q:
            qs = x
            pending.append(i)
            continue
        if kind == OP_RESIDUAL:
            if producer is None or res is None or producer[S_RES] >= 0:
                raise ValueError("fused decode: RESIDUAL at op %d follows "
                                 "no stage since its SAVE_RES" % i)
            producer[S_RES] = res
            stages[-1] = stages[-1]._replace(ops=stages[-1].ops + (i,))
            res = None
            continue
        ops = tuple(pending) + (i,)
        pending = []
        if kind == OP_LINEAR:
            act, K, N, w, b = op[1:6]
            out = new_buf(N)
            producer = stage(K_MV, E_LIN, ops, (w,), k=K, u=N,
                             **{"in": x}, out=out, flag=act, bias=b)
        elif kind == OP_LINEAR2:
            act, K, N, w_top, w_bot, b = op[1:7]
            if qs is None:
                raise ValueError("fused decode: LINEAR2 without SAVE_Q")
            out = new_buf(N)
            producer = stage(K_MV, E_LIN, ops, (w_top, w_bot), k=2 * K, u=N,
                             **{"in": x}, in2=qs, out=out, flag=act, bias=b)
        elif kind == OP_GLU:
            kw_, dil, resid, buf, cin, cout, w, b, slot = op[1:10]
            out = new_buf(cout)
            producer = stage(K_MV, E_GLU, ops, (w,), k=kw_ * cin, u=cout,
                             paired=1, **{"in": x}, out=out, ring=buf,
                             kw=kw_, dil=dil, cin=cin, flag=resid,
                             slot=slot, bias=b)
        elif kind == OP_HIGHWAY:
            kw_, dil, buf, glu_, width, w, b = op[1:8]
            out = new_buf(width)
            producer = stage(K_MV, E_HW, ops, (w,), k=kw_ * width, u=width,
                             paired=1, **{"in": x}, out=out, ring=buf,
                             kw=kw_, dil=dil, cin=width, flag=glu_, bias=b)
        elif kind == OP_ATTN:
            idx, mono, back, ahead, wq, bq, wo, bo = op[1:9]
            if producer is None:
                raise ValueError("fused decode: an attention reads the "
                                 "previous frame directly")
            q = new_buf(C)                  # x + the position rows
            producer[S_QOUT] = q
            out = new_buf(C)
            producer = stage(K_ATT, 0, ops, (wq, bq, wo), **{"in": q},
                             out=out, aidx=idx, mono=mono, back=back,
                             ahead=ahead, bias=bo)
        else:
            raise ValueError("fused decode: op kind %d" % kind)
        x = out
    if x == IN_PREV:
        raise ValueError("fused decode: an empty op table")
    stage(K_MV, E_LAST, tuple(pending), (plan.last[0], plan.fc[0]), k=C,
          u=out_dim + 1, **{"in": x}, bias=plan.last[1])
    stages[-2].words[S_DSTATE] = 1
    for i, st in enumerate(stages):
        if st.words[S_RING] >= 0:
            if i == 0:
                raise ValueError("fused decode: a conv reads the previous "
                                 "frame directly")
            stages[i - 1].words[S_RINGW] = st.words[S_RING]
    return stages, widths


def b1_stage_kinds(stages):
    """The kind of each stage, by the op-table entry it carries out:
    "LINEAR", "LINEAR2", "GLU", "HIGHWAY" or "ATTN"; the last stage
    (last_conv with fc folded in), which carries no entry of its own,
    counts as "LINEAR". Read from the stages' words, on the host."""
    kinds = []
    for st in stages:
        w = st.words
        if w[S_KIND] == K_ATT:
            kinds.append("ATTN")
        elif w[S_EPI] == E_GLU:
            kinds.append("GLU")
        elif w[S_EPI] == E_HW:
            kinds.append("HIGHWAY")
        elif w[S_EPI] == E_LIN and w[S_IN2] >= 0:
            kinds.append("LINEAR2")
        else:
            kinds.append("LINEAR")
    return tuple(kinds)


def attention_weights(plan, stages, C):
    """The attention layers' projections, stacked for attention_operands:
    (n_att, 2, E, C + 1) float64, [Wq^T | bq] and [Wo | 0] of each layer
    (Wq (C, E) the query projection, bq its bias, Wo (E, C) the out
    projection); None without an attention layer."""
    w = plan.weights
    mats = []
    for st in stages:
        if st.words[S_KIND] != K_ATT:
            continue
        o_wq, o_bq, o_wo = st.w_offs
        E = (o_bq - o_wq) // C
        wq = w[o_wq:o_wq + C * E].view(C, E)
        wo = w[o_wo:o_wo + E * C].view(E, C)
        mats.append(torch.stack([
            torch.cat([wq.T, w[o_bq:o_bq + E][:, None]], 1),
            torch.cat([wo, wo.new_zeros(E, 1)], 1)]))
    return torch.stack(mats).double().contiguous() if mats else None


def attention_operands(att_w, kv):
    """The attention layers' query and out projections folded into their
    keys and values, once a decode: for layer a with keys K and values V
    (kv[a], each (B, Tk, E)), K [Wq^T | bq] and V [Wo | 0] (att_w: the
    layout's attention_weights), one f32 (n_att, 2, B, Tk, C + 1) tensor,
    summed in float64 and rounded once, as fc's fold into last_conv is.
    The kernel scores q . (K Wq^T)[k] + (K bq)[k] and takes the output
    sum_k p_k (V Wo)[k]."""
    if att_w is None:
        return kv.new_zeros(1)
    return torch.matmul(kv.double(), att_w[:, :, None]).to(
        kv.dtype).contiguous()


def stage_weight(plan, st):
    """The (K, N) weight and (N,) bias of an MV stage, from plan.weights: a
    LINEAR2 stage's two halves stacked; the last stage's fc column is
    W_last @ w_fc with bias b_last . w_fc + b_fc, summed in float64."""
    K, U = st.words[S_K], st.words[S_U]
    N = 2 * U if st.words[S_PAIRED] else U
    w, b = plan.weights, st.words[S_BIAS]
    if st.words[S_EPI] == E_LAST:
        o_last, o_fc = st.w_offs
        W = w[o_last:o_last + K * (N - 1)].view(K, N - 1)
        bias = w[b:b + N - 1]
        w_fc, b_fc = w[o_fc:o_fc + N - 1].double(), w[plan.fc[1]].double()
        return (torch.cat([W, (W.double() @ w_fc).float()[:, None]], 1),
                torch.cat([bias, (bias.double() @ w_fc + b_fc)
                           .float()[None]]))
    if len(st.w_offs) == 2:
        W = torch.cat([w[o:o + K // 2 * N].view(K // 2, N)
                       for o in st.w_offs])
    else:
        W = w[st.w_offs[0]:st.w_offs[0] + K * N].view(K, N)
    return W, w[b:b + N]


def block_units(U, grid, rot, j):
    """Output units [u0, u1) of block j in a stage of U units: the units cut
    into `grid` contiguous parts, block j taking part (j - rot) mod grid
    (csrc/fused_decode.cu:block_units)."""
    p = (j + grid - rot % grid) % grid
    return U * p // grid, U * (p + 1) // grid


def stage_columns(U, paired, grid, rot):
    """(grid, ncp) weight columns of each block's slice of a stage, -1 for
    padding: its units, and for a paired stage (GLU, highway) their gate
    columns U + u after them; ncp, the slice's width, is the widest block's
    rounded up to a power of two (the kernel's work split shifts where it
    would divide)."""
    width = -(-U // grid) * (2 if paired else 1)
    ncp = 1 << (width - 1).bit_length()
    idx = np.full((grid, ncp), -1, np.int64)
    for j in range(grid):
        u0, u1 = block_units(U, grid, rot, j)
        idx[j, :u1 - u0] = np.arange(u0, u1)
        if paired:
            idx[j, u1 - u0:2 * (u1 - u0)] = U + np.arange(u0, u1)
    return idx, ncp


def _round4(n):
    return (n + 3) & ~3


LA_RESERVE = 64         # ints of last_attended a block may hold


def b1_meta_ints(n_stages, n_bufs, n_ring, la_ints=LA_RESERVE):
    """4-byte words of a block's shared memory that hold the tables, the
    block's units of each stage, the rings' heads and its rows'
    last_attended: the mirror of csrc/fused_decode.cu:meta_ints."""
    return _round4(n_stages * (ST_WORDS + 2) + 2 * n_bufs + 5 * n_ring
                   + la_ints)


def b1_smem_floats(meta, resident, max_ncp):
    """4-byte words of dynamic shared memory a block takes: the mirror of
    csrc/fused_decode.cu:smem_floats (the decoders check the two
    agree)."""
    return (meta + _round4(resident) + _RB * max_ncp + _WARPS * 8
            + _WIN_MAX + 40)


class B1Layout(NamedTuple):
    stages: list          # Stage, words complete
    widths: list          # workspace buffer widths
    table: Any            # (n_stages, ST_WORDS) int32
    widths_t: Any         # (n_bufs,) int32, the widths on the device
    att_w: Any            # attention_weights, or None
    rings: Any            # (n_ring, 4) int32: rows, width, offset in a
                          # carry row, offset in a scratch row (rows + 1
                          # slots each)
    wpack: Any            # (grid, per_block) f32: each block's slices
    grid: int
    per_block: int
    resident: int         # floats of each block's slices in shared memory
    max_ncp: int
    meta: int             # words of the tables (b1_meta_ints, reserved)
    smem_bytes: int       # at most, with LA_RESERVE words of last_attended


def b1_layout(plan, C, out_dim, grid, smem_budget=SMEM_LIMIT):
    """The stages of `plan` on `grid` blocks with each block's slice of
    every MV stage's weights packed once, (K + 1) x ncp floats: the K rows
    of its columns' weights, then their biases. Slices are kept in shared
    memory in stage order while they fit in smem_budget bytes besides the
    kernel's fixed part, the rest is read from device memory each step; a
    block's resident slices come first in its row of `wpack`. A budget
    below the fixed part raises."""
    stages, widths = b1_stages(plan, C, out_dim)
    mv = [st for st in stages if st.words[S_KIND] == K_MV]
    cols, rot = [], 0
    for st in mv:
        st.words[S_ROT] = rot
        idx, ncp = stage_columns(st.words[S_U], st.words[S_PAIRED], grid,
                                 rot)
        st.words[S_NCP] = ncp
        cols.append(idx)
        rot = (rot + st.words[S_U]) % grid
    max_ncp = max(st.words[S_NCP] for st in mv)
    meta = b1_meta_ints(len(stages), len(widths), len(plan.buffers))
    budget = smem_budget // 4 - b1_smem_floats(meta, 0, max_ncp)
    if budget < 0:
        raise ValueError(
            "fused_decode: the kernel needs %d bytes of shared memory "
            "besides its weights, more than the budget of %d"
            % (4 * b1_smem_floats(meta, 0, max_ncp), smem_budget))
    sizes = [_round4((st.words[S_K] + 1) * st.words[S_NCP]) for st in mv]
    used = 0
    for st, size in zip(mv, sizes):
        st.words[S_RESIDENT] = int(used + size <= budget)
        used += size if st.words[S_RESIDENT] else 0
    off, order = 0, sorted(range(len(mv)),
                           key=lambda i: (not mv[i].words[S_RESIDENT], i))
    for i in order:
        mv[i].words[S_WOFF] = off
        off += sizes[i]
    slices = []
    for i in order:
        W, bias = stage_weight(plan, mv[i])
        W = torch.cat([W, bias[None]])
        K, N = W.shape
        idx = torch.from_numpy(np.where(cols[i] < 0, N, cols[i]))
        Wz = torch.cat([W, W.new_zeros(K, 1)], 1)
        sl = Wz[:, idx.reshape(-1).to(W.device)].view(K, grid, -1) \
            .permute(1, 0, 2).reshape(grid, -1)
        slices.append(torch.nn.functional.pad(sl, (0, sizes[i]
                                                   - sl.shape[1])))
    dev = plan.weights.device
    rings, slot_off = [], 0
    for r, c, carry_off in plan.buffers:
        rings.append([r, c, carry_off, slot_off])
        slot_off += (r + 1) * c
    rings = torch.tensor(rings or [[0, 0, 0, 0]], dtype=torch.int32,
                         device=dev)
    table = torch.tensor([st.words for st in stages], dtype=torch.int32,
                         device=dev)
    return B1Layout(stages, widths, table,
                    torch.tensor(widths, dtype=torch.int32, device=dev),
                    attention_weights(plan, stages, C), rings,
                    torch.cat(slices, 1).contiguous(), grid, off, used,
                    max_ncp, meta, 4 * b1_smem_floats(meta, used, max_ncp))


# the packed plans of the parameter sets in use: (params, cfg, grid,
# budget, the tensors' identities and versions) -> (weak references to the
# tensors, (Plan, B1Layout)); the few most recent kept
_PACKED = OrderedDict()
_PACKED_KEEP = 8


def _version(t):
    """t's version counter (bumped by every in-place write), None for an
    inference tensor, which keeps none."""
    return None if t.is_inference() else t._version


def _param_tensors(params):
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, dict):
        return [t for v in params.values() for t in _param_tensors(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in _param_tensors(v)]
    return [params] if isinstance(params, torch.Tensor) else []


def packed_plan(params, cfg, grid, smem_budget=SMEM_LIMIT):
    """(Plan, B1Layout) of a decoder's parameters, built once per parameter
    set: cached on the identity and the version counter of every parameter
    tensor, so an in-place update of any weight rebuilds it."""
    tensors = _param_tensors(params)
    try:
        hash(cfg)
        cfg_key = cfg
    except TypeError:
        cfg_key = id(cfg)
    key = (id(params), cfg_key, grid, smem_budget,
           tuple((id(t), _version(t)) for t in tensors))
    hit = _PACKED.get(key)
    if hit is not None and all(r() is t for r, t in zip(hit[0], tensors)):
        _PACKED.move_to_end(key)
        return hit[1]
    plan = build_plan(params, cfg)
    layout = b1_layout(plan, state_dim(cfg), cfg.in_dim * cfg.r, grid,
                       smem_budget)
    packed = (plan, layout)
    _PACKED[key] = ([weakref.ref(t) for t in tensors], packed)
    while len(_PACKED) > _PACKED_KEEP:
        _PACKED.popitem(last=False)
    return packed


# ---------------------------------------------------------------------------
# kernel binding
# ---------------------------------------------------------------------------


class _B1Args(ctypes.Structure):
    """Mirror of B1Args in csrc/fused_decode.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "stages", "rings", "widths", "wpack", "fpe", "wq",
        "addmask", "kv", "weights", "sp", "row_scale", "prev", "la",
        "ring", "scratch",
        "ws", "att", "out", "align", "done", "dstate", "pos", "sync",
        "trace")]
        + [(n, ctypes.c_int) for n in (
            "n_stages", "n_bufs", "n_ring", "B", "Tk", "C", "out_dim",
            "n_att", "n_la", "ring_floats", "scratch_floats", "sp_width",
            "fpe_raw", "T_total", "t0", "steps", "fpe_rows", "per_block",
            "resident", "max_ncp")]
        + [("ctx_scale", ctypes.c_float)])


KERNEL = _build.Kernel("fused_decode.cu", {
    "dv3_fused_decode": [ctypes.POINTER(_B1Args), ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p, ctypes.c_int],
    "dv3_b1_smem_bytes": [ctypes.c_int] * 6,
    "dv3_b1_device_info": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
})

_DEVICE = {}    # device index -> (SMs, shared memory a block may have)
_SYNC = {}      # (device, stream) -> the grid barrier's two counters


def device_info(dev):
    """(SMs, bytes of dynamic shared memory a block may have) of `dev`."""
    i = dev.index or 0
    if i not in _DEVICE:
        out = (ctypes.c_int * 2)()
        KERNEL.check(KERNEL.lib.dv3_b1_device_info(i, out), "device info")
        _DEVICE[i] = (out[0], out[1])
    return _DEVICE[i]


def _sync_counters(dev, stream):
    """Two uint32 counters for the grid barrier, zeroed once per (device,
    stream): each launch leaves them at zero, and launches on one stream
    never overlap."""
    key = (dev.index or 0, stream.cuda_stream)
    if key not in _SYNC:
        _SYNC[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _SYNC[key]


def _check(t, name, shape, dtype, device):
    if t.device != device or t.dtype != dtype or not t.is_contiguous() \
            or tuple(t.shape) != tuple(shape):
        raise ValueError("fused_decode: %s must be a contiguous %s tensor of "
                         "shape %s on %s (got %s %s %s, contiguous=%s)"
                         % (name, dtype, tuple(shape), device, t.dtype,
                            tuple(t.shape), t.device, t.is_contiguous()))


def _ptr(t):
    return 0 if t is None else t.data_ptr()


class _Decoder:
    """What the launch-and-carry decoders share: B, tk, C, out_dim, dtype
    and device are set by the subclass (a slot decoder passes the text
    length of its inputs as tk)."""

    def new_outputs(self, total, tk=None):
        """Zeroed (outputs, alignments, done, decoder_states) buffers."""
        z = dict(device=self.device, dtype=self.dtype)
        return (torch.zeros(self.B, total, self.out_dim, **z),
                torch.zeros(self.B, total, self.tk if tk is None else tk,
                            **z),
                torch.zeros(self.B, total, **z),
                torch.zeros(self.B, total, self.C, **z))


class _KernelDecoder(_Decoder):
    """What FusedDecoder and SlotDecoder share: the packed plan on `grid`
    blocks (default: one an SM) under smem_budget bytes of shared memory a
    block (default: the device's limit), the workspace and ring scratch of
    B rows, the launch."""

    def _setup(self, params, cfg, B, device, smem_budget, grid):
        if device.type != "cuda":
            raise ValueError("%s runs on CUDA tensors only (got %s)"
                             % (type(self).__name__, device))
        sms, limit = device_info(device)
        self.grid = grid or sms
        self.smem_budget = limit if smem_budget is None else smem_budget
        self.plan, self.layout = packed_plan(params, cfg, self.grid,
                                             self.smem_budget)
        lay = self.layout
        self.device, self.dtype, self.B = device, torch.float32, B
        self.C = state_dim(cfg)
        self.out_dim = cfg.in_dim * cfg.r
        self.n_la = max(self.plan.n_att, 1)
        la_ints = -(-B // lay.grid) * self.n_la
        if la_ints > LA_RESERVE:
            raise ValueError("fused_decode: %d rows on %d blocks hold more "
                             "last_attended than a block keeps (%d)"
                             % (B, lay.grid, LA_RESERVE))
        counts = (len(lay.stages), len(lay.widths), len(self.plan.buffers))
        self.smem_bytes = 4 * b1_smem_floats(
            b1_meta_ints(*counts, la_ints), lay.resident, lay.max_ncp)
        got = KERNEL.lib.dv3_b1_smem_bytes(*counts, la_ints, lay.resident,
                                           lay.max_ncp)
        if got != self.smem_bytes:
            raise RuntimeError("fused_decode: the kernel's shared-memory "
                               "layout (%d bytes) differs from the host's "
                               "(%d)" % (got, self.smem_bytes))
        self.ring_floats = sum(r * c for r, c, _ in self.plan.buffers)
        self.sp_width = max(self.plan.sp_widths or (0,))
        # the kernel lays the buffers out (B, round4(width)) one after the
        # other; no table to upload, so no wait for the stream here
        self.ws = torch.empty(B * sum(_round4(w) for w in lay.widths),
                              device=device)
        self.scratch_floats = sum((r + 1) * c for r, c, _ in
                                  self.plan.buffers)
        self.scratch = torch.empty(B, max(self.scratch_floats, 1),
                                   device=device)
        self.att = None

    def _scores(self, tk):
        """(2, B, tk) scratch of the attention stages."""
        if self.att is None or self.att.shape[2] != tk:
            self.att = torch.empty(2, self.B, tk, device=self.device)
        return self.att

    def _launch(self, entry, ptrs, sizes, trace):
        p, lay, dev = self.plan, self.layout, self.device
        stream = torch.cuda.current_stream(dev)
        if trace is not None:
            _check(trace, "trace", (2 + 3 * sizes["steps"]
                                    * len(lay.stages),), torch.int64, dev)
        args = _B1Args(
            stages=lay.table.data_ptr(), rings=lay.rings.data_ptr(),
            widths=lay.widths_t.data_ptr(), wpack=lay.wpack.data_ptr(),
            weights=p.weights.data_ptr(),
            ring=ptrs.pop("ring"),
            scratch=self.scratch.data_ptr(), ws=self.ws.data_ptr(),
            sync=_sync_counters(dev, stream).data_ptr(), trace=_ptr(trace),
            n_stages=len(lay.stages), n_bufs=len(lay.widths),
            n_ring=len(p.buffers), B=self.B,
            C=self.C, out_dim=self.out_dim, n_att=p.n_att, n_la=self.n_la,
            ring_floats=self.ring_floats,
            scratch_floats=self.scratch_floats, sp_width=self.sp_width,
            per_block=lay.per_block,
            resident=lay.resident, max_ncp=lay.max_ncp, **ptrs, **sizes)
        rc = KERNEL.lib.dv3_fused_decode(ctypes.byref(args), lay.grid,
                                         self.smem_bytes, stream.cuda_stream,
                                         dev.index or 0)
        KERNEL.launched(entry, "persistent")
        KERNEL.check(rc, "fused_decode launch (%s, grid %d)"
                     % (entry, lay.grid))


class FusedDecoder(_KernelDecoder):
    """Launch-invariant state of one decode on the card: the packed plan
    (`packed_plan`: folded weights split by column over `grid` blocks,
    cached per parameter set), the stacked projected K/V, the additive
    mask, the query position rows of frames 1..n_steps
    (`inputs["fpe_table"]`, its last row repeated past its end; raw angles
    with per-row rates when `inputs["fpe_raw"]`, else finished encodings),
    the speaker biases as one (n_sp, B, width) tensor (zeros when a
    multi-speaker model decodes without a speaker, as the plain step then
    adds none), and the workspace. `smem_budget`: bytes of shared memory a
    block for the weights' placement (None: the device's limit); `grid`:
    blocks of the launch (None: the SM count; a grid the card cannot hold
    at once fails at launch)."""

    def __init__(self, params, cfg, inputs, mask, n_steps, smem_budget=None,
                 grid=None):
        kv = [p for p in inputs["projected_kv"] if p is not None]
        keys0 = kv[0][0]
        self.B, self.tk, self.E = keys0.shape
        self._setup(params, cfg, self.B, keys0.device, smem_budget, grid)
        p, dev, f32 = self.plan, self.device, torch.float32
        if p.n_att != len(kv):
            raise ValueError("need %d K/V pairs, got %d" % (p.n_att, len(kv)))
        self.kv = torch.stack([torch.stack([k, v]) for k, v in kv]) \
            .float().contiguous()
        self.addmask = (torch.where(mask, MASK, 0.0).float().contiguous()
                        if mask is not None
                        else torch.zeros(self.B, self.tk, device=dev))
        self.fpe_raw = bool(inputs["fpe_raw"])
        self.wq = (inputs["w_query"].float().contiguous() if self.fpe_raw
                   else None)
        table = inputs["fpe_table"].float()
        if table.shape[0] < n_steps:
            table = torch.cat([table, table[-1:].expand(
                n_steps - table.shape[0], -1)])
        self.fpe = table[:n_steps].contiguous()
        bias = inputs.get("speaker_bias") or []
        if bias and len(bias) != len(p.sp_widths):
            raise ValueError("need %d speaker-bias arrays, got %d"
                             % (len(p.sp_widths), len(bias)))
        self.sp = None
        if p.sp_widths:
            self.sp = torch.zeros(len(p.sp_widths), self.B, self.sp_width,
                                  device=dev)
            for i, (b, w) in enumerate(zip(bias, p.sp_widths)):
                _check(b.float().contiguous(), "speaker_bias[%d]" % i,
                       (self.B, w), f32, dev)
                self.sp[i, :, :w] = b
        if self.fpe_raw:
            _check(self.wq, "w_query", (self.B,), f32, dev)
        _check(self.kv, "kv", (p.n_att, 2, self.B, self.tk, self.E), f32,
               dev)
        _check(self.fpe, "fpe_table", (n_steps, self.C), f32, dev)
        self.kvf = attention_operands(self.layout.att_w, self.kv)
        self._scores(self.tk)

    def zero_carry(self, initial_input):
        return DecodeCarry(
            initial_input.float().contiguous().clone(),
            torch.zeros(self.B, self.n_la, dtype=torch.int32,
                        device=self.device),
            torch.zeros(self.B, self.ring_floats, device=self.device))

    def last_attended(self, carry):
        return carry.last_attended[:, :self.plan.n_att]

    def set_prev(self, carry, frame):
        """Make (B, out_dim) `frame` the next launch's previous frame."""
        carry.prev.copy_(frame)

    def launch(self, carry, outputs, t0, steps, trace=None):
        """Run frames t0 .. t0+steps-1 from `carry`: writes them into
        `outputs` (from new_outputs) and updates `carry` in place. trace:
        None, or an int64 tensor of 2 + 3 * steps * stages entries that
        receives block 0's globaltimer (ns) at the launch's start, after its
        prologue, and for each stage of each step when its products (MV) or
        scores (ATT) are done, when its work ends and when the grid barrier
        after it lets block 0 on."""
        out, align, done, dstate = outputs
        total = out.shape[1]
        if t0 < 0 or t0 + steps > min(total, self.fpe.shape[0]):
            raise ValueError("frames %d..%d exceed the buffers (%d) or the "
                             "position table (%d)" % (
                                 t0, t0 + steps, total, self.fpe.shape[0]))
        f32, dev = torch.float32, self.device
        _check(carry.prev, "prev", (self.B, self.out_dim), f32, dev)
        _check(carry.last_attended, "last_attended", (self.B, self.n_la),
               torch.int32, dev)
        _check(carry.ring, "ring", (self.B, self.ring_floats), f32, dev)
        _check(out, "outputs", (self.B, total, self.out_dim), f32, dev)
        _check(align, "alignments", (self.B, total, self.tk), f32, dev)
        _check(done, "done", (self.B, total), f32, dev)
        _check(dstate, "decoder_states", (self.B, total, self.C), f32, dev)
        self._launch("chunk", dict(
            fpe=self.fpe.data_ptr(), wq=_ptr(self.wq),
            addmask=self.addmask.data_ptr(), kv=self.kvf.data_ptr(),
            sp=_ptr(self.sp), row_scale=0,
            prev=carry.prev.data_ptr(),
            la=carry.last_attended.data_ptr(), ring=carry.ring.data_ptr(),
            att=self.att.data_ptr(), out=out.data_ptr(),
            align=align.data_ptr(), done=done.data_ptr(),
            dstate=dstate.data_ptr(), pos=0), dict(
            Tk=self.tk, fpe_raw=int(self.fpe_raw), T_total=total,
            t0=t0, steps=steps, fpe_rows=self.fpe.shape[0],
            ctx_scale=self.tk * math.sqrt(1.0 / self.tk)), trace)


class PlainDecoder(_Decoder):
    """`FusedDecoder`'s launch-and-carry interface over the plain step (the
    family's `make_decoder_step`): the plain version of kernel B1, which CPU
    tensors take, so that a caller that drives a decode chunk by chunk
    (streaming.tts_stream) is one piece of code on both devices. It runs in
    the dtype of the inputs. The carry is a dict: the previous frame, the
    step state (ring buffers, last_attended, per-row positions) and the
    frame index t; `launch` replaces its entries."""

    def __init__(self, params, cfg, inputs, mask, n_steps):
        keys0 = next(p for p in inputs["projected_kv"] if p is not None)[0]
        self.B, self.tk = keys0.shape[:2]
        self.device, self.dtype = keys0.device, keys0.dtype
        self.C = state_dim(cfg)
        self.out_dim = cfg.in_dim * cfg.r
        self.cfg = cfg
        self.fam = family(cfg)
        self.n_steps = n_steps
        self.att = ([0] if self.fam is nk else
                    [i for i, s in enumerate(cfg.attention_specs)
                     if s is not None])
        self.step_fn = self.fam.make_decoder_step(
            params, cfg, inputs["projected_kv"], inputs["w_query"],
            speaker_embed=inputs.get("speaker_embed"), mask=mask)

    def zero_carry(self, initial_input):
        return {"prev": initial_input.clone(), "t": 0,
                "state": self.fam.decoder_init_state(self.cfg, self.B,
                                                     self.device)}

    def last_attended(self, carry):
        return carry["state"]["last_attended"][:, self.att].to(torch.int32)

    def set_prev(self, carry, frame):
        """Make (B, out_dim) `frame` the next launch's previous frame."""
        carry["prev"] = frame.to(self.dtype)

    def launch(self, carry, outputs, t0, steps, trace=None):
        """Run frames t0 .. t0+steps-1 from `carry` into `outputs`. trace:
        None (the plain version writes no stamps)."""
        total = outputs[0].shape[1]
        if carry["t"] != t0 or t0 + steps > min(total, self.n_steps):
            raise ValueError("frames %d..%d do not follow the carry (frame "
                             "%d) or exceed the buffers (%d)" % (
                                 t0, t0 + steps, carry["t"], total))
        _plain_steps(self.step_fn, carry, outputs, t0, steps)
        carry["t"] = t0 + steps


def _plain_steps(step_fn, carry, outputs, t0, steps):
    """`steps` plain steps from carry {"prev", "state"} into frames t0 ..
    of outputs; replaces the carry's entries."""
    state, prev = carry["state"], carry["prev"]
    for t in range(t0, t0 + steps):
        state, outs = step_fn(state, prev)
        for buf, o in zip(outputs, outs):
            buf[:, t] = o
        prev = outs[0]
    carry["state"], carry["prev"] = state, prev


def make_decoder(params, cfg, inputs, mask, n_steps):
    """The launch-and-carry decoder for the inputs' device: `FusedDecoder`
    (kernel B1) for CUDA tensors, `PlainDecoder` for CPU tensors."""
    kv = next(p for p in inputs["projected_kv"] if p is not None)[0]
    if kv.device.type == "cpu":
        return PlainDecoder(params, cfg, inputs, mask, n_steps)
    return FusedDecoder(params, cfg, inputs, mask, n_steps)


# ---------------------------------------------------------------------------
# the serving modes: a batch of slots, each at its own point of its utterance
# ---------------------------------------------------------------------------


class SlotInputs(NamedTuple):
    """Per-slot decode inputs, owned by the caller: every row is rewritten
    at its slot's admission (`write_slot_row`), the text dimension grows
    with `grow_slot_inputs`. Rows of free slots hold whatever their last
    occupant left; they decode garbage nobody reads."""
    kv: Any               # (n_att, 2, S, Tk, E) f32 projected keys, values
    addmask: Any          # (S, Tk) f32: 0 valid, MASK padded
    w_query: Any          # (S,) f32 query position rates, None for nyanko
    speaker_bias: Any     # (n_sp, S, width) f32 softsign biases, or None
    speaker_embed: Any    # (S, D) speaker embeddings (plain step), or None
    ctx_scale: Any        # (S,) f32 attention context scales
    att_w: Any            # the kernel decoder's attention_weights, or None
                          # (the plain decoder's inputs)
    kvf: Any              # attention_operands(att_w, kv), folded one row
                          # at a time at admission; None without att_w


def slot_inputs(fi, n_slots, tk, att_w=None):
    """Zeroed SlotInputs of n_slots rows and text length tk, shaped like
    the batch-1 inputs `fi` (a family's `fused_decode_inputs`) and in the
    dtype of its keys: masked everywhere, rates and scales 1. att_w: the
    decoder's `att_w` (SlotDecoder's attention_weights, None for
    PlainSlotDecoder); with it the inputs also keep the folded K/V the
    kernel reads."""
    kv = [p for p in fi["projected_kv"] if p is not None]
    E = kv[0][0].shape[-1]
    z = dict(device=kv[0][0].device, dtype=kv[0][0].dtype)
    bias = fi.get("speaker_bias") or []
    se = fi.get("speaker_embed")
    return SlotInputs(
        torch.zeros(len(kv), 2, n_slots, tk, E, **z),
        torch.full((n_slots, tk), MASK, **z),
        torch.ones(n_slots, **z) if fi["fpe_raw"] else None,
        torch.zeros(len(bias), n_slots, max(b.shape[-1] for b in bias),
                    **z) if bias else None,
        None if se is None else torch.zeros(n_slots, se.shape[-1], **z),
        torch.ones(n_slots, **z), att_w,
        None if att_w is None else torch.zeros(
            len(kv), 2, n_slots, tk, att_w.shape[-1], **z))


def write_slot_row(si, b, fi, mask, ctx_scale):
    """Row b of si <- the batch-1 inputs fi with its (1, tk) padding mask
    (K/V and mask right-padded to si's text length, masked there) and the
    context scale ctx_scale, a float rounded to f32 as the kernel's scalar
    is; the row's folded K/V too, when si keeps them. In place."""
    tk = mask.shape[1]
    kv = [p for p in fi["projected_kv"] if p is not None]
    for i, (k, v) in enumerate(kv):
        si.kv[i, 0, b, :tk] = k[0]
        si.kv[i, 1, b, :tk] = v[0]
        si.kv[i, :, b, tk:] = 0.0
    if si.kvf is not None:
        one = slice(b, b + 1)
        si.kvf[:, :, one, :tk] = attention_operands(si.att_w,
                                                    si.kv[:, :, one, :tk])
        si.kvf[:, :, b, tk:] = 0.0
    si.addmask[b] = MASK
    si.addmask[b, :tk] = torch.where(mask[0], MASK, 0.0)
    if si.w_query is not None:
        si.w_query[b] = fi["w_query"][0]
    for i, bias in enumerate(fi.get("speaker_bias") or []):
        si.speaker_bias[i, b, :bias.shape[-1]] = bias[0]
    if si.speaker_embed is not None:
        si.speaker_embed[b] = fi["speaker_embed"][0]
    si.ctx_scale[b] = ctx_scale


def grow_slot_inputs(si, tk):
    """si with its text dimension padded to tk: zero keys and values,
    masked, so every slot decodes as before (its softmax weight there is
    exactly 0 and its context scale is its own)."""
    grow = tk - si.addmask.shape[1]
    if grow <= 0:
        raise ValueError("text length %d does not grow %d"
                         % (tk, si.addmask.shape[1]))

    def pad(t):
        return None if t is None else torch.cat(
            [t, t.new_zeros(t.shape[:3] + (grow,) + t.shape[4:])], dim=3)
    addmask = torch.cat([si.addmask, si.addmask.new_full(
        (si.addmask.shape[0], grow), MASK)], dim=1)
    return si._replace(kv=pad(si.kv), kvf=pad(si.kvf), addmask=addmask)


class SlotDecoder(_KernelDecoder):
    """Kernel B1 in its serving modes over a batch of n_slots rows: the
    packed plan is built once per parameter set; `launch` takes the
    caller's SlotInputs, reads each row's position-table row from the row's
    own decoded count (the whole table: raw angles with the row's rate, or
    finished encodings), scales each row's context by its own scale, and
    advances the counts in the kernel. The attention scratch follows the
    inputs' text length; the carry keeps its logical-order rings across a
    growth. `smem_budget` and `grid` as for FusedDecoder."""

    def __init__(self, params, cfg, n_slots, device, smem_budget=None,
                 grid=None):
        self._setup(params, cfg, n_slots, torch.device(device), smem_budget,
                    grid)
        self.fpe_raw = family(cfg) is dv3
        self.table = params["embed_query_positions"]["w"].float() \
            .contiguous()
        _check(self.table, "position table", (self.table.shape[0], self.C),
               torch.float32, self.device)
        self.att_w = self.layout.att_w
        self.tk = self.E = None

    def zero_carry(self):
        z = dict(device=self.device)
        i32 = torch.int32
        return SlotCarry(torch.zeros(self.B, self.out_dim, **z),
                         torch.zeros(self.B, self.n_la, dtype=i32, **z),
                         torch.zeros(self.B, self.ring_floats, **z),
                         torch.zeros(self.B, dtype=i32, **z))

    def reset_row(self, carry, b):
        """A fresh stream in slot b: zero its carry row (in place)."""
        for t in carry:
            t[b] = 0

    def positions(self, carry):
        return carry.pos

    def launch(self, inputs, carry, outputs, steps, trace=None):
        """Run `steps` frames of every slot from `carry` into frames 0 ..
        steps-1 of `outputs` (new_outputs(steps, Tk)); updates `carry` in
        place, its positions included. trace: as for FusedDecoder."""
        f32, i32, dev = torch.float32, torch.int32, self.device
        p, S = self.plan, self.B
        n_att, tk, E = (inputs.kv.shape[0], inputs.kv.shape[3],
                        inputs.kv.shape[4])
        if n_att != p.n_att:
            raise ValueError("need %d K/V pairs, got %d" % (p.n_att, n_att))
        _check(inputs.kv, "kv", (n_att, 2, S, tk, E), f32, dev)
        if inputs.kvf is None or inputs.att_w is not self.att_w:
            raise ValueError("SlotDecoder: the inputs keep no K/V folded "
                             "with this decoder's weights (slot_inputs(..., "
                             "att_w=decoder.att_w))")
        _check(inputs.kvf, "kvf", (n_att, 2, S, tk, self.C + 1), f32, dev)
        _check(inputs.addmask, "addmask", (S, tk), f32, dev)
        _check(inputs.ctx_scale, "ctx_scale", (S,), f32, dev)
        if self.fpe_raw:
            _check(inputs.w_query, "w_query", (S,), f32, dev)
        if p.sp_widths:
            _check(inputs.speaker_bias, "speaker_bias",
                   (len(p.sp_widths), S, self.sp_width), f32, dev)
        _check(carry.prev, "prev", (S, self.out_dim), f32, dev)
        _check(carry.last_attended, "last_attended", (S, self.n_la), i32,
               dev)
        _check(carry.ring, "ring", (S, self.ring_floats), f32, dev)
        _check(carry.pos, "pos", (S,), i32, dev)
        out, align, done, dstate = outputs
        _check(out, "outputs", (S, steps, self.out_dim), f32, dev)
        _check(align, "alignments", (S, steps, tk), f32, dev)
        _check(done, "done", (S, steps), f32, dev)
        _check(dstate, "decoder_states", (S, steps, self.C), f32, dev)
        self.tk, self.E = tk, E
        self._launch("slots", dict(
            fpe=self.table.data_ptr(),
            wq=_ptr(inputs.w_query if self.fpe_raw else None),
            addmask=inputs.addmask.data_ptr(), kv=inputs.kvf.data_ptr(),
            sp=_ptr(inputs.speaker_bias if p.sp_widths else None),
            row_scale=inputs.ctx_scale.data_ptr(), prev=carry.prev.data_ptr(),
            la=carry.last_attended.data_ptr(), ring=carry.ring.data_ptr(),
            att=self._scores(tk).data_ptr(), out=out.data_ptr(),
            align=align.data_ptr(), done=done.data_ptr(),
            dstate=dstate.data_ptr(), pos=carry.pos.data_ptr()), dict(
            Tk=tk, fpe_raw=int(self.fpe_raw), T_total=steps, t0=0,
            steps=steps, fpe_rows=self.table.shape[0], ctx_scale=1.0), trace)


class PlainSlotDecoder(_Decoder):
    """`SlotDecoder`'s interface over the plain step (the family's
    `make_decoder_step` with per-row positions and context scales): the
    plain version of B1's serving modes, which CPU tensors take. It runs in
    `dtype` (the kernel's comparisons run a float64 one). The carry is a
    dict: the previous frame and the step state, whose `pos` holds each
    row's decoded count."""

    def __init__(self, params, cfg, n_slots, device, dtype=torch.float32):
        self.params, self.cfg = params, cfg
        self.fam = family(cfg)
        self.device, self.dtype = torch.device(device), dtype
        self.B = n_slots
        self.C = state_dim(cfg)
        self.out_dim = cfg.in_dim * cfg.r
        self.att = ([0] if self.fam is nk else
                    [i for i, s in enumerate(cfg.attention_specs)
                     if s is not None])
        self.n_layers = 1 if self.fam is nk else len(cfg.attention_specs)
        self.att_w = None       # the plain step reads the unfolded K/V

    def zero_carry(self):
        state = self.fam.decoder_init_state(self.cfg, self.B, self.device)
        return {"prev": torch.zeros(self.B, self.out_dim, device=self.device,
                                    dtype=self.dtype),
                "state": _tree_map(lambda t: t.to(self.dtype)
                                   if t.is_floating_point() else t, state)}

    def reset_row(self, carry, b):
        """A fresh stream in slot b: zero its carry row (in place)."""
        _tree_map(lambda t: t.__setitem__(b, 0), carry)

    def positions(self, carry):
        return carry["state"]["pos"]

    def launch(self, inputs, carry, outputs, steps):
        """Run `steps` frames of every slot from `carry` into frames 0 ..
        steps-1 of `outputs`; writes the carry's rows in place.

        One row at a time: a row's numbers then do not depend on the other
        slots, and a slot equals a fresh batch-1 stream of the plain version
        bit for bit (a batched matmul sums in an order that depends on the
        batch, and the emission's Griffin-Lim amplifies one-ulp
        differences through its bf16 operands)."""
        for b in range(self.B):
            row = slice(b, b + 1)
            kv = [None] * self.n_layers
            for j, i in enumerate(self.att):
                kv[i] = (inputs.kv[j, 0, row], inputs.kv[j, 1, row])
            se = inputs.speaker_embed
            step_fn = self.fam.make_decoder_step(
                self.params, self.cfg, kv,
                None if inputs.w_query is None else inputs.w_query[row],
                speaker_embed=None if se is None else se[row],
                mask=inputs.addmask[row] < 0, ctx_scale=inputs.ctx_scale[row])
            sub = _tree_map(lambda t: t[row], carry)
            _plain_steps(step_fn, sub, [o[row] for o in outputs], 0, steps)
            _tree_map(lambda t, u: t.__setitem__(row, u), carry, sub)


def _tree_map(fn, tree, *rest):
    """fn over the tensors of a carry tree (dicts, lists, tensors, None)
    and of trees of the same structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, *vs) for vs in zip(tree, *rest)]
    return None if tree is None else fn(tree, *rest)


def make_slot_decoder(params, cfg, n_slots, device):
    """The serving decoder for `device`: `SlotDecoder` (kernel B1) on
    CUDA, `PlainSlotDecoder` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return PlainSlotDecoder(params, cfg, n_slots, device)
    return SlotDecoder(params, cfg, n_slots, device)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _decode_chunks(decoder_cls, params, cfg, inputs, mask, initial_input,
                   max_steps, min_steps, early_exit, chunk, test_inputs=None):
    """The host loop: `chunk` frames per launch from a zero carry, the last
    launch only the max_steps - t0 frames left; with early_exit, stop after
    the first chunk in which every sample's done latch fired. While a window
    records, counts the steps launched (`b1.steps_run`) and those returned
    (`b1.steps_kept`, num_steps). With test_inputs (B, T, out_dim) the loop
    is teacher-forced instead: one frame a launch, frame t reading
    test_inputs[:, t] as its previous frame (initial_input, max_steps and
    early_exit unused), T frames, as the JAX package's
    `decode_scan(test_inputs=)`."""
    if test_inputs is not None:
        return _teacher_forced(decoder_cls, params, cfg, inputs, mask,
                               test_inputs)
    chunk = min(chunk, max_steps)
    n_chunks = -(-max_steps // chunk)
    with profiling.span("dv3.decode.prepare", "device"):
        dec = decoder_cls(params, cfg, inputs, mask, max_steps)
        carry = dec.zero_carry(initial_input)
        outs = dec.new_outputs(max_steps)
        latch = torch.zeros(dec.B, dtype=torch.bool, device=dec.device)
    # while a window records, each launch of B1 stamps its stages
    kernel = isinstance(dec, FusedDecoder)
    n_stages = len(dec.layout.stages) if kernel else 0
    kinds = b1_stage_kinds(dec.layout.stages) if kernel else None
    c = run = 0
    while c < n_chunks and not (early_exit and bool(latch.all())):
        t0 = c * chunk
        steps = min(chunk, max_steps - t0)      # the last launch: N - t0
        with profiling.span("dv3.decode.chunk", "device") as sp:
            dec.launch(carry, outs, t0, steps,
                       trace=sp.stamps(n_stages, steps, dec.device, kinds))
            if early_exit:
                latch |= chunk_latch(outs[2][:, t0:t0 + steps], t0,
                                     min_steps)
        c += 1
        run += steps
    num_steps = min(c * chunk, max_steps)
    profiling.count("b1.steps_run", run)
    profiling.count("b1.steps_kept", num_steps)
    return FusedDecodeOut(*outs, num_steps, dec.last_attended(carry))


def _teacher_forced(decoder_cls, params, cfg, inputs, mask, test_inputs):
    """T = test_inputs.shape[1] frames, one a launch, the carry's previous
    frame set to test_inputs[:, t] before frame t (the kernel reads its
    input frame from the carry at every launch and writes its output there,
    which the next frame's copy replaces)."""
    T = test_inputs.shape[1]
    dec = decoder_cls(params, cfg, inputs, mask, T)
    carry = dec.zero_carry(test_inputs[:, 0])
    outs = dec.new_outputs(T)
    for t in range(T):
        dec.set_prev(carry, test_inputs[:, t])
        dec.launch(carry, outs, t, 1)
    return FusedDecodeOut(*outs, T, dec.last_attended(carry))


def fused_decode(params, cfg, inputs, mask, initial_input, max_steps,
                 min_steps, *, early_exit=True, chunk=DEFAULT_CHUNK,
                 test_inputs=None):
    """Decode up to max_steps frames, `chunk` frames per launch; with
    test_inputs (B, T, out_dim), teacher-forced over its T frames, one a
    launch (see `_decode_chunks`).

    inputs: the family's `fused_decode_inputs(...)`, its position table
    covering T frames when teacher-forced. mask: (B, Tk) bool, True where
    padded, or None. Returns FusedDecodeOut."""
    x = initial_input if test_inputs is None else test_inputs
    if x.device.type == "cpu":
        return fused_decode_plain(params, cfg, inputs, mask, initial_input,
                                  max_steps, min_steps, early_exit=early_exit,
                                  chunk=chunk, test_inputs=test_inputs)
    if x.device.type != "cuda":
        raise ValueError("fused_decode: unsupported device %s" % x.device)
    return _decode_chunks(FusedDecoder, params, cfg, inputs, mask,
                          initial_input, max_steps, min_steps, early_exit,
                          chunk, test_inputs)


def fused_decode_plain(params, cfg, inputs, mask, initial_input, max_steps,
                       min_steps, *, early_exit=True, chunk=DEFAULT_CHUNK,
                       test_inputs=None):
    """Plain PyTorch version of the kernel: the same host loop over
    `PlainDecoder`, latch checked every `chunk` frames."""
    return _decode_chunks(PlainDecoder, params, cfg, inputs, mask,
                          initial_input, max_steps, min_steps, early_exit,
                          chunk, test_inputs)
