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
device-to-host read per chunk.

`FusedDecoder` is the public launch-and-carry interface: it folds the
weight norms once, packs the plan, K/V and mask, and launches one chunk at a
time from an explicit `DecodeCarry` (previous frame, last_attended, ring
buffers), so a streaming caller can resume a decode where it stopped.
`PlainDecoder` has the same interface over the plain step for CPU tensors;
`make_decoder` picks the one for the inputs' device.

Continuous batching (serving.py) decodes a batch of slots, each at its own
point of its own utterance. `SlotDecoder` is B1 in its serving modes: the
plan is folded once per engine, the per-slot inputs (`SlotInputs`: K/V,
additive mask, position rates, speaker biases, context scales) belong to
the caller, which rewrites one row at each admission (`write_slot_row`) and
pads the text dimension when a longer text arrives (`grow_slot_inputs`;
the ring placement follows the new Tk at the next launch), and every row
reads the position-table row of its own decoded count, which the launch
advances (`SlotCarry.pos`). `PlainSlotDecoder` is its plain version with
the same interface; `make_slot_decoder` picks the one for the device.
"""

import ctypes
import math
from typing import Any, NamedTuple

import torch

from .. import _build
from ..models import deepvoice3 as dv3
from ..models import nyanko as nk
from ..models.decode import chunk_latch
from . import core

MASK = -1.0e9
DEFAULT_CHUNK = 32

OP_WORDS = 10
(OP_LINEAR, OP_GLU, OP_ATTN, OP_SAVE_RES, OP_RESIDUAL, OP_HIGHWAY,
 OP_LINEAR2, OP_SAVE_Q) = range(8)
_ACT = {None: 0, "relu": 1, "sigmoid": 2}
_THREADS = 512          # csrc/fused_decode.cu:NT
BUF_WORDS = 5           # csrc/fused_decode.cu:BUF_WORDS


class FusedDecodeOut(NamedTuple):
    outputs: Any          # (B, max_steps, out_dim); frames past the stop zero
    alignments: Any       # (B, max_steps, Tk)
    done: Any             # (B, max_steps)
    decoder_states: Any   # (B, max_steps, C)
    num_steps: int        # frames computed, chunk-rounded, <= max_steps
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
    act_dim: int          # widest activation vector
    cat_dim: int          # widest concatenated tap vector (kw * cin)


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
    dims = [cfg.in_dim * cfg.r, state_dim(cfg)]
    cat_dim = [1]
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
        dims.extend([s.in_channels, 2 * s.out_channels])
        cat_dim[0] = max(cat_dim[0], s.kernel_size * s.in_channels)
        return w, buf

    def linear(p, s):
        w = core.conv1d_weight(p["conv"])[0]
        dims.extend(w.shape)
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
        dims.extend(wq.shape)
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
        dims.extend(w.shape)
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
                n_att, tuple(sp_widths), max(dims + list(w_last.shape)),
                cat_dim[0])


# ---------------------------------------------------------------------------
# shared-memory budget and ring placement
# ---------------------------------------------------------------------------


def _round4(n):
    return (n + 3) & ~3


def smem_floats(act_dim, cat_dim, C, E, Tk, n_buf, n_la, ring_smem=0):
    """Floats of dynamic shared memory one block of the kernel takes: the
    mirror of csrc/fused_decode.cu:layout (FusedDecoder checks the two
    agree)."""
    return (_round4(ring_smem) + 3 * _round4(act_dim) + _round4(cat_dim)
            + 4 * _round4(C) + 2 * _round4(E) + 2 * _round4(Tk)
            + 4 * _THREADS + 64 + _round4(n_buf + n_la))


def place_rings(buffers, budget_floats):
    """Where each ring buffer lives, given `budget_floats` of shared memory
    for them: the smallest first (every step reads kw taps of a buffer
    whatever its length, so the long dilated ones are the ones to move),
    the rest in a per-row scratch in device memory. Returns
    (((offset in its place, in shared memory), ...) in buffer order,
    shared floats, scratch floats)."""
    placed = [None] * len(buffers)
    smem = scratch = 0
    for i in sorted(range(len(buffers)),
                    key=lambda i: (buffers[i][0] * buffers[i][1], i)):
        size = _round4(buffers[i][0] * buffers[i][1])
        if smem + size <= budget_floats:
            placed[i] = (smem, 1)
            smem += size
        else:
            placed[i] = (scratch, 0)
            scratch += size
    return tuple(placed), smem, scratch


def _placement(plan, C, E, tk, n_la, dev, smem_budget):
    """Ring placement of `plan` at text length tk under smem_budget bytes
    (None: the device's limit per block), checked against the kernel's own
    layout. Returns (bufs (n_buf, BUF_WORDS) int32 on dev, shared ring
    floats, scratch floats). A plan whose fixed part alone exceeds the
    budget raises."""
    lib = KERNEL.lib
    if smem_budget is None:
        smem_budget = lib.dv3_fused_decode_max_smem(dev.index or 0)
        if smem_budget <= 0:
            KERNEL.check(-smem_budget, "shared memory per block")
    fixed = smem_floats(plan.act_dim, plan.cat_dim, C, E, tk,
                        len(plan.buffers), n_la)
    if 4 * fixed > smem_budget:
        raise ValueError(
            "fused_decode: the plan needs %d bytes of shared memory "
            "besides its ring buffers, more than the %d bytes a block "
            "may have" % (4 * fixed, smem_budget))
    placed, ring_smem, scratch_floats = place_rings(
        plan.buffers, smem_budget // 4 - fixed)
    bufs = torch.tensor(
        [[r, c, off, loc, sm] for (r, c, off), (loc, sm)
         in zip(plan.buffers, placed)] or [[0] * BUF_WORDS],
        dtype=torch.int32, device=dev)
    want = 4 * (fixed + ring_smem)
    got = lib.dv3_fused_decode_smem_bytes(ctypes.byref(_Args(
        n_buf=len(plan.buffers), Tk=tk, E=E, C=C, n_la=n_la,
        ring_smem_floats=ring_smem, act_dim=plan.act_dim,
        cat_dim=plan.cat_dim)))
    if got != want:
        raise RuntimeError("fused_decode: the kernel's shared-memory "
                           "layout (%d bytes) differs from the host's "
                           "(%d)" % (got, want))
    return bufs, ring_smem, scratch_floats


# ---------------------------------------------------------------------------
# kernel binding
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """Mirror of FusedDecodeArgs in csrc/fused_decode.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "ops", "bufs", "weights", "fpe", "wq", "addmask", "kv", "sp", "prev",
        "la", "ring", "scratch", "out", "align", "done", "dstate")]
        + [(n, ctypes.c_int) for n in (
            "n_ops", "n_buf", "B", "Tk", "E", "C", "out_dim", "n_att", "n_la",
            "ring_floats", "ring_smem_floats", "scratch_floats", "sp_width",
            "fpe_raw", "T_total", "t0", "steps", "last_w", "last_b", "fc_w",
            "fc_b", "act_dim", "cat_dim")]
        + [("ctx_scale", ctypes.c_float), ("pos", ctypes.c_void_p),
           ("row_scale", ctypes.c_void_p), ("fpe_rows", ctypes.c_int)])


KERNEL = _build.Kernel("fused_decode.cu", {
    "dv3_fused_decode": [ctypes.POINTER(_Args), ctypes.c_void_p,
                         ctypes.c_int],
    "dv3_fused_decode_smem_bytes": [ctypes.POINTER(_Args)],
    "dv3_fused_decode_max_smem": [ctypes.c_int],
})


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


class FusedDecoder(_Decoder):
    """Launch-invariant state of one decode on the card: the plan with
    folded weights, the stacked projected K/V, the additive mask, the query
    position rows of frames 1..n_steps (`inputs["fpe_table"]`, its last row
    repeated past its end; raw angles with per-row rates when
    `inputs["fpe_raw"]`, else finished encodings), the speaker biases as
    one (n_sp, B, width) tensor (zeros when a multi-speaker model decodes
    without a speaker, as the plain step then adds none), and the ring
    placement: the buffers that
    fit under `smem_budget` bytes of shared memory (default: the device's
    limit per block) stay there, the rest go to a per-row scratch in device
    memory. A plan whose fixed part alone exceeds the budget raises."""

    def __init__(self, params, cfg, inputs, mask, n_steps, smem_budget=None):
        kv = [p for p in inputs["projected_kv"] if p is not None]
        keys0 = kv[0][0]
        self.device = dev = keys0.device
        if self.device.type != "cuda":
            raise ValueError("FusedDecoder runs on CUDA tensors only (got %s)"
                             % self.device)
        f32 = torch.float32
        self.plan = p = build_plan(params, cfg)
        if p.n_att != len(kv):
            raise ValueError("need %d K/V pairs, got %d" % (p.n_att, len(kv)))
        self.B, self.tk, self.E = keys0.shape
        self.C = state_dim(cfg)
        self.out_dim = cfg.in_dim * cfg.r
        self.dtype = f32
        self.n_la = max(p.n_att, 1)
        self.ring_floats = sum(r * c for r, c, _ in p.buffers)
        if p.act_dim > 4 * _THREADS:
            raise ValueError("fused_decode: widths above %d are not supported"
                             % (4 * _THREADS))
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
        self.sp_width = max(p.sp_widths or (0,))
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

        # ring placement under the shared-memory budget
        self.bufs, self.ring_smem, self.scratch_floats = _placement(
            p, self.C, self.E, self.tk, self.n_la, dev, smem_budget)
        self.scratch = (torch.empty(self.B, self.scratch_floats, device=dev)
                        if self.scratch_floats else None)

    def zero_carry(self, initial_input):
        return DecodeCarry(
            initial_input.float().contiguous().clone(),
            torch.zeros(self.B, self.n_la, dtype=torch.int32,
                        device=self.device),
            torch.zeros(self.B, self.ring_floats, device=self.device))

    def last_attended(self, carry):
        return carry.last_attended[:, :self.plan.n_att]

    def _args(self, carry, outputs, t0, steps):
        out, align, done, dstate = outputs
        p = self.plan
        return _Args(
            p.ops.data_ptr(), self.bufs.data_ptr(), p.weights.data_ptr(),
            self.fpe.data_ptr(), _ptr(self.wq), self.addmask.data_ptr(),
            self.kv.data_ptr(), _ptr(self.sp), carry.prev.data_ptr(),
            carry.last_attended.data_ptr(), carry.ring.data_ptr(),
            _ptr(self.scratch), out.data_ptr(), align.data_ptr(),
            done.data_ptr(), dstate.data_ptr(),
            p.ops.shape[0], len(p.buffers), self.B, self.tk, self.E, self.C,
            self.out_dim, p.n_att, self.n_la, self.ring_floats,
            self.ring_smem, self.scratch_floats, self.sp_width,
            int(self.fpe_raw), out.shape[1], t0, steps, p.last[0], p.last[1],
            p.fc[0], p.fc[1], p.act_dim, p.cat_dim,
            self.tk * math.sqrt(1.0 / self.tk))

    def launch(self, carry, outputs, t0, steps):
        """Run frames t0 .. t0+steps-1 from `carry`: writes them into
        `outputs` (from new_outputs) and updates `carry` in place."""
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
        args = self._args(carry, outputs, t0, steps)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = KERNEL.lib.dv3_fused_decode(ctypes.byref(args), stream,
                                         dev.index or 0)
        KERNEL.launched("chunk")
        KERNEL.check(rc, "fused_decode launch")


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

    def launch(self, carry, outputs, t0, steps):
        """Run frames t0 .. t0+steps-1 from `carry` into `outputs`."""
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


def slot_inputs(fi, n_slots, tk):
    """Zeroed SlotInputs of n_slots rows and text length tk, shaped like
    the batch-1 inputs `fi` (a family's `fused_decode_inputs`) and in the
    dtype of its keys: masked everywhere, rates and scales 1."""
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
        torch.ones(n_slots, **z))


def write_slot_row(si, b, fi, mask, ctx_scale):
    """Row b of si <- the batch-1 inputs fi with its (1, tk) padding mask
    (K/V and mask right-padded to si's text length, masked there) and the
    context scale ctx_scale, a float rounded to f32 as the kernel's scalar
    is. In place."""
    tk = mask.shape[1]
    kv = [p for p in fi["projected_kv"] if p is not None]
    for i, (k, v) in enumerate(kv):
        si.kv[i, 0, b, :tk] = k[0]
        si.kv[i, 1, b, :tk] = v[0]
        si.kv[i, :, b, tk:] = 0.0
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
    kv = torch.cat([si.kv, si.kv.new_zeros(si.kv.shape[:3] + (grow,)
                                           + si.kv.shape[4:])], dim=3)
    addmask = torch.cat([si.addmask, si.addmask.new_full(
        (si.addmask.shape[0], grow), MASK)], dim=1)
    return si._replace(kv=kv, addmask=addmask)


class SlotDecoder(_Decoder):
    """Kernel B1 in its serving modes over a batch of n_slots rows: the
    plan with folded weights is built once; `launch` takes the caller's
    SlotInputs, reads each row's position-table row from the row's own
    decoded count (the whole table: raw angles with the row's rate, or
    finished encodings), scales each row's context by its own scale, and
    advances the counts in the kernel. The ring placement is recomputed
    whenever the inputs' text length changes (Tk is part of the shared-
    memory layout); the carry keeps its logical-order rings across it.
    `smem_budget`: bytes of shared memory for the placement, None for the
    device's limit per block (the card tests lower it)."""

    def __init__(self, params, cfg, n_slots, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError("SlotDecoder runs on CUDA tensors only (got %s)"
                             % device)
        self.device, self.dtype = device, torch.float32
        self.plan = build_plan(params, cfg)
        self.B = n_slots
        self.C = state_dim(cfg)
        self.out_dim = cfg.in_dim * cfg.r
        self.n_la = max(self.plan.n_att, 1)
        self.ring_floats = sum(r * c for r, c, _ in self.plan.buffers)
        self.sp_width = max(self.plan.sp_widths or (0,))
        self.fpe_raw = family(cfg) is dv3
        self.table = params["embed_query_positions"]["w"].float() \
            .contiguous()
        _check(self.table, "position table", (self.table.shape[0], self.C),
               torch.float32, device)
        if self.plan.act_dim > 4 * _THREADS:
            raise ValueError("fused_decode: widths above %d are not supported"
                             % (4 * _THREADS))
        self.smem_budget = None
        self.tk = self.E = None

    def _place(self, tk, E):
        self.bufs, self.ring_smem, self.scratch_floats = _placement(
            self.plan, self.C, E, tk, self.n_la, self.device,
            self.smem_budget)
        self.scratch = (torch.empty(self.B, self.scratch_floats,
                                    device=self.device)
                        if self.scratch_floats else None)
        self.tk, self.E = tk, E

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

    def launch(self, inputs, carry, outputs, steps):
        """Run `steps` frames of every slot from `carry` into frames 0 ..
        steps-1 of `outputs` (new_outputs(steps, Tk)); updates `carry` in
        place, its positions included."""
        f32, i32, dev = torch.float32, torch.int32, self.device
        p, S = self.plan, self.B
        n_att, tk, E = (inputs.kv.shape[0], inputs.kv.shape[3],
                        inputs.kv.shape[4])
        if n_att != p.n_att:
            raise ValueError("need %d K/V pairs, got %d" % (p.n_att, n_att))
        _check(inputs.kv, "kv", (n_att, 2, S, tk, E), f32, dev)
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
        if (tk, E) != (self.tk, self.E):
            self._place(tk, E)
        args = _Args(
            p.ops.data_ptr(), self.bufs.data_ptr(), p.weights.data_ptr(),
            self.table.data_ptr(),
            _ptr(inputs.w_query if self.fpe_raw else None),
            inputs.addmask.data_ptr(), inputs.kv.data_ptr(),
            _ptr(inputs.speaker_bias if p.sp_widths else None),
            carry.prev.data_ptr(), carry.last_attended.data_ptr(),
            carry.ring.data_ptr(), _ptr(self.scratch), out.data_ptr(),
            align.data_ptr(), done.data_ptr(), dstate.data_ptr(),
            p.ops.shape[0], len(p.buffers), S, tk, E, self.C, self.out_dim,
            p.n_att, self.n_la, self.ring_floats, self.ring_smem,
            self.scratch_floats, self.sp_width, int(self.fpe_raw), steps, 0,
            steps, p.last[0], p.last[1], p.fc[0], p.fc[1], p.act_dim,
            p.cat_dim, 1.0, carry.pos.data_ptr(),
            inputs.ctx_scale.data_ptr(), self.table.shape[0])
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = KERNEL.lib.dv3_fused_decode(ctypes.byref(args), stream,
                                         dev.index or 0)
        KERNEL.launched("slots")
        KERNEL.check(rc, "fused_decode launch (slots)")


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

        One row at a time, as the kernel runs each row in a thread block
        of its own: a row's numbers then do not depend on the other slots,
        and a slot equals a fresh batch-1 stream of the plain version bit
        for bit (a batched matmul sums in an order that depends on the
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
                   max_steps, min_steps, early_exit, chunk):
    """The host loop: `chunk` frames per launch from a zero carry; with
    early_exit, stop after the first chunk in which every sample's done
    latch fired."""
    chunk = min(chunk, max_steps)
    n_chunks = -(-max_steps // chunk)
    dec = decoder_cls(params, cfg, inputs, mask, n_chunks * chunk)
    carry = dec.zero_carry(initial_input)
    outs = dec.new_outputs(n_chunks * chunk)
    latch = torch.zeros(dec.B, dtype=torch.bool, device=dec.device)
    c = 0
    while c < n_chunks and not (early_exit and bool(latch.all())):
        t0 = c * chunk
        dec.launch(carry, outs, t0, chunk)
        if early_exit:
            latch |= chunk_latch(outs[2][:, t0:t0 + chunk], t0, min_steps)
        c += 1
    o, a, d, s = (x[:, :max_steps] for x in outs)
    return FusedDecodeOut(o, a, d, s, min(c * chunk, max_steps),
                          dec.last_attended(carry))


def fused_decode(params, cfg, inputs, mask, initial_input, max_steps,
                 min_steps, *, early_exit=True, chunk=DEFAULT_CHUNK):
    """Decode up to max_steps frames, `chunk` frames per launch.

    inputs: the family's `fused_decode_inputs(...)`. mask: (B, Tk)
    bool, True where padded, or None. Returns FusedDecodeOut."""
    if initial_input.device.type == "cpu":
        return fused_decode_plain(params, cfg, inputs, mask, initial_input,
                                  max_steps, min_steps, early_exit=early_exit,
                                  chunk=chunk)
    if initial_input.device.type != "cuda":
        raise ValueError("fused_decode: unsupported device %s"
                         % initial_input.device)
    return _decode_chunks(FusedDecoder, params, cfg, inputs, mask,
                          initial_input, max_steps, min_steps, early_exit,
                          chunk)


def fused_decode_plain(params, cfg, inputs, mask, initial_input, max_steps,
                       min_steps, *, early_exit=True, chunk=DEFAULT_CHUNK):
    """Plain PyTorch version of the kernel: the same host loop over
    `PlainDecoder`, latch checked every `chunk` frames."""
    return _decode_chunks(PlainDecoder, params, cfg, inputs, mask,
                          initial_input, max_steps, min_steps, early_exit,
                          chunk)
