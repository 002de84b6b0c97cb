# coding: utf-8
"""Continuous batching for streaming TTS serving, counterpart of
deepvoice3_pytorch_tpu/serving.py.

`ContinuousBatcher` keeps a fixed batch of slots decoding and admits new
utterances into free slots at chunk boundaries, the TTS analogue of
continuous batching in LLM serving: kernel B1 costs about the same for 8
rows as for 1, because each row is one thread block and a step is a chain
of small matrix-vector products.

What makes mid-stream admission exact:
  * the decode carry (fed-back frame, ring buffers, last_attended) is per
    slot, and admission zeroes one row of it;
  * the attention K/V, the padding mask, the query position rate, the
    speaker biases and the attention context scale are per-slot rows of
    the caller-owned `fused_decode.SlotInputs`, and admission writes the
    new utterance's values into row `slot`;
  * the query position is per slot: kernel B1's per-row mode reads, for
    each row, the table row of that row's own decoded count (raw angles
    with the row's rate for the DeepVoice3 family, finished encodings for
    nyanko) and advances the count itself, so a slot admitted at global
    chunk 7 decodes like a fresh stream at chunk 0;
  * the context scale of a slot stays the one of the text bucket it was
    admitted at when a longer text grows the batch's text dimension.

Texts are admitted at bucketed lengths: the text dimension starts at
`text_pad` tokens and grows by `text_pad` up to the model's max_positions.

After the decode the emission (converter window, windowed Griffin-Lim,
crossfade, inverse pre-emphasis) runs grouped across slots: slots at the
same emission phase share one converter-window and Griffin-Lim-window
signature, and each group runs one converter call and one B2 launch
(`streaming.gl_window`, the window vocoder of `tts_stream`) on its member
rows only. A steady-state step is one B1 launch, one B2 launch per
signature group and one blocking device-to-host copy, which carries the
done flags and every group's samples together.

What differs from the JAX engine, and why:
  * Group membership. The JAX engine runs every grouped program at the
    full slot width under a membership mask (deepvoice3_pytorch_tpu/
    serving.py:40-51, 362-493 and the masked merges of _gl_prog), because
    a group size that is a shape compiled a new XLA program for every
    (signature, group size) pair the arrivals produced. Eager PyTorch
    compiles nothing per shape, so a group gathers its rows by a device
    index tensor and writes them back with an out-of-place index_copy.
  * The jitted helpers _restore_rows, _admit_scatter, _admit_prog and
    _slot_chunk_prog (l.77-180) are plain functions and tensor writes;
    the history roll is one torch.cat after the B1 launch.
  * The rewind. The retire path rewinds a slot's emission state to the
    step-start snapshot; JAX takes that snapshot by reference because its
    arrays are immutable (l.1084-1088). Here every update of hist,
    lin_tail, prev_re, prev_im and pend is out of place (torch.cat,
    index_copy), so the step-start references stay a true snapshot.
  * The pipelined fetch (depth 1, l.1038-1060). A step's payload is copied
    with non_blocking into one of two pinned host buffers and an event is
    recorded; only the next step synchronises on that event, after it has
    launched its own work. On the CPU the copy is a plain one.
"""

import math
import queue
import threading
import time
import traceback

import numpy as np
import torch

from . import streaming
from .builder import embed_speakers, model_postnet
from .ops import core
from .ops import fused_decode as fd
from .synthesis import _param_device


def _admit_inputs(params, cfg, x, pos, length, spk):
    """Launch-invariant state of one request (batch 1): the family's
    fused-decode inputs (projected K/V, position rate, speaker biases and
    embedding) and its padding mask."""
    speaker_embed = embed_speakers(params, cfg, spk)
    encoder_out = cfg.family.encoder_apply(params["encoder"], cfg.encoder, x,
                                           speaker_embed=speaker_embed)
    mask = core.get_mask_from_lengths(length, encoder_out[0].shape[1])
    fi = cfg.family.fused_decode_inputs(params["decoder"], cfg.decoder,
                                        encoder_out, pos, 1,
                                        speaker_embed=speaker_embed)
    return fi, mask


def _restore_rows(cur, snap, idx):
    """Rows idx of every emission-state tensor back to the snapshot, out of
    place (the snapshot is the step-start tensors themselves)."""
    return tuple(c.index_copy(0, idx, s.index_select(0, idx))
                 for c, s in zip(cur, snap))


class _Fetch:
    """The step's one device-to-host copy. On the card it goes with
    non_blocking into one of two pinned buffers (one for the step in
    flight, one for the step being harvested) and records an event;
    `wait` synchronises on that event alone. On the CPU it is a copy."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self._bufs = None
        self._i = 0

    def start(self, t):
        if not self.cuda:
            return t
        if self._bufs is None or self._bufs[0].shape != t.shape:
            self._bufs = [torch.empty(t.shape, dtype=t.dtype,
                                      pin_memory=True) for _ in range(2)]
        buf = self._bufs[self._i]
        self._i ^= 1
        buf.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return buf, ev

    def wait(self, handle):
        if not self.cuda:
            return handle.numpy()
        buf, ev = handle
        ev.synchronize()
        return buf.numpy().copy()


class _Slot:
    __slots__ = ("out_q", "local_steps", "done_rows", "latched", "emitted",
                 "n_total", "prev_phase", "M", "e_m", "n_ctx", "n_pend")

    def __init__(self, out_q):
        self.out_q = out_q
        self.local_steps = 0
        self.done_rows = []
        self.latched = False
        self.emitted = 0          # samples delivered so far
        self.n_total = None       # decoded-length sample cap once latched
        self.prev_phase = None    # (M, e_m, n_ctx, n_pend) before the
        # latest dispatch: the retire path rewinds to it when the pipelined
        # done latch lands one chunk late
        # emission phase (streaming.StreamEmitter + StreamingVocoder's
        # counters; the state tensors are slot-batched)
        self.M = 0                # postnet-input frames accumulated
        self.e_m = 0              # postnet-input frames emitted
        self.n_ctx = 0            # valid Griffin-Lim context frames
        self.n_pend = 0           # lookahead linear frames held back


class DeliveryQueue(queue.Queue):
    """A request's delivery queue. It keeps the wall times (time.time(), so
    that another process's clock on the host compares) of two hops of the
    request: t_admit (taken into a slot), t_first_put (its first audio
    put)."""

    def __init__(self):
        super().__init__()
        self.t_admit = self.t_first_put = None

    def put(self, item, block=True, timeout=None):
        if self.t_first_put is None and item[0] == "audio":
            self.t_first_put = time.time()
        super().put(item, block, timeout)


class BacklogFull(RuntimeError):
    """Admission control: the waiting queue is at max_backlog. Callers
    shed the request (serve.py answers HTTP 503 with Retry-After) rather
    than queue without bound: a stream admitted minutes late is worthless
    to its listener and still costs the card."""


class _EmitEngine:
    """Slot-batched emission: converter windows and phase-coherent
    windowed Griffin-Lim, grouped across slots.

    Device state (S = n_slots), each replaced, never written in place:
      hist     (S, H, D)   last H postnet-input frames per slot
      lin_tail (S, GC, F)  emitted Griffin-Lim context frames, right-aligned
      prev_re/prev_im (S, GC, F) retrieved spectrum of lin_tail
      pend     (S, GLA, F) held-back lookahead frames, right-aligned
      raw_buf  (S, m_max)  the step's samples, right-aligned per row
    Host state: raw_tail (S, xfade) pre-IIR crossfade tails, zi (S, 1)
    inverse pre-emphasis states.

    The window math is that of streaming.StreamEmitter + StreamingVocoder
    (same window compositions, the same pinned-context anchored start,
    the same `gl_window`); only the batching differs."""

    def __init__(self, params, cfg, ap, n_slots, chunk_frames, device, *,
                 gl_context, gl_lookahead, xfade, multispeaker):
        streaming.require_causal_framing(ap)
        self.params, self.cfg, self.ap = params, cfg, ap
        self.S = n_slots
        self.cr = chunk_frames                      # postnet frames / step
        self.up = cfg.converter.time_upsampling
        self.ctx_l, self.ctx_r = streaming.converter_context(cfg.converter)
        self.GC = int(gl_context)
        self.GLA = int(gl_lookahead)
        self.hop = ap.hop_size
        self.xfade = self.hop if xfade is None else int(xfade)
        if self.xfade > self.GC * self.hop:
            raise ValueError("xfade (%d samples) exceeds the context (%d "
                             "samples)" % (self.xfade, self.GC * self.hop))
        self.D = cfg.converter.in_dim
        self.F = ap.fft_size // 2 + 1
        self.iters = max(ap.gl_iters, streaming.GL_MIN_ITERS)
        self.device = device
        CB = streaming.CONV_BUCKET
        self.H = -(-(self.cr + self.ctx_l + self.ctx_r) // CB) * CB
        # m_max covers any in-step emission: cr postnet frames upsampled,
        # plus the crossfade head; wider ones (the retire flush) are
        # returned on their own
        self.m_max = self.cr * self.up * self.hop + self.xfade
        S, z = n_slots, dict(device=device)
        with torch.inference_mode():
            self.hist = torch.zeros(S, self.H, self.D, **z)
            self.lin_tail = torch.zeros(S, self.GC, self.F, **z)
            self.prev_re = torch.zeros(S, self.GC, self.F, **z)
            self.prev_im = torch.zeros(S, self.GC, self.F, **z)
            self.pend = torch.zeros(S, max(self.GLA, 1), self.F, **z)
            self.raw_buf = torch.zeros(S, self.m_max, **z)
            self.spk = (torch.zeros(S, dtype=torch.int64, **z)
                        if multispeaker else None)
        self.raw_tail = np.zeros((S, self.xfade), np.float32)
        self.zi = np.zeros((S, 1), np.float32)
        self.ramp = np.linspace(0.0, 1.0, self.xfade, endpoint=False,
                                dtype=np.float32)
        self._idx = {}

    def reset_slot(self, b):
        """Host resets at admission. Device rows need none: every read is
        bounded by the slot's own (M, n_ctx, n_pend) counters."""
        self.raw_tail[b] = 0.0
        self.zi[b] = 0.0

    def index(self, slots):
        """Device index tensor of a slot set, memoized by the set (a step
        dispatches the same groups every chunk, and an upload from pageable
        memory would synchronise the stream)."""
        key = tuple(int(b) for b in slots)
        t = self._idx.get(key)
        if t is None:
            if len(self._idx) >= 4096:
                self._idx.clear()
            t = self._idx[key] = torch.tensor(key, dtype=torch.int64,
                                              device=self.device)
        return t

    def conv_sig(self, slot):
        """Converter-window signature for the slot's pending emission
        [e_m, emit_to): (window length, emit offsets), the formula of
        streaming.StreamEmitter.conv_emit."""
        return self.final_conv_sig(slot, slot.M - self.ctx_r)

    def final_conv_sig(self, slot, emit_to):
        M, e_m = slot.M, slot.e_m
        CB = streaming.CONV_BUCKET
        W = M - max(0, e_m - self.ctx_l)
        Wb = min(M, -(-W // CB) * CB)
        ws = M - Wb
        return (Wb, e_m - ws, emit_to - ws)

    def raw_width(self, gl_sig):
        """Samples a Griffin-Lim signature emits (pre-crossfade)."""
        n_ctx, n_pend, n_new, keep_la = gl_sig
        emit_n = n_pend + n_new - (self.GLA if keep_la else 0)
        return emit_n * self.hop + (self.xfade if n_ctx else 0)

    def dispatch(self, gl_sig, slots, conv_sig=None, row=False):
        """One group's emission: the converter on its window of the member
        rows' history (conv_sig), then one Griffin-Lim window (one B2
        launch) over [context | emission | lookahead] of those rows; the
        state rows are written back out of place. gl_sig = (n_ctx, n_pend,
        n_new, keep_lookahead); conv_sig None with n_new = 0 is the flush
        of the lookahead.

        Returns None when the frames went into the lookahead (no
        Griffin-Lim), "buf" when the samples went into raw_buf (the
        in-step case), else the (G, m) device samples (row=True, the
        retire path, or an emission wider than m_max)."""
        n_ctx, n_pend, n_new, keep_la = gl_sig
        GC, GLA, S = self.GC, self.GLA, len(slots)
        idx = self.index(slots)
        parts = []
        if n_pend:
            parts.append(self.pend.index_select(0, idx)[:, GLA - n_pend:])
        if n_new:
            Wb, o0, o1 = conv_sig
            window = self.hist.index_select(0, idx)[:, self.H - Wb:]
            spk = None if self.spk is None else self.spk.index_select(0, idx)
            lin = model_postnet(self.params, self.cfg, window,
                                speaker_ids=spk)
            parts.append(lin[:, o0 * self.up:o1 * self.up])
        frames = torch.cat(parts, dim=1)
        frames_n = frames.shape[1]

        def right_align(a, n):
            if a.shape[1] == n:
                return a
            return torch.cat([a.new_zeros(S, n - a.shape[1], a.shape[2]), a],
                             dim=1)

        if keep_la and frames_n <= GLA:            # absorb, no Griffin-Lim
            self.pend = self.pend.index_copy(0, idx, right_align(frames, GLA))
            return None
        emit_n = frames_n - (GLA if keep_la else 0)
        emit, new_pend = frames[:, :emit_n], frames[:, emit_n:]
        n_ctx2 = min(GC, n_ctx + emit_n)
        tail_g = prev = None
        if n_ctx:
            tail_g = self.lin_tail.index_select(0, idx)[:, GC - n_ctx:]
            prev = (self.prev_re.index_select(0, idx)[:, GC - n_ctx:],
                    self.prev_im.index_select(0, idx)[:, GC - n_ctx:])
        window = torch.cat([p for p in (tail_g, emit, new_pend)
                            if p is not None and p.shape[1]], dim=1)
        wav_win, (re, im) = streaming.gl_window(self.ap, window, prev,
                                                self.iters)
        tail_seq = emit if tail_g is None else torch.cat([tail_g, emit], 1)
        self.lin_tail = self.lin_tail.index_copy(
            0, idx, right_align(tail_seq[:, -n_ctx2:], GC))
        lo_s, hi_s = n_ctx + emit_n - n_ctx2, n_ctx + emit_n
        self.prev_re = self.prev_re.index_copy(
            0, idx, right_align(re[:, lo_s:hi_s], GC))
        self.prev_im = self.prev_im.index_copy(
            0, idx, right_align(im[:, lo_s:hi_s], GC))
        if GLA:
            self.pend = self.pend.index_copy(
                0, idx, new_pend if keep_la else torch.zeros_like(
                    self.pend[:S]))
        lo, hi = n_ctx * self.hop, (n_ctx + emit_n) * self.hop
        raw = wav_win[:, lo - self.xfade:hi] if n_ctx else wav_win[:, :hi]
        if row or raw.shape[1] > self.m_max:
            return raw
        raw = torch.cat([raw.new_zeros(S, self.m_max - raw.shape[1]), raw],
                        dim=1)
        self.raw_buf = self.raw_buf.index_copy(0, idx, raw)
        return "buf"

    def complete_rows(self, idx, raw, had_tail):
        """Host half for one group's fetched (G, m) samples: crossfade with
        the held tails, inverse pre-emphasis IIR with carried state.
        Returns (G, m') float32 samples (callers apply per-slot trims)."""
        from scipy.signal import lfilter

        if had_tail:
            head, rest = raw[:, :self.xfade], raw[:, self.xfade:]
            assert rest.shape[1] >= self.xfade, (rest.shape, self.xfade)
            blend = (self.raw_tail[idx] * (1.0 - self.ramp)
                     + head * self.ramp)
            cut = rest.shape[1] - self.xfade
            out = np.concatenate([blend, rest[:, :cut]], axis=1)
            self.raw_tail[idx] = rest[:, cut:]
        else:
            assert raw.shape[1] >= self.xfade, (raw.shape, self.xfade)
            cut = raw.shape[1] - self.xfade
            out = raw[:, :cut]
            self.raw_tail[idx] = raw[:, cut:]
        coef = self.ap.preemphasis_coef
        y, zi2 = lfilter([1.0], [1.0, -coef], out, axis=-1, zi=self.zi[idx])
        self.zi[idx] = zi2
        return y.astype(np.float32)

    def flush_tail(self, b):
        """Slot b's held crossfade tail through the IIR: the final samples
        of a retiring stream."""
        from scipy.signal import lfilter

        out = self.raw_tail[b:b + 1].copy()     # a view: copy before reset
        self.raw_tail[b] = 0.0
        coef = self.ap.preemphasis_coef
        y, zi2 = lfilter([1.0], [1.0, -coef], out, axis=-1,
                         zi=self.zi[b:b + 1])
        self.zi[b:b + 1] = zi2
        return y.astype(np.float32)


class ContinuousBatcher:
    """Fixed-slot continuous-batching streaming synthesizer, on the device
    the parameters live on (kernels B1 and B2 on the card, their plain
    versions on the CPU).

    submit(text) returns a queue delivering ("audio", (m,) float32) items
    followed by ("end", decoded_steps), or ("error", exception). step()
    admits waiting requests and advances every active slot by one decode
    chunk; run it from a worker loop (run_loop, serve.TTSEngine(slots=N))
    or call it directly. Texts of any length up to the model's
    max_positions - 1 tokens."""

    def __init__(self, params, cfg, ap, frontend_mod, *, n_slots=4,
                 text_pad=64, chunk=16, max_decoder_steps=200,
                 gl_context=16, gl_lookahead=8, xfade=None,
                 max_backlog=None):
        dcfg = cfg.decoder
        self.params, self.cfg, self.ap = params, cfg, ap
        self.frontend = frontend_mod
        self.device = _param_device(params)
        self.n_slots = n_slots
        # text_pad: the first text bucket and the growth step; the hard cap
        # is the model's position table
        self.text_bucket = max(8, int(text_pad))
        self.text_cap = dcfg.max_positions - 1
        self.max_decoder_steps = max_decoder_steps
        # default: 8 waiting requests per slot, at which depth a new
        # request's first audio is already about an utterance away
        self.max_backlog = 8 * n_slots if max_backlog is None else max_backlog
        self.r = dcfg.r
        self.min_steps = dcfg.min_decoder_steps
        _, ctx_r = streaming.converter_context(cfg.converter)
        if chunk * self.r <= ctx_r:
            # the converter lookahead must fit in one chunk's frames; bump
            # rather than fail (nyanko's non-causal highway stack has a deep
            # receptive field at r = 1)
            chunk = ctx_r // self.r + 1
        self.chunk = chunk
        self.multispeaker = cfg.n_speakers > 1
        self.use_state = cfg.use_decoder_state_for_postnet_input
        self.dec = fd.make_slot_decoder(params["decoder"], dcfg, n_slots,
                                        self.device)
        self.emit = _EmitEngine(params, cfg, ap, n_slots, chunk * self.r,
                                self.device, gl_context=gl_context,
                                gl_lookahead=gl_lookahead, xfade=xfade,
                                multispeaker=self.multispeaker)
        self._fetch = _Fetch(self.device)

        self._lock = threading.Lock()
        self._admission_lock = threading.Lock()
        self._waiting = queue.Queue()
        self._slots = [None] * n_slots
        self._tk = 0                 # current text bucket
        self._inputs = None          # fd.SlotInputs, from the first admission
        self._carry = None
        # cumulative wall time per step() phase (timing())
        self._phase_s = {"admit": 0.0, "decode_dispatch": 0.0,
                         "emit_dispatch": 0.0, "done_fetch": 0.0,
                         "complete": 0.0, "retire": 0.0}
        self._steps_run = 0
        # the pipeline (depth 1): the step in flight awaiting its harvest,
        # and the step-start emission state the retire path rewinds to
        self._pending = None
        self._emit_snap = None

    def timing(self):
        """Cumulative host wall-clock per step() phase since construction,
        {phase: total_ms}, plus n_steps. decode and emit dispatch are
        asynchronous launches on the card; done_fetch holds the step's one
        synchronisation, complete the host DSP."""
        with self._lock:
            out = {k: round(v * 1e3, 1) for k, v in self._phase_s.items()}
            out["n_steps"] = self._steps_run
        return out

    # -- request side -------------------------------------------------------

    def submit(self, text, speaker_id=None, p=0.0):
        """Thread-safe: enqueue a request; returns its delivery queue."""
        seq = np.asarray(self.frontend.text_to_sequence(text, p=p), np.int64)
        if len(seq) > self.text_cap:
            raise ValueError(
                "text of %d tokens exceeds the model's max_positions-1=%d"
                % (len(seq), self.text_cap))
        # speaker-ness is uniform across the slot batch: the slot inputs
        # have speaker rows or none
        if self.multispeaker and speaker_id is None:
            raise ValueError("multi-speaker model: speaker_id is required")
        if not self.multispeaker and speaker_id is not None:
            raise ValueError("single-speaker model: speaker_id must be None")
        if speaker_id is not None and not 0 <= speaker_id < \
                self.cfg.n_speakers:
            # checked on the host: on the card it would index out of bounds
            raise ValueError("speaker_id %d out of range for %d speakers"
                             % (speaker_id, self.cfg.n_speakers))
        out_q = DeliveryQueue()
        # check and put under one lock, so concurrent submits cannot pass
        # max_backlog together (not the engine lock, which step() holds for
        # a whole chunk)
        with self._admission_lock:
            if self._waiting.qsize() >= self.max_backlog:
                raise BacklogFull(
                    "waiting queue at max_backlog=%d; shed this request"
                    % self.max_backlog)
            self._waiting.put((seq, speaker_id, out_q))
        return out_q

    def waiting(self):
        """Waiting-queue depth (what max_backlog is compared with)."""
        return self._waiting.qsize()

    def active_slots(self):
        with self._lock:
            return sum(s is not None for s in self._slots)

    def pending(self):
        return self.active_slots() + self._waiting.qsize()

    # -- admission -----------------------------------------------------------

    def _bucket(self, n):
        b = self.text_bucket
        return min(-(-max(n, 1) // b) * b, max(self.text_cap, b))

    def _upload(self, a):
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _grow_tk(self, tk_new):
        """Grow the text dimension to a larger bucket: K/V pad with zeros,
        the mask with padding, so active slots decode as before."""
        if self._inputs is not None:
            self._inputs = fd.grow_slot_inputs(self._inputs, tk_new)
        self._tk = tk_new

    def _admit(self, slot, seq, speaker_id, out_q):
        if isinstance(out_q, DeliveryQueue):
            out_q.t_admit = time.time()
        tk_req = self._bucket(len(seq))
        if tk_req > self._tk:
            self._grow_tk(tk_req)
        x = np.zeros((1, tk_req), np.int64)
        pos = np.zeros((1, tk_req), np.int64)
        x[0, :len(seq)] = seq
        pos[0, :len(seq)] = np.arange(1, len(seq) + 1)
        length = np.array([len(seq)], np.int64)
        spk = (None if speaker_id is None
               else self._upload(np.array([speaker_id], np.int64)))
        fi, mask = _admit_inputs(self.params, self.cfg, self._upload(x),
                                 self._upload(pos), self._upload(length),
                                 spk)
        if self._inputs is None:
            self._inputs = fd.slot_inputs(fi, self.n_slots, self._tk,
                                          self.dec.att_w)
            self._carry = self.dec.zero_carry()
        # the expression of the kernel's scalar scale at a fresh stream's
        # Tk, so the slot's scale equals a fresh stream's bit for bit
        fd.write_slot_row(self._inputs, slot, fi, mask,
                          tk_req * math.sqrt(1.0 / tk_req))
        self.dec.reset_row(self._carry, slot)
        if self.emit.spk is not None:
            self.emit.spk[slot] = int(speaker_id)
        self.emit.reset_slot(slot)
        self._slots[slot] = _Slot(out_q)

    # -- the emission pipeline, grouped across slots -------------------------

    def _gl_sig(self, slot, n_new, keep_la):
        return (slot.n_ctx, slot.n_pend, n_new, keep_la)

    def _apply_gl_result(self, slot, n_new, keep_la):
        """Host bookkeeping of StreamingVocoder.push/flush."""
        frames = slot.n_pend + n_new
        if keep_la and frames <= self.emit.GLA:
            slot.n_pend = frames            # absorbed, nothing emitted
            return 0
        emit_n = frames - (self.emit.GLA if keep_la else 0)
        slot.n_pend = self.emit.GLA if keep_la else 0
        slot.n_ctx = min(self.emit.GC, slot.n_ctx + emit_n)
        return emit_n

    def _put_audio(self, slot, audio_row):
        """Deliver one slot's samples, trimmed to the decoded length once
        the done latch has fixed it."""
        if slot.n_total is not None:
            audio_row = audio_row[:max(0, slot.n_total - slot.emitted)]
        if audio_row.shape[0]:
            slot.out_q.put(("audio", audio_row))
            slot.emitted += audio_row.shape[0]

    def _emit_step(self, active):
        """The step's emission for every active slot: one converter call
        and one Griffin-Lim window per (converter window, Griffin-Lim
        phase) signature group, on the group's rows. Returns (jobs,
        has_raw): has_raw when some group's samples went into raw_buf."""
        # group by converter signature (before M and e_m move), then by
        # Griffin-Lim signature: equal converter windows can sit at
        # different vocoder phases
        conv_groups = {}
        for b in active:
            slot = self._slots[b]
            # the retire path rewinds to this when the pipelined latch
            # finds that this chunk overshot the done frame
            slot.prev_phase = (slot.M, slot.e_m, slot.n_ctx, slot.n_pend)
            slot.M += self.chunk * self.r
            conv_groups.setdefault(self.emit.conv_sig(slot), []).append(b)
        jobs, has_raw = [], False
        for sig, idx in conv_groups.items():
            n_new = (sig[2] - sig[1]) * self.emit.up
            gl_groups = {}
            for b in idx:
                gl_groups.setdefault(self._gl_sig(self._slots[b], n_new,
                                                  True), []).append(b)
            for gsig, slots in gl_groups.items():
                slots_np = np.asarray(slots, np.int64)
                raw = self.emit.dispatch(gsig, slots_np, conv_sig=sig)
                has_raw |= isinstance(raw, str)
                jobs.append((slots_np, [self._slots[b] for b in slots_np],
                             raw, gsig[0] > 0, gsig))
                # the phase moves at dispatch (it depends on signatures
                # only), so the next step's signatures need no fetch
                for b in slots_np:
                    slot = self._slots[b]
                    self._apply_gl_result(slot, n_new, True)
                    slot.e_m = slot.M - self.emit.ctx_r
        return jobs, has_raw

    def _complete_jobs(self, jobs, raw_host):
        """Deliver one step's groups from its fetched samples: crossfade
        and IIR on the host, per-slot audio. Rows whose slot has retired
        or been re-admitted since are dropped: a retiring slot's extra
        in-flight chunk was rewound and its samples are re-emitted exactly
        by the retire flush, and its tails belong to the next occupant."""
        for slots_np, slot_objs, raw, had_tail, gsig in jobs:
            if raw is None:                  # absorbed into the lookahead
                continue
            keep = [i for i, (b, s) in enumerate(zip(slots_np, slot_objs))
                    if self._slots[b] is s]
            if not keep:
                continue
            idx = slots_np[keep]
            if isinstance(raw, str):         # in the step's raw_buf
                m_g = self.emit.raw_width(gsig)
                rows = raw_host[idx][:, self.emit.m_max - m_g:]
            else:
                rows = raw.cpu().numpy()[keep]
            audio = self.emit.complete_rows(idx, rows, had_tail)
            for i, b in enumerate(idx):
                self._put_audio(self._slots[b], audio[i])

    def _finish_slot(self, b, n_dec):
        """Retire slot b: emit the held-back converter lookahead [e_m, M)
        and flush the vocoder lookahead and crossfade tail, the sequence of
        StreamEmitter.finish / StreamingVocoder.flush, through the grouped
        dispatch with one member; both windows are launched before one
        device-to-host copy of their samples."""
        slot = self._slots[b]
        slot.n_total = streaming.decoded_samples(self.cfg, self.ap, n_dec)
        idx1 = np.asarray([b], np.int64)
        emits = []                           # (gsig, (1, m) device samples)
        if slot.M > slot.e_m:
            sig = self.emit.final_conv_sig(slot, slot.M)
            n_new = (sig[2] - sig[1]) * self.emit.up
            gsig = self._gl_sig(slot, n_new, True)
            raw = self.emit.dispatch(gsig, idx1, conv_sig=sig, row=True)
            self._apply_gl_result(slot, n_new, True)
            if raw is not None:
                emits.append((gsig, raw))
            slot.e_m = slot.M
        if slot.n_pend:
            gsig = self._gl_sig(slot, 0, False)
            emits.append((gsig, self.emit.dispatch(gsig, idx1, row=True)))
            self._apply_gl_result(slot, 0, False)
        if emits:
            host = torch.cat([r for _, r in emits], dim=1).cpu().numpy()
            o = 0
            for gsig, r in emits:
                w = r.shape[1]
                audio = self.emit.complete_rows(idx1, host[:, o:o + w],
                                                gsig[0] > 0)
                self._put_audio(slot, audio[0])
                o += w
        self._put_audio(slot, self.emit.flush_tail(b)[0])
        slot.out_q.put(("end", n_dec))
        self._slots[b] = None

    # -- the step ----------------------------------------------------------

    @torch.inference_mode()
    def step(self):
        """Admit waiting requests, launch one decode chunk and the emission
        for every active slot, then harvest the previous step (pipeline of
        depth 1): its one blocking copy comes after this step's launches,
        so it overlaps them.

        What the pipeline costs, at most one chunk each: a slot's done
        latch is seen one step late, so it decodes one wasted chunk; the
        retire path rewinds its emission rows to the step-start snapshot
        and its phase counters to prev_phase and flushes as an unpipelined
        stream would, and the extra chunk's samples are dropped at delivery
        (_complete_jobs); the first audio comes one step later.

        Returns the number of slots launched, or, with no active slot, 1
        while a step in flight remains to harvest and 0 when idle."""
        with self._lock:
            t0 = time.perf_counter()
            for b in range(self.n_slots):
                if self._slots[b] is None and not self._waiting.empty():
                    try:
                        seq, sid, out_q = self._waiting.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        self._admit(b, seq, sid, out_q)
                    except Exception as e:       # noqa: BLE001
                        out_q.put(("error", e))
                        raise
            active = [b for b in range(self.n_slots)
                      if self._slots[b] is not None]
            if not active:
                worked = self._pending is not None
                self._process_pending(dispatched=False)
                return 1 if worked else 0
            t1 = time.perf_counter()
            self._phase_s["admit"] += t1 - t0
            self._steps_run += 1

            em = self.emit
            self._emit_snap = (em.hist, em.lin_tail, em.prev_re,
                               em.prev_im, em.pend)
            # ONE B1 launch for every slot, each at its own position
            outs = self.dec.new_outputs(self.chunk, self._tk)
            self.dec.launch(self._inputs, self._carry, outs, self.chunk)
            o, _, d, s = outs
            pin = (s if self.use_state else o).reshape(
                self.n_slots, self.chunk * self.r, -1)
            if pin.shape[1] >= em.H:
                em.hist = pin[:, -em.H:]
            else:
                em.hist = torch.cat([em.hist[:, pin.shape[1]:], pin], dim=1)
            t2 = time.perf_counter()
            self._phase_s["decode_dispatch"] += t2 - t1

            jobs, has_raw = self._emit_step(active)
            # the done flags and the step's samples, in one copy
            fetch = self._fetch.start(torch.cat([d, em.raw_buf], dim=1))
            t3 = time.perf_counter()
            self._phase_s["emit_dispatch"] += t3 - t2

            entries = [(b, self._slots[b], self._slots[b].local_steps)
                       for b in active]
            for b in active:
                self._slots[b].local_steps += self.chunk
            prev_pending = self._pending
            self._pending = {"jobs": jobs, "fetch": fetch,
                             "has_raw": has_raw, "entries": entries}
            self._process_pending(dispatched=True, pending=prev_pending)
            return len(active)

    def _process_pending(self, dispatched, pending="take"):
        """Harvest a step in flight: wait for its copy, latch the done
        flags, deliver its audio (after the latch, so decoded-length trims
        apply to it), then retire the finished slots.

        `dispatched`: the caller launched a new step before this harvest.
        Then a newly latched slot has one overshoot chunk in flight, and
        its emission rows (device) and phase counters (host) are rewound
        before the flush; a drain call launched nothing, so no rewind."""
        if pending == "take":
            pending, self._pending = self._pending, None
        if pending is None:
            return
        t4 = time.perf_counter()
        retires = []
        payload = self._fetch.wait(pending["fetch"])    # the one sync
        d_host = payload[:, :self.chunk]
        raw_host = payload[:, self.chunk:] if pending["has_raw"] else None
        for b, slot, base in pending["entries"]:
            if self._slots[b] is not slot:             # already retired
                continue
            gstep = base + np.arange(1, self.chunk + 1)
            row = (d_host[b] > 0.5) & (gstep > self.min_steps)
            slot.done_rows.append(row)
            slot.latched |= bool(row.any())
            processed = base + self.chunk
            if slot.latched or processed >= self.max_decoder_steps:
                done_all = np.concatenate(slot.done_rows)
                n_dec = (int(done_all.argmax()) + 1 if slot.latched
                         else processed)
                # a chunk can overshoot the latch and max_decoder_steps;
                # the reported length and every sample from here on are
                # trimmed to the capped decoded length
                n_dec = min(n_dec, self.max_decoder_steps)
                slot.n_total = streaming.decoded_samples(
                    self.cfg, self.ap, n_dec)
                retires.append((b, slot, n_dec))
        t5 = time.perf_counter()
        self._phase_s["done_fetch"] += t5 - t4
        self._complete_jobs(pending["jobs"], raw_host)
        t6 = time.perf_counter()
        self._phase_s["complete"] += t6 - t5
        em = self.emit
        for b, slot, n_dec in retires:
            if dispatched:
                # rewind the overshoot chunk launched this step
                (em.hist, em.lin_tail, em.prev_re, em.prev_im,
                 em.pend) = _restore_rows(
                    (em.hist, em.lin_tail, em.prev_re, em.prev_im, em.pend),
                    self._emit_snap, em.index([b]))
                slot.M, slot.e_m, slot.n_ctx, slot.n_pend = slot.prev_phase
            self._finish_slot(b, n_dec)
        self._phase_s["retire"] += time.perf_counter() - t6

    def _fail_all(self, exc):
        """Deliver an engine failure to every active and waiting request,
        then free the slots so that the worker keeps serving."""
        with self._lock:
            self._pending = None
            for b in range(self.n_slots):
                if self._slots[b] is not None:
                    self._slots[b].out_q.put(("error", exc))
                    self._slots[b] = None
        while True:
            try:
                _, _, out_q = self._waiting.get_nowait()
            except queue.Empty:
                break
            out_q.put(("error", exc))

    def run_loop(self, stop_event):
        """Worker loop (serve.TTSEngine(slots=N)): steps while there is
        work, sleeps briefly when idle. An engine error fails the affected
        requests (("error", exc) on their queues) and the loop goes on."""
        while not stop_event.is_set():
            try:
                n = self.step()
            except Exception as e:              # noqa: BLE001
                traceback.print_exc()
                self._fail_all(e)
                n = 0
            if n == 0:
                time.sleep(0.005)
