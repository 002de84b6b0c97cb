# coding: utf-8
"""Streaming synthesis, counterpart of deepvoice3_pytorch_tpu/streaming.py:
batched text -> audio chunk by chunk, so that the first samples exist after
one decode chunk (time to first audio, TTFA) rather than after the whole
utterance. Everything runs where the parameters live.

  1. Decode: the launch-and-carry decoder of ops/fused_decode.make_decoder
     (kernel B1 on the card, the plain step on the CPU), `first_chunk`
     frames in the first launch and `chunk` per launch after it; the host
     reads the done flags after each launch and stops at the done-latch rule
     at chunk granularity.
  2. Converter on a window of decoder outputs with enough context on both
     sides (`converter_context`) that every emitted linear frame equals the
     full-utterance converter's. Emission lags the decoder by the right
     context.
  3. Vocoder: `StreamingVocoder`, phase-coherent windowed Griffin-Lim. Each
     window re-retrieves `gl_context` already-played frames pinned to their
     retrieved spectrum (kernel B2's anchored mode on the card where hop |
     fft, else the general-hop loop in f32, `gl_window`), anchors the new
     frames' SPSI phase to the context, and holds
     back `gl_lookahead` frames; adjacent emissions are crossfaded, and the
     inverse pre-emphasis IIR runs on the host (scipy lfilter with carried
     state; dsp/stft.py:inv_preemphasis_carry is the on-device equivalent).
"""

import math

import numpy as np
import torch

from .builder import embed_speakers, model_postnet
from .dsp import gl_cuda
from .dsp import stft as dsp
from .ops import core
from .ops import fused_decode as fd
from .synthesis import _param_device, _prepare_batch, speaker_id_tensor

CONV_BUCKET = 16      # converter window length bucket (mel frames)
# A window's anchored start re-converges locally, so windows take at least
# this many iterations (the JAX package measured 16 -> 32 iterations close
# the seam penalty on the golden fixture: spectral convergence 0.1635 ->
# 0.1372 streamed against 0.1442 whole).
GL_MIN_ITERS = 32


# ---------------------------------------------------------------------------
# converter receptive field (exactness contract for windowed application)
# ---------------------------------------------------------------------------


def decoded_samples(cfg, ap, dec_steps):
    """Waveform samples of `dec_steps` decoder steps: dec_steps * r mel
    frames, upsampled by the converter, hop samples per linear frame."""
    return int(dec_steps) * cfg.r * cfg.converter.time_upsampling \
        * ap.hop_size


def converter_context(ccfg):
    """(left, right) context in converter-input frames such that output
    frame t depends only on inputs [t - left, t + right].

    Walks the spec list tracking the time-rate multiplier: a conv at an
    upsampled rate needs proportionally fewer input-rate frames; a convT
    with kernel size = stride tiles exactly and adds no context. One frame
    of margin on each side guards the rounding of the rate division."""
    rate = 1.0
    left = right = 0.0
    for s in ccfg.specs:
        if s.kind == "convT":
            if s.kernel_size != s.stride:
                raise NotImplementedError(
                    "converter_context: convT with kernel_size != stride "
                    "(%d != %d) needs explicit receptive-field handling"
                    % (s.kernel_size, s.stride))
            rate *= s.stride
        elif s.kernel_size > 1:
            span = (s.kernel_size - 1) * s.dilation
            if s.causal:
                left += span / rate
            else:
                left += (span / 2.0) / rate
                right += (span / 2.0) / rate
    return int(math.ceil(left)) + 1, int(math.ceil(right)) + 1


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------


def prepare_decode(params, cfg, x, pos, lengths, max_total,
                   speaker_ids=None):
    """Everything launch-invariant: speaker embedding, encoder, padding
    mask, fused-decode inputs (with the speaker biases), the decoder for the
    device, its zero carry and its output buffers (outputs, alignments,
    done, decoder_states) of max_total frames."""
    dcfg = cfg.decoder
    fam = cfg.family
    speaker_embed = embed_speakers(params, cfg, speaker_ids)
    encoder_out = fam.encoder_apply(params["encoder"], cfg.encoder, x,
                                    speaker_embed=speaker_embed)
    mask = core.get_mask_from_lengths(lengths, encoder_out[0].shape[1])
    fi = fam.fused_decode_inputs(params["decoder"], dcfg, encoder_out, pos,
                                 max_total, speaker_embed=speaker_embed)
    dec = fd.make_decoder(params["decoder"], dcfg, fi, mask, max_total)
    init = torch.zeros(x.shape[0], dcfg.in_dim * dcfg.r, device=x.device)
    return dec, dec.zero_carry(init), dec.new_outputs(max_total)


def launch_chunk(dec, carry, outputs, t0, steps):
    """Decode frames t0 .. t0+steps-1 from the carry; returns their
    (outputs, alignments, done, decoder_states) views."""
    dec.launch(carry, outputs, t0, steps)
    return tuple(o[:, t0:t0 + steps] for o in outputs)


# ---------------------------------------------------------------------------
# streaming vocoder (windowed Griffin-Lim + crossfade + exact IIR carry)
# ---------------------------------------------------------------------------


def gl_window(ap, spec, prev_spec, iters):
    """One vocoder window, shared by StreamingVocoder and the continuous-
    batching emission (serving.py): denormalize + power, then one Griffin-
    Lim call from the anchored SPSI start (`gl_cuda.anchored_start`) with
    the context frames pinned, on `ap.window_route` (counted in
    `ap.routes`):
      * "b2" (hop | fft): kernel B2 on the card, the start computed inside
        the kernel;
      * "general" (any other hop): the JAX stream vocoder's fallback, the
        loop of dsp/stft.py `griffin_lim` in f32 throughout (JAX passes no
        carry or matmul dtype there) from the unwrapped SPSI start, the
        context frames pinned to prev_spec as given.
    spec: (B, n, F) normalized linear frames whose first n_ctx frames are
    context; prev_spec: their retrieved (re, im), each (B, n_ctx, F), or
    None. Returns (waveform (B, n * hop), retrieved (re, im))."""
    S = ap._denorm_pow(spec.float())
    fft, hop = ap.fft_size, ap.hop_size
    route = ap.window_route
    ap.count_route(route)
    if route == "b2":
        return gl_cuda.griffin_lim(
            S, fft, hop, ap.window_np, n_iters=iters,
            momentum=ap.gl_momentum, mats=ap.mats(S.device),
            phase_init="anchored", context_spec=prev_spec, return_spec=True)
    i_re, i_im, _ = gl_cuda.anchored_start(S, fft, hop, prev_spec,
                                           unwrapped=True)
    return dsp.griffin_lim(
        S, fft, hop, ap.window_np, n_iters=iters, momentum=ap.gl_momentum,
        mats=ap.mats(S.device, carry="f32"), init_spec=(i_re, i_im),
        pinned_prefix=prev_spec, return_spec=True, carry="f32")


def require_causal_framing(ap):
    """Streaming needs the lws framing: each window's samples start at its
    first frame. Raise ValueError for the centred one."""
    if ap.stft_mode != "lws":
        raise ValueError("streaming needs stft_mode='lws' (causal framing: "
                         "a window's samples are frame-aligned), got %r"
                         % (ap.stft_mode,))


class StreamingVocoder:
    """Incremental normalized linear spectrogram -> waveform.

    push(frames) consumes (B, n, F) new linear frames and returns the next
    (B, m) samples; flush() vocodes the held-back lookahead and returns the
    final samples. Each Griffin-Lim window is
    [gl_context emitted frames | emission | gl_lookahead future frames]:
      * the context frames start from the previous window's retrieved
        spectrum and are pinned through every iteration (already-played
        audio cannot change);
      * the new frames' SPSI start is phase-shifted per bin so that the
        context's last frame lines up with its retrieved phase;
      * the lookahead keeps emitted samples away from the window's edge.
    Adjacent emissions are crossfaded over `xfade` samples, and the inverse
    pre-emphasis IIR runs over the crossfaded stream on the host."""

    def __init__(self, ap, gl_context=16, gl_lookahead=8, xfade=None):
        require_causal_framing(ap)
        self.ap = ap
        self.hop = ap.hop_size
        self.gl_context = int(gl_context)
        self.gl_lookahead = int(gl_lookahead)
        self.xfade = self.hop if xfade is None else int(xfade)
        if self.xfade > self.gl_context * self.hop:
            raise ValueError("xfade (%d samples) exceeds the context (%d "
                             "samples)" % (self.xfade,
                                           self.gl_context * self.hop))
        self.iters = max(ap.gl_iters, GL_MIN_ITERS)
        self._lin_tail = None       # (B, <=gl_context, F) emitted context
        self._prev_spec = None      # (re, im) retrieved spectrum of _lin_tail
        self._pending = None        # (B, <=gl_lookahead, F) not yet emitted
        self._raw_tail = None       # (B, xfade) host, pre-IIR
        self._had_tail = False      # a previous emission exists (crossfade)
        self._zi = None             # lfilter state (per batch row)
        self._ramp = np.linspace(0.0, 1.0, self.xfade, endpoint=False,
                                 dtype=np.float32)

    def _gl(self, spec, prev_spec):
        return gl_window(self.ap, spec, prev_spec, self.iters)

    def _iir(self, x):
        from scipy.signal import lfilter

        coef = self.ap.preemphasis_coef
        if self._zi is None:
            self._zi = np.zeros((x.shape[0], 1), np.float32)
        y, self._zi = lfilter([1.0], [1.0, -coef], x, axis=-1, zi=self._zi)
        return y.astype(np.float32)

    def _vocode_async(self, emit, future):
        """Device half of a window: Griffin-Lim over [context | emit |
        future], update the carry (context frames and their retrieved
        spectrum), return a token for _finish_raw. No host sync."""
        parts = [p for p in (self._lin_tail, emit, future)
                 if p is not None and p.shape[1] > 0]
        window = torch.cat(parts, dim=1)
        n_ctx = 0 if self._lin_tail is None else self._lin_tail.shape[1]
        n_emit = emit.shape[1]
        wav_win, spec_out = self._gl(window, self._prev_spec)
        # retrieved spectrum of the frames that are now emitted context
        lo_f = max(0, n_ctx + n_emit - self.gl_context)
        self._prev_spec = tuple(c[:, lo_f:n_ctx + n_emit] for c in spec_out)
        self._lin_tail = (emit if self._lin_tail is None else
                          torch.cat([self._lin_tail, emit], dim=1)
                          )[:, -self.gl_context:]
        lo, hi = n_ctx * self.hop, (n_ctx + n_emit) * self.hop
        if self._had_tail:
            assert lo >= self.xfade, (
                "crossfade (%d samples) exceeds the emitted context "
                "(%d samples)" % (self.xfade, lo))
            token = (wav_win[:, lo - self.xfade:hi], True)
        else:
            token = (wav_win[:, :hi], False)
        self._had_tail = True
        return token

    def _finish_raw(self, token):
        """Host half: fetch the window's samples and crossfade them with the
        held tail; returns pre-IIR samples. Call in dispatch order."""
        wav, had_tail = token
        raw = wav.cpu().numpy()
        head = None
        if had_tail:
            head, raw = raw[:, :self.xfade], raw[:, self.xfade:]
        assert raw.shape[1] >= self.xfade, (
            "emission shorter than the crossfade: %d < %d"
            % (raw.shape[1], self.xfade))
        out = []
        if head is not None:
            out.append(self._raw_tail * (1.0 - self._ramp)
                       + head * self._ramp)
        # an explicit end index: with xfade = 0, raw[:, :-0] would be empty
        cut = raw.shape[1] - self.xfade
        out.append(raw[:, :cut])
        self._raw_tail = raw[:, cut:]
        return np.concatenate(out, axis=1)

    def push_async(self, lin_new):
        """Dispatch the vocode of new frames; returns a token for finish(),
        or None when everything went into the lookahead buffer."""
        frames = (lin_new if self._pending is None
                  else torch.cat([self._pending, lin_new], dim=1))
        if frames.shape[1] <= self.gl_lookahead:
            self._pending = frames
            return None
        if self.gl_lookahead:
            emit = frames[:, :-self.gl_lookahead]
            self._pending = frames[:, -self.gl_lookahead:]
        else:
            emit, self._pending = frames, None
        return self._vocode_async(emit, self._pending)

    def finish(self, token):
        """Complete a push_async; (B, 0) for a None token."""
        if token is None:
            B = 1 if self._pending is None else self._pending.shape[0]
            return np.zeros((B, 0), np.float32)
        return self._iir(self._finish_raw(token))

    def push(self, lin_new):
        """lin_new: (B, n, F) normalized linear frames, contiguous with all
        previous pushes. Returns (B, m) float32 samples (m can be 0)."""
        return self.finish(self.push_async(lin_new))

    def flush(self):
        """Vocode the held-back lookahead and emit the crossfade tail; the
        stream is complete after this. Returns (B, m) or None."""
        outs = []
        if self._pending is not None and self._pending.shape[1] > 0:
            outs.append(self._finish_raw(self._vocode_async(self._pending,
                                                            None)))
            self._pending = None
        if self._raw_tail is not None:
            outs.append(self._raw_tail)
            self._raw_tail = None
        if not outs:
            return None
        return self._iir(np.concatenate(outs, axis=1))


# ---------------------------------------------------------------------------
# converter window + vocoder emission state for one stream
# ---------------------------------------------------------------------------


class StreamEmitter:
    """Post-decode half of a stream: accumulates postnet-input frames, runs
    the windowed converter with receptive-field context, and drives a
    StreamingVocoder.

    feed_async(pin) dispatches the emission that new frames make valid
    (device work only), feed_finish(token) completes it; finish() emits the
    held-back converter lookahead and the vocoder tail. speaker_ids (B,):
    the converter window's speakers, for a multi-speaker model."""

    def __init__(self, params, cfg, ap, speaker_ids=None, *, gl_context=16,
                 gl_lookahead=8, xfade=None):
        self.params = params
        self.cfg = cfg
        self.speaker_ids = speaker_ids
        self.up = cfg.converter.time_upsampling
        self.ctx_l, self.ctx_r = converter_context(cfg.converter)
        self.vocoder = StreamingVocoder(ap, gl_context=gl_context,
                                        gl_lookahead=gl_lookahead,
                                        xfade=xfade)
        self.mel_hist = None    # (B, M, D)
        self.M = 0              # postnet frames accumulated
        self.e_m = 0            # postnet frames emitted

    def conv_emit(self, emit_to_m):
        """Converter on a bucketed window: exact linear frames of mel region
        [e_m, emit_to_m). The window [ws, M) starts at least ctx_l before
        e_m (or at 0, the true start), so every emitted frame has its whole
        receptive field inside it."""
        W = self.M - max(0, self.e_m - self.ctx_l)
        Wb = min(self.M, -(-W // CONV_BUCKET) * CONV_BUCKET)
        ws = self.M - Wb
        lin_win = model_postnet(self.params, self.cfg,
                                self.mel_hist[:, ws:self.M],
                                speaker_ids=self.speaker_ids)
        return lin_win[:, (self.e_m - ws) * self.up:(emit_to_m - ws) * self.up]

    def feed_async(self, pin):
        """pin: (B, steps*r, D) new postnet-input frames. Dispatches the
        emission [e_m, M - ctx_r); returns a token for feed_finish (None when
        nothing can be emitted yet)."""
        self.mel_hist = (pin if self.mel_hist is None
                         else torch.cat([self.mel_hist, pin], dim=1))
        self.M += pin.shape[1]
        emit_to = self.M - self.ctx_r
        if emit_to <= self.e_m:
            return None
        lin_new = self.conv_emit(emit_to)
        return (emit_to, lin_new, self.vocoder.push_async(lin_new))

    def feed_finish(self, token):
        """Returns (audio (B, m), lin_new or None)."""
        if token is None:
            B = 1 if self.mel_hist is None else self.mel_hist.shape[0]
            return np.zeros((B, 0), np.float32), None
        emit_to, lin_new, tok = token
        audio = self.vocoder.finish(tok)
        self.e_m = emit_to
        return audio, lin_new

    def finish(self):
        """Final emissions: the held-back converter lookahead [e_m, M) and
        the vocoder's lookahead and crossfade tail. Returns (audio (B, m),
        lin_last or None)."""
        parts, lin_last = [], None
        if self.M > self.e_m:
            lin_last = self.conv_emit(self.M)
            parts.append(self.vocoder.push(lin_last))
            self.e_m = self.M
        tail = self.vocoder.flush()
        if tail is not None:
            parts.append(tail)
        if not parts:
            B = 1 if self.mel_hist is None else self.mel_hist.shape[0]
            return np.zeros((B, 0), np.float32), lin_last
        return np.concatenate(parts, axis=1), lin_last


# ---------------------------------------------------------------------------
# the streaming synthesizer
# ---------------------------------------------------------------------------


@torch.inference_mode()
def tts_stream(params, cfg, ap, frontend_mod, texts, *, speaker_ids=None,
               p=0.0, max_decoder_steps=200, chunk=None, first_chunk=16,
               gl_context=16, gl_lookahead=8, xfade=None, pad_to=8,
               emit_linear=False, emit_alignment=False):
    """Generator: batched text -> incremental audio chunks, on the device
    the parameters live on.

    Yields dicts:
      audio          (B, m) float32 samples (the next contiguous piece)
      sample_start   stream offset of audio[:, 0]
      decoded_steps  (B,) per-sample decoded lengths, on the last chunk only
                     (None before); frames of shorter samples after their
                     done frame are the model's post-done output, as in
                     tts_batch before its per-sample trim
      final          True on the last chunk
      linear         (B, n, F) emitted linear frames (emit_linear=True)
      alignment      (B, dec_steps, Tk) attention over the whole decode,
                     last chunk only (emit_alignment=True)

    The decoder runs `first_chunk` frames in the first launch, then `chunk`
    (default ops/fused_decode.DEFAULT_CHUNK) per launch, and stops at the
    done-latch rule (done > 0.5 after min_decoder_steps) at chunk
    granularity. speaker_ids: one id per text for a multi-speaker model."""
    if chunk is None:
        chunk = fd.DEFAULT_CHUNK
    device = _param_device(params)
    x, pos, lengths = (torch.from_numpy(a).to(device)
                       for a in _prepare_batch(frontend_mod, texts, p, pad_to))
    spk = speaker_id_tensor(cfg, speaker_ids, device)
    B = x.shape[0]
    dcfg = cfg.decoder
    r = dcfg.r
    _, ctx_r = converter_context(cfg.converter)
    min_steps = dcfg.min_decoder_steps
    if first_chunk * r <= ctx_r:
        raise ValueError("first_chunk too small for the converter lookahead: "
                         "%d*%d <= %d" % (first_chunk, r, ctx_r))

    schedule = [min(first_chunk, max_decoder_steps)]
    while sum(schedule) < max_decoder_steps:
        schedule.append(min(chunk, max_decoder_steps - sum(schedule)))
    max_total = sum(schedule)

    dec, carry, outputs = prepare_decode(params, cfg, x, pos, lengths,
                                         max_total, speaker_ids=spk)
    emitter = StreamEmitter(params, cfg, ap, spk, gl_context=gl_context,
                            gl_lookahead=gl_lookahead, xfade=xfade)

    done_rows = []         # host (B, steps) per chunk
    latched = np.zeros((B,), bool)
    dec_steps = 0          # decoder steps decoded so far
    sample_start = 0

    for steps in schedule:
        o, _, d, s = launch_chunk(dec, carry, outputs, dec_steps, steps)
        # postnet input frames of this chunk, (B, steps*r, D)
        pin = (s if cfg.use_decoder_state_for_postnet_input else o) \
            .reshape(B, steps * r, -1)
        dec_steps += steps

        # dispatch the emission that is valid in any case BEFORE reading the
        # done flags, so that the flag fetch follows the converter and
        # Griffin-Lim launches instead of holding them back
        token = emitter.feed_async(pin)

        d_host = d.cpu().numpy()                        # (B, steps)
        gstep = dec_steps - steps + np.arange(1, steps + 1)
        done_rows.append((d_host > 0.5) & (gstep[None, :] > min_steps))
        latched |= done_rows[-1].any(axis=1)
        stop = bool(latched.all()) or dec_steps >= max_total

        audio, lin_new = emitter.feed_finish(token)
        out = {"audio": audio, "sample_start": sample_start,
               "final": False, "decoded_steps": None}
        if emit_linear:
            out["linear"] = (lin_new.cpu().numpy() if lin_new is not None
                             else np.zeros((B, 0, 1), np.float32))
        sample_start += audio.shape[1]
        if not stop:
            if token is not None:
                yield out
            continue

        # final emissions: the held-back converter lookahead + vocoder tail
        tail, lin_last = emitter.finish()
        out["audio"] = np.concatenate([out["audio"], tail], axis=1)
        if emit_linear and lin_last is not None:
            lin_prev = (out["linear"] if out["linear"].shape[1]
                        else np.zeros((B, 0, lin_last.shape[2]), np.float32))
            out["linear"] = np.concatenate(
                [lin_prev, lin_last.cpu().numpy()], axis=1)
        # per-sample decoded lengths: frames through the first latched done
        # frame (inclusive), else every decoded frame
        done_all = np.concatenate(done_rows, axis=1)[:, :dec_steps]
        first = np.where(latched, done_all.argmax(axis=1) + 1, dec_steps)
        out["decoded_steps"] = first.astype(np.int32)
        out["final"] = True
        if emit_alignment:
            out["alignment"] = outputs[1][:, :dec_steps].cpu().numpy()
        yield out
        return
