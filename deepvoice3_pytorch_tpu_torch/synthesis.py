# coding: utf-8
"""Batch synthesis API, counterpart of deepvoice3_pytorch_tpu/synthesis.py.

`tts_batch` runs texts -> waveforms on the device the parameters live on:
  1. encoder + chunked early-exit autoregressive decode
     (ops/fused_decode.py: the CUDA kernel on the card),
  2. the converter on the decoder buffers trimmed to the batch's longest
     decoded length, bucketed,
  3. Griffin-Lim (dsp/gl_cuda.py) and inverse pre-emphasis on the
     correspondingly shorter linear spectrogram.
"""

import numpy as np
import torch

from .builder import model_decode, model_postnet
from .dsp.audio import AudioProcessor

# The post-decode trim keeps the batch's longest decoded length plus slack
# for the converter's receptive field, rounded up to a bucket, so every real
# frame sees the same converter context as an untrimmed run.
BUCKET_DEC_STEPS = 16
SLACK_DEC_STEPS = 8


def _round_up(n, k):
    return ((n + k - 1) // k) * k


def _prepare_batch(frontend_mod, texts, p=0.0, pad_to=None):
    seqs = [np.asarray(frontend_mod.text_to_sequence(t, p=p), np.int64)
            for t in texts]
    max_len = max(len(s) for s in seqs)
    if pad_to is not None:
        max_len = _round_up(max_len, pad_to)
    x = np.zeros((len(seqs), max_len), np.int64)
    pos = np.zeros((len(seqs), max_len), np.int64)
    lengths = np.zeros((len(seqs),), np.int64)
    for i, s in enumerate(seqs):
        x[i, :len(s)] = s
        pos[i, :len(s)] = np.arange(1, len(s) + 1)
        lengths[i] = len(s)
    return x, pos, lengths


def _param_device(params):
    return next(iter(params.parameters())).device


def speaker_id_tensor(cfg, speaker_ids, device):
    """A list or array of speaker ids -> (B,) int64 tensor on `device`, or
    None. Ids come from callers (an HTTP request's speaker_id among them),
    so they are checked here, on the host: an id out of range would index
    the speaker table out of bounds on the card."""
    if speaker_ids is None:
        return None
    ids = np.asarray(speaker_ids, np.int64).reshape(-1)
    if ids.size and (ids.min() < 0 or ids.max() >= cfg.n_speakers):
        raise ValueError("speaker ids %s out of range for %d speaker(s)"
                         % (ids.tolist(), cfg.n_speakers))
    return torch.as_tensor(ids, device=device)


@torch.inference_mode()
def tts_batch(params, cfg, ap: AudioProcessor, frontend_mod, texts, *,
              p=0.0, speaker_ids=None, max_decoder_steps=500,
              early_exit=True, pad_to=8):
    """Batched text -> waveform. Returns a list of per-utterance dicts with
    waveform / mel / linear / alignment (numpy, trimmed to the decoded
    lengths) and num_decoder_steps. Runs where `params` live.
    speaker_ids: one id per text for a multi-speaker model, else None."""
    device = _param_device(params)
    x, pos, lengths = (torch.from_numpy(a).to(device)
                       for a in _prepare_batch(frontend_mod, texts, p, pad_to))
    spk = speaker_id_tensor(cfg, speaker_ids, device)

    mel, pin, align, done, dec_lengths = model_decode(
        params, cfg, x, pos, speaker_ids=spk, input_lengths=lengths,
        max_decoder_steps=max_decoder_steps, early_exit=early_exit)

    # trim the postnet input to the batch's longest decoded length before
    # the converter and vocoder: their cost follows the decoded audio
    dec_lengths = dec_lengths.cpu().numpy()
    n_bucket = min(max_decoder_steps,
                   _round_up(int(dec_lengths.max()) + SLACK_DEC_STEPS,
                             BUCKET_DEC_STEPS))
    linear = model_postnet(params, cfg, pin[:, :n_bucket * cfg.r],
                           speaker_ids=spk)
    wav_batch = ap.inv_spectrogram_device(linear).cpu().numpy()
    mel = ap._denormalize(mel).cpu().numpy()
    linear = ap._denormalize(linear).cpu().numpy()
    align = align.cpu().numpy()
    lengths = lengths.cpu().numpy()

    results = []
    time_up = getattr(cfg.converter, "time_upsampling", 1)
    for i in range(len(texts)):
        n_dec = int(dec_lengths[i])
        n_mel = n_dec * cfg.r
        n_lin = n_mel * time_up
        results.append({
            "waveform": wav_batch[i][:n_lin * ap.hop_size],
            "mel": mel[i][:n_mel],
            "linear": linear[i][:n_lin],
            "alignment": align[i][:n_dec, :int(lengths[i])],
            "num_decoder_steps": n_dec,
        })
    return results


def tts(params, cfg, ap, frontend_mod, text, *, p=0.0, speaker_id=None,
        max_decoder_steps=500, fast=True):
    """Single-utterance synthesis: (waveform, alignment, spectrogram, mel)."""
    speaker_ids = None if speaker_id is None else [speaker_id]
    out = tts_batch(params, cfg, ap, frontend_mod, [text], p=p,
                    speaker_ids=speaker_ids,
                    max_decoder_steps=max_decoder_steps, early_exit=fast)[0]
    return out["waveform"], out["alignment"], out["linear"], out["mel"]
