# coding: utf-8
"""Shared preprocessing machinery of the corpus adapters, counterpart of
deepvoice3_pytorch_tpu/datasets/common.py.

Redesign of the reference's per-corpus `build_from_path` +
`_process_utterance` pattern (ljspeech.py:25-76, vctk.py:13-87, ...): host
threads load and trim the waveforms of a batch of 16 while the card computes
the batch's features in one pass (dsp.audio.AudioProcessor.batch_features);
or, on hosts without a card, the C++ library does (native/dv3_dsp.cc).

Output contract is unchanged: `<prefix>-spec-<idx>.npy` (n, 513) +
`<prefix>-mel-<idx>.npy` (n, 80) and metadata tuples for train.txt.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from os.path import exists, join
from typing import List, Optional
from warnings import warn

import numpy as np


@dataclass
class Utterance:
    wav_path: str
    text: str
    speaker_id: Optional[int] = None
    lab_path: Optional[str] = None
    lab_mode: Optional[str] = None     # 'pau' (vctk-style) | 'silB' (jsut)
    top_db: Optional[float] = None     # energy-trim fallback
    spec_name: Optional[str] = None    # output filenames (default indexed)
    mel_name: Optional[str] = None


def load_hts_labels(path):
    """HTK/HTS .lab: lines of 'start end label', times in 100 ns units
    (reference uses nnmnkwii.io.hts.load; vctk.py:59-63)."""
    labels = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 3:
                continue
            labels.append((int(parts[0]), int(parts[1]), parts[2]))
    return labels


def lab_trim_bounds_pau(labels):
    """First/last non-'pau' segment bounds (reference vctk.py:33-49)."""
    if labels[0][2] != "pau":
        start = labels[0][0]
    else:
        start = next(l[0] for l in labels[1:] if l[2] != "pau")
    if labels[-1][2] != "pau":
        end = labels[-1][1]
    else:
        end = next(l[1] for l in reversed(labels[:-1]) if l[2] != "pau")
    return start, end


def trim_silence(wav, top_db=60, frame_length=2048, hop_length=512):
    """librosa.effects.trim equivalent: drop leading/trailing frames more
    than top_db below the peak RMS."""
    if len(wav) < frame_length:
        return wav, (0, len(wav))
    n = 1 + (len(wav) - frame_length) // hop_length
    idx = np.arange(n)[:, None] * hop_length + np.arange(frame_length)
    rms = np.sqrt(np.mean(wav[idx] ** 2, axis=1))
    ref = rms.max()
    if ref <= 0:
        return wav, (0, len(wav))
    db = 20.0 * np.log10(np.maximum(rms / ref, 1e-10))
    keep = np.where(db > -top_db)[0]
    if len(keep) == 0:
        return wav, (0, len(wav))
    start = keep[0] * hop_length
    end = min(len(wav), keep[-1] * hop_length + frame_length)
    return wav[start:end], (start, end)


def load_and_trim(ap, hp, utt: Utterance):
    """Host-side wav pipeline: load -> (lab or energy) trim -> rescale."""
    wav = ap.load_wav(utt.wav_path)
    sr = hp.sample_rate
    if utt.lab_path is not None and exists(utt.lab_path):
        labels = load_hts_labels(utt.lab_path)
        if utt.lab_mode == "silB":
            assert labels[0][2] == "silB" and labels[-1][2] == "silE"
            b = int(labels[0][1] * 1e-7 * sr)
            e = int(labels[-1][0] * 1e-7 * sr)
            wav = wav[b:e]
        else:
            s, e = lab_trim_bounds_pau(labels)
            wav = wav[int(s * 1e-7 * sr):int(e * 1e-7 * sr)]
            wav, _ = trim_silence(wav, top_db=25)
    elif utt.top_db is not None:
        wav, _ = trim_silence(wav, top_db=utt.top_db)
    if hp.rescaling:
        wav = wav / np.abs(wav).max() * hp.rescaling_max
    return wav.astype(np.float32)


def _native_batch_features(ap, hp, wavs):
    """Features on the port's C++ host DSP library (native/dv3_dsp.cc), in
    the lws framing, for hosts without a card."""
    from .. import native

    return native.features_batch(
        wavs, ap.mel_filters_np, hp.fft_size, hp.hop_size,
        hp.preemphasis, hp.min_level_db, hp.ref_level_db)


def process_utterances(utts: List[Utterance], out_dir, ap, hp, prefix, *,
                       num_workers=4, batch_size=16, tqdm=lambda x: x,
                       backend=None, device="cuda"):
    """Load (threads) -> batched features -> save npys.

    backend: 'device' (default: `ap.batch_features` on `device`, the card
    unless the caller asks for the CPU) or 'native' (the C++ thread-pool
    DSP, lws framing only). The DV3_PREPROCESS_BACKEND environment
    variable gives the default.

    Returns metadata tuples: 4-tuple (spec, mel, n_frames, text) or 5-tuple
    with speaker_id (reference contract, preprocess.py:28-30).
    """
    backend = backend or os.environ.get("DV3_PREPROCESS_BACKEND", "device")
    if backend not in ("device", "native"):
        raise ValueError("preprocessing backend must be 'device' or "
                         "'native', got %r" % (backend,))
    if backend == "native" and ap.stft_mode != "lws":
        # dv3_dsp.cc hardcodes the lws conventions (PR-normalized symmetric
        # sqrt-Hann, causal ceil(T/hop) framing); silently extracting
        # center-mode corpora with it would mismatch the synthesis path, so
        # route those through AudioProcessor instead.
        warn("native preprocessing backend only implements stft_mode='lws'; "
             "falling back to the device backend for stft_mode=%r"
             % ap.stft_mode)
        backend = "device"
    os.makedirs(out_dir, exist_ok=True)
    metadata = [None] * len(utts)

    # sort by a cheap length proxy (file size) so device batches are dense
    order = sorted(range(len(utts)),
                   key=lambda i: os.path.getsize(utts[i].wav_path)
                   if exists(utts[i].wav_path) else 0)

    def run_batch(ex, batch_ids):
        wavs = list(ex.map(lambda i: load_and_trim(ap, hp, utts[i]),
                           batch_ids))
        if backend == "native":
            feats = _native_batch_features(ap, hp, wavs)
        else:
            feats = ap.batch_features(wavs, device=device)
        for i, (linear, mel) in zip(batch_ids, feats):
            utt = utts[i]
            spec_name = utt.spec_name or "%s-spec-%05d.npy" % (prefix, i + 1)
            mel_name = utt.mel_name or "%s-mel-%05d.npy" % (prefix, i + 1)
            np.save(join(out_dir, spec_name), linear.astype(np.float32),
                    allow_pickle=False)
            np.save(join(out_dir, mel_name), mel.astype(np.float32),
                    allow_pickle=False)
            n_frames = linear.shape[0]
            if utt.speaker_id is None:
                metadata[i] = (spec_name, mel_name, n_frames, utt.text)
            else:
                metadata[i] = (spec_name, mel_name, n_frames, utt.text,
                               utt.speaker_id)

    batches = [order[s:s + batch_size]
               for s in range(0, len(order), batch_size)]
    with ThreadPoolExecutor(max_workers=max(1, num_workers)) as ex:
        for b in tqdm(batches):
            run_batch(ex, b)
    return [m for m in metadata if m is not None]
