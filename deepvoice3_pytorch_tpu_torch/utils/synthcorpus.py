# coding: utf-8
"""Deterministic synthetic-language speech corpus, counterpart of
deepvoice3_pytorch_tpu/utils/synthcorpus.py.

Training data that needs no downloaded corpus comes from a synthetic
*language*: every character deterministically
maps to a fixed spectral unit (2 "formant" sinusoids + AM) with a fixed
per-character duration. The mapping text -> audio is exact and stationary,
which makes it a real (if easy) TTS problem: to predict the features the
model MUST align decoder frames to text positions (diagonal attention),
learn per-character durations, and fire the done flag at the end — the same
competencies LJSpeech training demonstrates, minus naturalness.

Features are extracted with the port's AudioProcessor (dsp/audio.py) and
batches collated with its collate (training/dataset.py).
"""

import numpy as np

_AMP = 0.35
_FADE_MS = 6.0


def char_unit(c, sample_rate, hop_size):
    """(duration_samples, f1, f2, am_rate) for one character — a stable
    ord-based hash, no RNG."""
    o = ord(c)
    if c == " " or not c.isalnum():
        # pause unit: 3 frames of near-silence
        return 3 * hop_size, 0.0, 0.0, 0.0
    dur_frames = 6 + (o * 29) % 8            # 6..13 STFT frames (~70-150ms)
    f1 = 180.0 + ((o * 37) % 23) * 85.0      # 180..2050 Hz
    f2 = 2300.0 + ((o * 53) % 17) * 170.0    # 2300..5020 Hz
    am = 2.0 + (o * 11) % 5                  # 2..6 Hz amplitude modulation
    return dur_frames * hop_size, f1, f2, am


def mean_frames_per_char(texts, sample_rate, hop_size):
    """Average STFT frames per character over `texts` — the analytic
    equivalent of compute_timestamp_ratio.py for this corpus."""
    tot_frames, tot_chars = 0, 0
    for t in texts:
        for c in t:
            n, _, _, _ = char_unit(c, sample_rate, hop_size)
            tot_frames += n // hop_size
            tot_chars += 1
    return tot_frames / max(tot_chars, 1)


def speaker_scale(speaker_id):
    """Per-speaker formant scale: speaker 0 = 1.0, each next ~18% higher —
    the synthetic language's analogue of different voices. Durations are
    shared across speakers (the language, not the voice, sets timing)."""
    return 1.0 + 0.18 * speaker_id


def synth_wav(text, sample_rate=22050, hop_size=256, tail_silence_s=0.1,
              speaker_id=None):
    """Deterministic waveform for `text` (float32 in [-1, 1]). With
    speaker_id, formant frequencies scale by speaker_scale(speaker_id)."""
    pieces = []
    fade = int(sample_rate * _FADE_MS / 1000.0)
    fs = speaker_scale(speaker_id) if speaker_id is not None else 1.0
    rs = np.random.RandomState(sum(ord(c) for c in text) % 65521)
    for c in text:
        n, f1, f2, am = char_unit(c, sample_rate, hop_size)
        t = np.arange(n) / sample_rate
        if f1 == 0.0:
            x = 0.002 * rs.randn(n)
        else:
            x = (np.sin(2 * np.pi * f1 * fs * t)
                 + 0.5 * np.sin(2 * np.pi * f2 * fs * t))
            x *= _AMP * (0.75 + 0.25 * np.sin(2 * np.pi * am * t))
            env = np.ones(n)
            k = min(fade, n // 2)
            env[:k] = np.linspace(0.0, 1.0, k)
            env[-k:] = np.linspace(1.0, 0.0, k)
            x = x * env + 0.002 * rs.randn(n)
        pieces.append(x)
    pieces.append(np.zeros(int(sample_rate * tail_silence_s)))
    return np.concatenate(pieces).astype(np.float32)


_WORDS = ("the bright sun rose over the quiet hills and the small birds "
          "began to sing while a cold wind moved through the tall green "
          "trees near the old stone bridge by the slow river").split()


def make_sentences(n, seed=0, min_words=3, max_words=9):
    """n deterministic sentences from a small word bank."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = int(rs.randint(min_words, max_words + 1))
        words = [_WORDS[int(rs.randint(len(_WORDS)))] for _ in range(k)]
        out.append(" ".join(words) + ".")
    return out


def build_items(texts, hp, ap, frontend_mod, p=0.0, speaker_ids=None,
                voice_ids=None, device="cuda"):
    """[{'text': int32 seq, 'mel': (T,80), 'linear': (T,513)}] via the
    feature pipeline (AudioProcessor.batch_features on `device`). With
    speaker_ids (parallel to texts), items carry 'speaker_id' and the
    audio is speaker-conditioned (speaker_scale). voice_ids, when given,
    decouples the RENDERED voice from the model's speaker slot — the
    speaker-adaptation scenario (reference README.md:317: a new voice's
    data assigned to an existing slot via --speaker-id)."""
    wavs = [synth_wav(t, hp.sample_rate, hp.hop_size,
                      speaker_id=(voice_ids[i] if voice_ids is not None
                                  else None if speaker_ids is None
                                  else speaker_ids[i]))
            for i, t in enumerate(texts)]
    feats = ap.batch_features(wavs, device=device)
    items = []
    for i, (text, (spec, mel)) in enumerate(zip(texts, feats)):
        seq = np.asarray(frontend_mod.text_to_sequence(text, p=p), np.int32)
        item = {"text": seq, "mel": np.asarray(mel, np.float32),
                "linear": np.asarray(spec, np.float32)}
        if speaker_ids is not None:
            item["speaker_id"] = int(speaker_ids[i])
        items.append(item)
    return items


def make_batches(items, hp, batch_size, seed=0):
    """Length-sorted batches collated with collate() (training/dataset.py):
    numpy dicts, ready for training.trainer.batch_to."""
    from ..training.dataset import collate

    order = np.argsort([len(it["mel"]) for it in items])
    batches = []
    for i in range(0, len(order) - batch_size + 1, batch_size):
        sel = [items[j] for j in order[i:i + batch_size]]
        batches.append(collate(
            sel, hp.outputs_per_step, hp.downsample_step,
            length_bucket_step=hp.length_bucket_step,
            frame_bucket_step=hp.frame_bucket_step,
            max_positions=hp.max_positions))
    return batches
