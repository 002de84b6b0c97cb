# coding: utf-8
"""Training data pipeline, counterpart of
deepvoice3_pytorch_tpu/training/dataset.py (numpy only).

Reads the preprocess.py output contract: `train.txt` pipe-delimited metadata
plus `*-spec-*.npy` (T, 513) / `*-mel-*.npy` (T, 80) pairs. Batches come from
the partially-randomized similar-length sampler and are collated with the
reference's padding semantics (r / downsample rounding, b_pad initial frames,
1-based positions, done flags), padded up to bucket shapes
(length_bucket_step / frame_bucket_step). `DataLoader` collates in a
background thread; `training.trainer.batch_to` moves a collated batch onto
the device. `dsp_config.json`, the DSP stamp, records the audio conventions a
corpus was preprocessed under, and training refuses a corpus whose stamp
differs from the active hparams.
"""

import json
import os
import queue as queue_mod
import random
import threading
import warnings
from os.path import join

import numpy as np

DSP_STAMP_KEYS = ("stft_mode", "fft_size", "hop_size", "sample_rate",
                  "num_mels", "fmin", "fmax", "preemphasis", "min_level_db",
                  "ref_level_db", "rescaling", "rescaling_max",
                  "allow_clipping_in_normalization")


def dsp_stamp(hp):
    """The audio-convention fingerprint of a preprocessing run."""
    return {k: getattr(hp, k) for k in DSP_STAMP_KEYS}


def write_dsp_stamp(data_root, hp):
    with open(join(data_root, "dsp_config.json"), "w") as f:
        json.dump(dsp_stamp(hp), f, indent=2, sort_keys=True)


def check_dsp_stamp(data_root, hp):
    """Refuse (SystemExit) a corpus preprocessed under other DSP
    conventions than the active hparams: a changed framing or
    normalization shifts frame counts and feature scale and trains quietly
    wrong. A corpus without dsp_config.json passes with a warning."""
    path = join(data_root, "dsp_config.json")
    if not os.path.exists(path):
        warnings.warn(
            "%s has no dsp_config.json stamp (preprocessed by an older "
            "build); cannot verify the STFT conventions match" % data_root)
        return
    with open(path) as f:
        stamped = json.load(f)
    active = dsp_stamp(hp)
    bad = {k: (stamped.get(k), active[k]) for k in DSP_STAMP_KEYS
           if k in stamped and stamped[k] != active[k]}
    if bad:
        raise SystemExit(
            "DSP convention mismatch between the preprocessed corpus and "
            "the active hparams (re-run preprocess.py or fix the preset): "
            + ", ".join("%s: corpus=%r active=%r" % (k, v[0], v[1])
                        for k, v in sorted(bad.items())))


class Metadata:
    """Parsed train.txt (reference preprocess.py:28-30 format)."""

    def __init__(self, data_root, speaker_id=None):
        self.data_root = data_root
        with open(join(data_root, "train.txt"), encoding="utf-8") as f:
            lines = [l.strip() for l in f if l.strip()]
        cols = [l.split("|") for l in lines]
        ncol = len(cols[0])
        assert ncol in (4, 5), "train.txt must have 4 or 5 columns"
        self.multi_speaker = ncol == 5
        self.spec_files = [c[0] for c in cols]
        self.mel_files = [c[1] for c in cols]
        self.frame_lengths = [int(c[2]) for c in cols]
        self.texts = [c[3] for c in cols]
        self.speaker_ids = [int(c[4]) for c in cols] if self.multi_speaker \
            else None

        if speaker_id is not None and self.multi_speaker:
            idx = [i for i, s in enumerate(self.speaker_ids)
                   if s == int(speaker_id)]
            self.spec_files = [self.spec_files[i] for i in idx]
            self.mel_files = [self.mel_files[i] for i in idx]
            self.frame_lengths = [self.frame_lengths[i] for i in idx]
            self.texts = [self.texts[i] for i in idx]
            self.speaker_ids = None
            self.multi_speaker = False

    def __len__(self):
        return len(self.texts)


class TTSDataset:
    """text (+speaker) / mel / linear triples by index."""

    def __init__(self, data_root, frontend_mod, replace_pronunciation_prob=0.5,
                 speaker_id=None):
        self.meta = Metadata(data_root, speaker_id)
        self.frontend = frontend_mod
        self.p = replace_pronunciation_prob
        self.data_root = data_root

    @property
    def multi_speaker(self):
        return self.meta.multi_speaker

    def __len__(self):
        return len(self.meta)

    def __getitem__(self, idx):
        seq = np.asarray(
            self.frontend.text_to_sequence(self.meta.texts[idx], p=self.p),
            dtype=np.int32)
        mel = np.load(join(self.data_root, self.meta.mel_files[idx]))
        linear = np.load(join(self.data_root, self.meta.spec_files[idx]))
        item = {"text": seq, "mel": mel, "linear": linear}
        if self.multi_speaker:
            item["speaker_id"] = self.meta.speaker_ids[idx]
        return item


class SimilarTimeLengthSampler:
    """Partially-randomized similar-length batching (reference
    train.py:195-239): sort by length, shuffle within groups of
    batch_size*32, permute whole batches."""

    def __init__(self, lengths, batch_size=16, batch_group_size=None,
                 permutate=True, seed=1234, drop_last=True):
        self.lengths = np.asarray(lengths)
        self.sorted_indices = np.argsort(self.lengths, kind="stable")
        self.batch_size = batch_size
        if batch_group_size is None:
            batch_group_size = min(batch_size * 32, len(self.lengths))
            batch_group_size -= batch_group_size % batch_size
        self.batch_group_size = max(batch_group_size, batch_size)
        self.permutate = permutate
        self.rng = random.Random(seed)
        self.drop_last = drop_last

    def __iter__(self):
        indices = self.sorted_indices.copy()
        bgs = self.batch_group_size
        e = 0
        for i in range(len(indices) // bgs):
            s, e = i * bgs, (i + 1) * bgs
            chunk = list(indices[s:e])
            self.rng.shuffle(chunk)
            indices[s:e] = chunk
        if self.permutate and e > 0:
            nb = e // self.batch_size
            perm = list(range(nb))
            self.rng.shuffle(perm)
            indices[:nb * self.batch_size] = (
                indices[:nb * self.batch_size]
                .reshape(nb, self.batch_size)[perm].reshape(-1))
        if e < len(indices):
            tail = list(indices[e:])
            self.rng.shuffle(tail)
            indices[e:] = tail

        n = len(indices)
        if self.drop_last:
            n -= n % self.batch_size
        for s in range(0, n, self.batch_size):
            yield list(indices[s:s + self.batch_size])


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def collate(items, r, downsample_step, *, length_bucket_step=1,
            frame_bucket_step=1, max_positions=None):
    """Reference collate_fn semantics (train.py:293-360) + bucket rounding.

    Returns a dict of numpy arrays; 'mel' is ALREADY time-downsampled (the
    reference downsamples inside the train loop, train.py:639-640).
    """
    max_input_len = max(len(it["text"]) for it in items)
    max_input_len = _round_up(max_input_len, length_bucket_step)

    target_lengths = [len(it["mel"]) for it in items]
    max_target_len = max(target_lengths)
    max_target_len = _round_up(max_target_len, r)
    max_target_len = _round_up(max_target_len, downsample_step)
    b_pad = r
    max_target_len += b_pad * downsample_step
    max_target_len = _round_up(max_target_len,
                               frame_bucket_step * downsample_step * r)
    if max_positions is not None:
        dec_len = max_target_len // r // downsample_step
        if max_input_len >= max_positions or dec_len >= max_positions:
            raise RuntimeError(
                "max_seq_len (%d) >= max_positions (%d); raise max_positions"
                % (max(max_input_len, dec_len), max_positions))

    B = len(items)
    x = np.zeros((B, max_input_len), np.int32)
    text_positions = np.zeros((B, max_input_len), np.int32)
    input_lengths = np.zeros((B,), np.int32)
    mel_dim = items[0]["mel"].shape[1]
    lin_dim = items[0]["linear"].shape[1]
    mel = np.zeros((B, max_target_len, mel_dim), np.float32)
    y = np.zeros((B, max_target_len, lin_dim), np.float32)

    for i, it in enumerate(items):
        n = len(it["text"])
        x[i, :n] = it["text"]
        text_positions[i, :n] = np.arange(1, n + 1)
        input_lengths[i] = n
        t = len(it["mel"])
        mel[i, b_pad * downsample_step:b_pad * downsample_step + t] = it["mel"]
        y[i, b_pad * downsample_step:b_pad * downsample_step + t] = \
            it["linear"]

    # downsample mel here (train loop does it in the reference)
    mel = mel[:, ::downsample_step, :]

    max_decoder_len = max_target_len // r // downsample_step
    frame_positions = np.tile(np.arange(1, max_decoder_len + 1),
                              (B, 1)).astype(np.int32)

    done = np.ones((B, max_decoder_len, 1), np.float32)
    for i, t in enumerate(target_lengths):
        done[i, :t // r // downsample_step - 1] = 0.0

    batch = {
        "x": x,
        "input_lengths": input_lengths,
        "mel": mel,
        "y": y,
        "text_positions": text_positions,
        "frame_positions": frame_positions,
        "done": done,
        "target_lengths": np.asarray(target_lengths, np.int32),
    }
    if "speaker_id" in items[0]:
        batch["speaker_ids"] = np.asarray(
            [it["speaker_id"] for it in items], np.int32)
    return batch


class DataLoader:
    """Background-thread prefetching batch iterator over `collate` (numpy;
    the JAX package's C++ loader is not ported)."""

    def __init__(self, dataset, sampler, r, downsample_step, *,
                 length_bucket_step=1, frame_bucket_step=1,
                 max_positions=None, prefetch=2):
        self.dataset = dataset
        self.sampler = sampler
        self.r = r
        self.downsample_step = downsample_step
        self.length_bucket_step = length_bucket_step
        self.frame_bucket_step = frame_bucket_step
        self.max_positions = max_positions
        self.prefetch = prefetch

    def _make_batch(self, idxs):
        return collate([self.dataset[i] for i in idxs], self.r,
                       self.downsample_step,
                       length_bucket_step=self.length_bucket_step,
                       frame_bucket_step=self.frame_bucket_step,
                       max_positions=self.max_positions)

    def __iter__(self):
        q = queue_mod.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []

        def producer():
            try:
                for idxs in self.sampler:
                    q.put(self._make_batch(idxs))
            except Exception as e:   # re-raised in the consumer
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        if error:
            raise error[0]

    def __len__(self):
        return len(self.dataset) // self.sampler.batch_size
