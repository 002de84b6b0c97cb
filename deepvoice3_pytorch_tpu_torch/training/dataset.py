# coding: utf-8
"""Training data pipeline, counterpart of
deepvoice3_pytorch_tpu/training/dataset.py.

Reads the preprocess.py output contract: `train.txt` pipe-delimited metadata
plus `*-spec-*.npy` (T, 513) / `*-mel-*.npy` (T, 80) pairs. Batches come from
the partially-randomized similar-length sampler and are collated with the
reference's padding semantics (r / downsample rounding, b_pad initial frames,
1-based positions, done flags), padded up to bucket shapes
(length_bucket_step / frame_bucket_step). `DataLoader` collates in a
background thread, through the port's C++ loader (`collate_native`,
native/src/dv3_loader.cc) unless asked for numpy;
`training.trainer.batch_to` moves a collated batch onto the device.
`dsp_config.json`, the DSP stamp, records the audio conventions a corpus
was preprocessed under, and training refuses a corpus whose stamp differs
from the active hparams.
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

    frame_positions, done = _decoder_fields(target_lengths, max_target_len,
                                            r, downsample_step, B)

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


def _decoder_fields(target_lengths, max_target_len, r, downsample_step, B):
    max_decoder_len = max_target_len // r // downsample_step
    frame_positions = np.tile(np.arange(1, max_decoder_len + 1),
                              (B, 1)).astype(np.int32)
    done = np.ones((B, max_decoder_len, 1), np.float32)
    for i, t in enumerate(target_lengths):
        done[i, :t // r // downsample_step - 1] = 0.0
    return frame_positions, done


def collate_native(dataset, idxs, r, downsample_step, *,
                   length_bucket_step=1, frame_bucket_step=1,
                   max_positions=None, n_threads=0):
    """`collate` of dataset[idxs] with the .npy reads and the padded copies
    on the port's C++ loader (native/src/dv3_loader.cc, a thread per file up
    to n_threads, 0: the hardware's): the same arrays as `collate`. Returns
    None when a file is not one the C++ reader takes (float32, C order, 1-D
    or 2-D): the caller collates those with numpy. The library is built on
    first use; a failed build raises."""
    from .. import native

    meta = dataset.meta
    texts = [np.asarray(
        dataset.frontend.text_to_sequence(meta.texts[i], p=dataset.p),
        np.int32) for i in idxs]
    target_lengths = [meta.frame_lengths[i] for i in idxs]

    max_input_len = _round_up(max(len(t) for t in texts), length_bucket_step)
    max_target_len = _round_up(_round_up(max(target_lengths), r),
                               downsample_step)
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

    mel_paths = [join(dataset.data_root, meta.mel_files[i]) for i in idxs]
    lin_paths = [join(dataset.data_root, meta.spec_files[i]) for i in idxs]
    probe = native.npy_shape(mel_paths[0])
    probe_l = native.npy_shape(lin_paths[0])
    if probe is None or probe_l is None:
        return None
    offset = b_pad * downsample_step
    mel, mrows = native.load_padded_batch(mel_paths, max_target_len,
                                          probe[1], row_offset=offset,
                                          n_threads=n_threads)
    y, lrows = native.load_padded_batch(lin_paths, max_target_len,
                                        probe_l[1], row_offset=offset,
                                        n_threads=n_threads)
    if (mrows < 0).any() or (lrows < 0).any():
        return None

    B = len(idxs)
    x = np.zeros((B, max_input_len), np.int32)
    text_positions = np.zeros((B, max_input_len), np.int32)
    input_lengths = np.zeros((B,), np.int32)
    for i, t in enumerate(texts):
        x[i, :len(t)] = t
        text_positions[i, :len(t)] = np.arange(1, len(t) + 1)
        input_lengths[i] = len(t)
    frame_positions, done = _decoder_fields(target_lengths, max_target_len,
                                            r, downsample_step, B)
    batch = {
        "x": x,
        "input_lengths": input_lengths,
        "mel": np.ascontiguousarray(mel[:, ::downsample_step, :]),
        "y": y,
        "text_positions": text_positions,
        "frame_positions": frame_positions,
        "done": done,
        "target_lengths": np.asarray(target_lengths, np.int32),
    }
    if dataset.multi_speaker:
        batch["speaker_ids"] = np.asarray(
            [meta.speaker_ids[i] for i in idxs], np.int32)
    return batch


class DataLoader:
    """Background-thread prefetching batch iterator. use_native (default):
    batches through `collate_native` (a batch it cannot read, numpy's
    `collate`); num_workers: the C++ loader's read threads (0: one per
    file up to the hardware's threads; not hparams.num_workers, which
    counts the reference's worker processes). `batches` counts the batches
    each route made."""

    def __init__(self, dataset, sampler, r, downsample_step, *,
                 length_bucket_step=1, frame_bucket_step=1,
                 max_positions=None, prefetch=2, use_native=True,
                 num_workers=0):
        self.dataset = dataset
        self.sampler = sampler
        self.r = r
        self.downsample_step = downsample_step
        self.length_bucket_step = length_bucket_step
        self.frame_bucket_step = frame_bucket_step
        self.max_positions = max_positions
        self.prefetch = prefetch
        self.use_native = use_native
        self.num_workers = num_workers
        self.batches = {"native": 0, "numpy": 0}

    def _make_batch(self, idxs):
        kw = dict(length_bucket_step=self.length_bucket_step,
                  frame_bucket_step=self.frame_bucket_step,
                  max_positions=self.max_positions)
        if self.use_native and hasattr(self.dataset, "meta"):
            batch = collate_native(self.dataset, idxs, self.r,
                                   self.downsample_step,
                                   n_threads=self.num_workers, **kw)
            if batch is not None:
                self.batches["native"] += 1
                return batch
        self.batches["numpy"] += 1
        return collate([self.dataset[i] for i in idxs], self.r,
                       self.downsample_step, **kw)

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
