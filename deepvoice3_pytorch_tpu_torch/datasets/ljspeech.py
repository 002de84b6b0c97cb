# coding: utf-8
"""LJSpeech preprocessor (reference ljspeech.py): metadata.csv ->
batched on-device features + train.txt tuples."""

import os
from os.path import join

from .common import Utterance, process_utterances


def collect(in_dir, hp):
    utts = []
    index = 1
    with open(join(in_dir, "metadata.csv"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            text = parts[2] if len(parts) > 2 else parts[-1]
            if len(text) < hp.min_text:
                continue
            utts.append(Utterance(
                wav_path=join(in_dir, "wavs", "%s.wav" % parts[0]),
                text=text,
                spec_name="ljspeech-spec-%05d.npy" % index,
                mel_name="ljspeech-mel-%05d.npy" % index))
            index += 1
    return utts


def build_from_path(in_dir, out_dir, ap, hp, num_workers=4,
                    tqdm=lambda x: x, device="cuda"):
    utts = collect(in_dir, hp)
    return process_utterances(utts, out_dir, ap, hp, "ljspeech",
                              num_workers=num_workers, tqdm=tqdm,
                              device=device)
