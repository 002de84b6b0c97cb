# coding: utf-8
"""JSUT (Japanese) preprocessor (reference jsut.py): per-subset
transcript_utf8.txt + wav/, silB/silE label trimming when lab/ exists."""

import os
from os.path import exists, join

from .common import Utterance, process_utterances


def available_subsets(in_dir):
    return sorted(d for d in os.listdir(in_dir)
                  if os.path.isdir(join(in_dir, d))
                  and exists(join(in_dir, d, "transcript_utf8.txt")))


def collect(in_dir, hp):
    utts = []
    for subset in available_subsets(in_dir):
        with open(join(in_dir, subset, "transcript_utf8.txt"),
                  encoding="utf-8") as f:
            for line in f:
                if ":" not in line:
                    continue
                name, text = line.strip().split(":", 1)
                wav_path = join(in_dir, subset, "wav", name + ".wav")
                if not exists(wav_path):
                    continue
                lab_path = wav_path.replace("wav/", "lab/").replace(
                    ".wav", ".lab")
                utts.append(Utterance(wav_path=wav_path, text=text,
                                      lab_path=lab_path, lab_mode="silB",
                                      top_db=30))
    return utts


def build_from_path(in_dir, out_dir, ap, hp, num_workers=4,
                    tqdm=lambda x: x, device="cuda"):
    utts = collect(in_dir, hp)
    for i, u in enumerate(utts):
        u.spec_name = "jsut-spec-%05d.npy" % (i + 1)
        u.mel_name = "jsut-mel-%05d.npy" % (i + 1)
    return process_utterances(utts, out_dir, ap, hp, "jsut",
                              num_workers=num_workers, tqdm=tqdm,
                              device=device)
