# coding: utf-8
"""VCTK preprocessor (reference vctk.py): wav48/<speaker>/*.wav +
txt/<speaker>/*.txt, HTK-label silence trimming when lab/ files exist,
speaker ids by position in the sorted speaker list."""

import os
from os.path import exists, join, splitext

from .common import Utterance, process_utterances


def available_speakers(in_dir):
    wav_root = join(in_dir, "wav48")
    return sorted(d for d in os.listdir(wav_root)
                  if os.path.isdir(join(wav_root, d)))


def collect(in_dir, hp):
    utts = []
    for sid, speaker in enumerate(available_speakers(in_dir)):
        wav_dir = join(in_dir, "wav48", speaker)
        txt_dir = join(in_dir, "txt", speaker)
        for wav_name in sorted(os.listdir(wav_dir)):
            if not wav_name.endswith(".wav"):
                continue
            txt_path = join(txt_dir, splitext(wav_name)[0] + ".txt")
            if not exists(txt_path):
                continue
            with open(txt_path, encoding="utf-8") as f:
                text = f.read().strip()
            wav_path = join(wav_dir, wav_name)
            lab_path = wav_path.replace("wav48/", "lab/").replace(
                ".wav", ".lab")
            utts.append(Utterance(
                wav_path=wav_path, text=text, speaker_id=sid,
                lab_path=lab_path, lab_mode="pau", top_db=15))
    return utts


def build_from_path(in_dir, out_dir, ap, hp, num_workers=4,
                    tqdm=lambda x: x, device="cuda"):
    utts = collect(in_dir, hp)
    for i, u in enumerate(utts):
        u.spec_name = "vctk-spec-%05d.npy" % (i + 1)
        u.mel_name = "vctk-mel-%05d.npy" % (i + 1)
    return process_utterances(utts, out_dir, ap, hp, "vctk",
                              num_workers=num_workers, tqdm=tqdm,
                              device=device)
