# coding: utf-8
"""NIKL single-speaker preprocessor (reference nikl_s.py): metadata.txt
filtered by the speaker id in speaker.sid."""

from os.path import join

from .common import Utterance, process_utterances


def collect(in_dir, hp):
    with open(join(in_dir, "speaker.sid"), encoding="utf-8") as f:
        spk_id = f.readline().rstrip()
    utts = []
    index = 1
    with open(join(in_dir, "metadata.txt"), encoding="utf-8") as f:
        for line in f:
            if spk_id in line:
                parts = line.strip().split("|")
                utts.append(Utterance(
                    wav_path=parts[0], text=parts[1],
                    spec_name="nikl-single-spec-%05d.npy" % index,
                    mel_name="nikl-single-mel-%05d.npy" % index))
                index += 1
    return utts


def build_from_path(in_dir, out_dir, ap, hp, num_workers=4,
                    tqdm=lambda x: x, device="cuda"):
    return process_utterances(collect(in_dir, hp), out_dir, ap, hp,
                              "nikl-single", num_workers=num_workers,
                              tqdm=tqdm, device=device)
