# coding: utf-8
"""NIKL multi-speaker preprocessor (reference nikl_m.py): metadata.txt with
speaker ids assigned from speaker.mid order, speaker uid parsed from the wav
path ([a-z][a-z][0-9][0-9]_t pattern)."""

import re
from os.path import join

from .common import Utterance, process_utterances

_UID_RE = re.compile(r"([a-z][a-z][0-9][0-9]_t)")


def collect(in_dir, hp):
    spk_id = {}
    with open(join(in_dir, "speaker.mid"), encoding="utf-8") as f:
        for i, line in enumerate(f):
            spk_id[line.rstrip()] = i

    utts = []
    index = 1
    with open(join(in_dir, "metadata.txt"), encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            wav_path, text = parts[0], parts[1]
            m = _UID_RE.search(wav_path)
            uid = m.group(1).replace("_t", "")
            utts.append(Utterance(
                wav_path=wav_path, text=text, speaker_id=spk_id[uid],
                spec_name="nikl-multi-spec-%05d.npy" % index,
                mel_name="nikl-multi-mel-%05d.npy" % index))
            index += 1
    return utts


def build_from_path(in_dir, out_dir, ap, hp, num_workers=4,
                    tqdm=lambda x: x, device="cuda"):
    return process_utterances(collect(in_dir, hp), out_dir, ap, hp,
                              "nikl-multi", num_workers=num_workers,
                              tqdm=tqdm, device=device)
