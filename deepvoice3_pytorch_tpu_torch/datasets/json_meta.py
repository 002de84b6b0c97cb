# coding: utf-8
"""Custom-dataset preprocessor (reference json_meta.py): one json (or csv)
metadata file per speaker, in the carpedm20/multi-speaker-tacotron format:

    path: "aligned text"            — fully aligned
    path: [candidate, recognized]   — partially aligned
    path: [recognized]              — recognition only

`ignore_recognition_level` (hparams): 0 use all, 1 drop unmatched alignment,
2 drop all recognition-only. `process_only_htk_aligned` drops utterances
without a .lab file.
"""

import json
import os
from os.path import dirname, exists, join, splitext, basename

from .common import Utterance, process_utterances


def _load_info(json_path):
    if json_path.endswith("json"):
        with open(json_path, encoding="utf8") as f:
            return json.load(f)
    elif json_path.endswith("csv"):
        info = {}
        with open(json_path) as f:
            for line in f:
                path, text = line.strip().split("|")
                info[path] = text
        return info
    raise ValueError("Unknown metadata format: %s" % json_path)


def collect(in_dir, hp):
    json_paths = [p.replace("'", "").replace('"', "")
                  for p in in_dir.split(",")]
    num_speakers = len(json_paths)
    utts = []

    for speaker_id, json_path in enumerate(json_paths):
        info = _load_info(json_path)
        base_dir = dirname(json_path)

        resolved = {}
        for path, text in info.items():
            if exists(path):
                resolved[path] = text
            elif exists(join(base_dir, path)):
                resolved[join(base_dir, path)] = text

        for path, text in resolved.items():
            aligned = True
            if isinstance(text, list):
                if (hp.ignore_recognition_level == 1 and len(text) == 1) \
                        or hp.ignore_recognition_level == 2:
                    aligned = False
                text = text[-1] if hp.ignore_recognition_level == 0 \
                    else text[0]
            if hp.ignore_recognition_level > 0 and not aligned:
                continue
            if len(text) < hp.min_text:
                continue

            lab_path = path.replace("wav48/", "lab/").replace(".wav", ".lab")
            if not exists(lab_path):
                lab_path = splitext(path)[0] + ".lab"
            if not exists(lab_path) and hp.process_only_htk_aligned:
                continue

            name = splitext(basename(path))[0]
            if num_speakers == 1:
                utts.append(Utterance(
                    wav_path=path, text=text, lab_path=lab_path,
                    lab_mode="pau", top_db=15,
                    spec_name="spec-%s.npy" % name,
                    mel_name="mel-%s.npy" % name))
            else:
                utts.append(Utterance(
                    wav_path=path, text=text, speaker_id=speaker_id,
                    lab_path=lab_path, lab_mode="pau", top_db=15,
                    spec_name="spec-%d-%s.npy" % (speaker_id, name),
                    mel_name="mel-%d-%s.npy" % (speaker_id, name)))
    return utts


def build_from_path(in_dir, out_dir, ap, hp, num_workers=4,
                    tqdm=lambda x: x, device="cuda"):
    return process_utterances(collect(in_dir, hp), out_dir, ap, hp, "json",
                              num_workers=num_workers, tqdm=tqdm,
                              device=device)
