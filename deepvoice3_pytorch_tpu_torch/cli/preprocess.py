# coding: utf-8
"""Preprocess a corpus into training features, counterpart of the root
preprocess.py:

    python -m deepvoice3_pytorch_tpu_torch.cli.preprocess [options] \\
        <name> <in_dir> <out_dir>

<name> is one of datasets.SUPPORTED (ljspeech, vctk, jsut, nikl_m, nikl_s,
json_meta). Writes <out_dir>/*-spec-*.npy and *-mel-*.npy, train.txt and
the DSP stamp dsp_config.json that cli.train checks. Host threads load and
trim the wavs; the features of each batch of 16 are computed on --device
(the card by default), or, with DV3_PREPROCESS_BACKEND=native, by the C++
host library (lws framing; the centred framing warns and takes the device
route). --summary-json writes the utterance count, the audio seconds and
the wall seconds of the feature pass.
"""

import argparse
import json
import os
import time

from .. import datasets
from ..dsp.audio import AudioProcessor
from ..hparams import hparams_debug_string
from ..training.dataset import write_dsp_stamp
from . import common


def write_metadata(metadata, out_dir, hp):
    """train.txt, one `|`-joined tuple a line, and the corpus's totals on
    stdout (the root script's lines)."""
    if not metadata:
        raise SystemExit(
            "No utterances survived preprocessing — check the corpus layout "
            "and filters (e.g. min_text=%d drops short transcripts)."
            % hp.min_text)
    with open(os.path.join(out_dir, 'train.txt'), 'w',
              encoding='utf-8') as f:
        for m in metadata:
            f.write('|'.join([str(x) for x in m]) + '\n')
    frames = sum(m[2] for m in metadata)
    frame_shift_ms = hp.hop_size / hp.sample_rate * 1000
    hours = frames * frame_shift_ms / (3600 * 1000)
    print('Wrote %d utterances, %d frames (%.2f hours)'
          % (len(metadata), frames, hours))
    print('Max input length:  %d' % max(len(m[3]) for m in metadata))
    print('Max output length: %d' % max(m[2] for m in metadata))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.
                                     RawDescriptionHelpFormatter)
    parser.add_argument("name", choices=datasets.SUPPORTED)
    parser.add_argument("in_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--num_workers", type=int, default=os.cpu_count())
    parser.add_argument("--hparams", type=str, default="")
    parser.add_argument("--preset", type=str, default=None)
    parser.add_argument("--summary-json", type=str, default=None)
    common.add_device_argument(parser)
    args = parser.parse_args(argv)

    hp = common.load_hparams(args.preset, args.hparams)
    device = common.pick_device(args.device)
    print(hparams_debug_string(hp))

    try:
        from tqdm import tqdm
    except ImportError:
        tqdm = lambda x: x  # noqa: E731

    ap = AudioProcessor(hp)
    mod = datasets.get_preprocessor(args.name)
    os.makedirs(args.out_dir, exist_ok=True)
    t = time.perf_counter()
    metadata = mod.build_from_path(args.in_dir, args.out_dir, ap, hp,
                                   num_workers=args.num_workers, tqdm=tqdm,
                                   device=device)
    wall_s = time.perf_counter() - t
    write_metadata(metadata, args.out_dir, hp)
    # the DSP conventions, so that training refuses a corpus whose framing
    # or normalization no longer matches its hparams
    write_dsp_stamp(args.out_dir, hp)
    if args.summary_json:
        audio_s = sum(m[2] for m in metadata) * hp.hop_size / hp.sample_rate
        with open(args.summary_json, "w") as f:
            json.dump({"device": str(device), "utterances": len(metadata),
                       "audio_s": audio_s, "wall_s": wall_s,
                       "backend": os.environ.get("DV3_PREPROCESS_BACKEND",
                                                 "device")}, f, indent=1)


if __name__ == "__main__":
    main()
