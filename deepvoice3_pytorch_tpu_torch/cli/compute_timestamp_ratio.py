# coding: utf-8
"""Compute the decoder-frames / text-tokens ratio of a preprocessed corpus,
used as key_position_rate; counterpart of the root
compute_timestamp_ratio.py:

    python -m deepvoice3_pytorch_tpu_torch.cli.compute_timestamp_ratio \\
        [--preset=<json>] [--hparams=...] <data_root>
"""

import argparse

import numpy as np

from .. import frontend as frontend_pkg
from ..training.dataset import Metadata
from . import common


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("data_root")
    parser.add_argument("--hparams", type=str, default="")
    parser.add_argument("--preset", type=str, default=None)
    args = parser.parse_args(argv)

    hp = common.load_hparams(args.preset, args.hparams)
    fe = frontend_pkg.get_frontend(hp.frontend)
    meta = Metadata(args.data_root)
    in_sizes, out_sizes = [], []
    for text, n_frames in zip(meta.texts, meta.frame_lengths):
        in_sizes.append(len(fe.text_to_sequence(text)))
        out_sizes.append(n_frames // hp.outputs_per_step
                         // hp.downsample_step)
    input_timestamps = np.sum(in_sizes)
    output_timestamps = np.sum(out_sizes)
    ratio = output_timestamps / input_timestamps
    print(input_timestamps, output_timestamps, ratio)
    print("Ratio (i.e., key_position_rate): {}".format(ratio))


if __name__ == "__main__":
    main()
