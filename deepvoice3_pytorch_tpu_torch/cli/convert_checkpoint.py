# coding: utf-8
"""Convert an r9y9/deepvoice3_pytorch checkpoint (.pth) to this repo's
checkpoint format, counterpart of the root convert_checkpoint.py:

    python -m deepvoice3_pytorch_tpu_torch.cli.convert_checkpoint \\
        [--preset=<json>] [--hparams=...] <reference.pth> <output>

The preset must be the one the reference model was trained with: every
tensor is mapped by utils/torch_import.py onto the parameter tree and the
result is checked against the preset's model (keys and shapes). Step and
epoch carry over; the optimizer state is not convertible (resume with
--reset-optimizer). The output loads in both packages.
"""

import argparse

import numpy as np
import torch

from .. import frontend as frontend_pkg
from ..hparams import hparams_debug_string
from ..model_builder import build_config
from ..params import ParamTree, params_from_jax
from ..training import checkpoint as ckpt
from ..utils.torch_import import import_state_dict
from . import common


def convert(pth_path, out_path, cfg):
    """Returns (parameter tree of numpy arrays, step)."""
    blob = torch.load(pth_path, map_location="cpu", weights_only=False)
    sd = blob["state_dict"] if isinstance(blob, dict) and \
        "state_dict" in blob else blob
    sd_np = {}
    for k, v in sd.items():
        if k.startswith("module."):      # DataParallel prefix
            k = k[len("module."):]
        sd_np[k] = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
    tree = import_state_dict(sd_np, cfg)
    params_from_jax(tree, cfg)           # keys and shapes against cfg
    step = int(blob.get("global_step", 0)) if isinstance(blob, dict) else 0
    epoch = int(blob.get("global_epoch", 0)) if isinstance(blob, dict) \
        else 0
    ckpt.save_checkpoint_file(out_path, ParamTree(tree), None, step, epoch)
    return tree, step


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("reference_checkpoint")
    parser.add_argument("output")
    parser.add_argument("--hparams", type=str, default="")
    parser.add_argument("--preset", type=str, default=None)
    args = parser.parse_args(argv)

    hp = common.load_hparams(args.preset, args.hparams, require_name=False)
    print(hparams_debug_string(hp))
    cfg = build_config(hp, frontend_pkg.get_frontend(hp.frontend).n_vocab)
    _, step = convert(args.reference_checkpoint, args.output, cfg)
    print("Converted %s (step %d) -> %s"
          % (args.reference_checkpoint, step, args.output))


if __name__ == "__main__":
    main()
