# coding: utf-8
"""Dump the hparams (defaults, then a preset, then overrides) to a JSON
preset file, counterpart of the root dump_hparams_to_json.py:

    python -m deepvoice3_pytorch_tpu_torch.cli.dump_hparams_to_json \\
        [--preset=<json>] [--hparams=...] <output_json_path>
"""

import argparse
import json

from . import common


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("output_json_path")
    parser.add_argument("--hparams", type=str, default="")
    parser.add_argument("--preset", type=str, default=None)
    args = parser.parse_args(argv)

    hp = common.load_hparams(args.preset, args.hparams, require_name=False)
    with open(args.output_json_path, "w") as f:
        json.dump(hp.values(), f, indent=2, sort_keys=True)
    print("Wrote %s" % args.output_json_path)


if __name__ == "__main__":
    main()
