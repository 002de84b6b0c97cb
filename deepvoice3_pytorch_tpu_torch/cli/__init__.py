# coding: utf-8
"""The port's command lines, counterparts of the root scripts of the same
names (train.py, synthesis.py, serve.py, convert_checkpoint.py,
dump_hparams_to_json.py, compute_timestamp_ratio.py):

    python -m deepvoice3_pytorch_tpu_torch.cli.<name> --help

They run on the card unless `--device cpu` is given, and fail when no card
is present otherwise.
"""
