# coding: utf-8
"""Corpus adapters, counterpart of deepvoice3_pytorch_tpu/datasets/: each
module's `build_from_path(in_dir, out_dir, ap, hp, ...)` writes the
features and returns the train.txt tuples."""
from . import ljspeech, vctk, jsut, nikl_s, nikl_m, json_meta, common  # noqa: F401

SUPPORTED = ["ljspeech", "vctk", "jsut", "nikl_m", "nikl_s", "json_meta"]


def get_preprocessor(name):
    if name not in SUPPORTED:
        raise ValueError("Unknown dataset %r (supported: %s)"
                         % (name, SUPPORTED))
    return globals()[name]
