# coding: utf-8
"""Operations of nyanko's synthesis from shapes alone (reference/nyanko.py's
configuration), as counts.py counts DeepVoice3's: a multiply-add is two
operations; each layer by `counts.spec_flops`."""

from . import counts
from .kernels import b1_nyanko, b2


def encoder_flops(cfg, B, Tk):
    """The text encoder's stack at B rows of Tk characters (the embedding
    is a gather)."""
    return counts.stack_flops(cfg.encoder.specs, B, Tk, cfg)[0]


def converter_flops(cfg, B, steps):
    """The converter over `steps` decoder states, both transposed convs
    (each doubles the frames after it) included."""
    return counts.stack_flops(cfg.converter.specs, B, steps * cfg.r, cfg)[0]


def synthesis_flops(cfg, hp, B, Tk, steps, text_lengths):
    """{precision: operations} of one tts_batch call that decodes `steps`
    steps: the encoder, the converter and the decode (B1) in f32,
    Griffin-Lim (B2) in bf16. Nyanko has no key or value projection."""
    n_lin = steps * cfg.r * cfg.converter.time_upsampling
    f32 = (encoder_flops(cfg, B, Tk) + converter_flops(cfg, B, steps)
           + b1_nyanko.work(cfg, B, Tk, steps, text_lengths)[0])
    return {"float32": f32, "bfloat16": b2.work(hp, B, n_lin)[0]}
