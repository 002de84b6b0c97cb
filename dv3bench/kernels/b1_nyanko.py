# coding: utf-8
"""Kernel B1 (csrc/fused_decode.cu) decoding a nyanko model: the
operations and bytes of a decode from its shapes (reference/nyanko.py's
configuration). The kernel's device name is kernels/b1.py's."""

import math

from ..reference import nyanko as ref_nyanko
from .b1 import PATTERN, PRECISION  # noqa: F401  (re-exported)


def step_weights(cfg):
    """Weights one row reads each step: the audio encoder, the audio
    decoder (its first layer the LINEAR2 stage over [R | Q]) and last_conv,
    and the done projection as the kernel takes it, folded into last_conv
    as one more output unit (D weights). The attention's query and out
    projections are folded into the keys and values once a decode, and the
    position tables are rows added, not products: none counted."""
    dc = cfg.decoder
    shapes = ref_nyanko.leaf_shapes(cfg)
    n = sum(math.prod(s) for k, s in shapes.items()
            if k.endswith(".v") and k.startswith(
                ("decoder.audio_encoder.", "decoder.audio_decoder.",
                 "decoder.last_conv.")))
    return n + dc.channels


def step_biases(cfg):
    """Biases one row adds each step, the done projection's folded one."""
    shapes = ref_nyanko.leaf_shapes(cfg)
    return sum(math.prod(s) for k, s in shapes.items()
               if k.endswith(".b") and k.startswith(
                   ("decoder.audio_encoder.", "decoder.audio_decoder.",
                    "decoder.last_conv."))) + 1


def keys_scored(cfg, Tk, text_length):
    """Keys one step of one row scores: the monotonic window (back +
    ahead keys, or the text where it is shorter), else the padded text."""
    dc = cfg.decoder
    if dc.force_monotonic_attention:
        return min(dc.window_backward + dc.window_ahead, text_length)
    return Tk


def work(cfg, B, Tk, steps, text_lengths):
    """(operations, bytes) of a decode of `steps` steps at B rows over Tk
    padded keys. Operations: per row and step one multiply-add per weight
    read (`step_weights`), and 2 D per key scored (a score over the key
    and its share of the value). Bytes, each read or written once: the
    weights and biases, the folded keys and values (2 B Tk (D + 1)), the
    mask, the query position rows, and per row and step the frame, the
    alignment, done and the decoder state written."""
    dc = cfg.decoder
    D, F = dc.channels, dc.in_dim * dc.r
    keys = sum(keys_scored(cfg, Tk, int(n)) for n in text_lengths) * steps
    flops = 2.0 * (step_weights(cfg) * B * steps + 2 * D * keys)
    nbytes = 4 * (step_weights(cfg) + step_biases(cfg)
                  + 2 * B * Tk * (D + 1) + B * Tk + steps * D
                  + B * steps * (F + Tk + 1 + D))
    return flops, nbytes
