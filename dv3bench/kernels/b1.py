# coding: utf-8
"""Kernel B1, the decode (csrc/fused_decode.cu): its device name, and the
operations and bytes of a decode from its shapes."""

import math
import re

from ..counts import leaf_shapes

PATTERN = re.compile(r"\bfused_decode_kernel\b")
PRECISION = "float32"




def decode_weight_macs(cfg):
    """Multiply-adds per row and step: every decoder weight the step reads
    (the attention's query and out projections, last_conv and the done
    projection included; positional tables, key / value and speaker
    projections run before the decode)."""
    return sum(math.prod(s) for k, s in leaf_shapes(cfg).items()
               if k.startswith("decoder.") and k.endswith(".v")
               and "positions" not in k and "key_proj" not in k
               and "value_proj" not in k and "speaker_proj" not in k)


def keys_scored(cfg, Tk, text_lengths):
    """Keys one step of one row scores, summed over the attention layers:
    a monotonic layer's window (window_backward + window_ahead keys, or
    the text where it is shorter), else every key of the padded text."""
    dc = cfg.decoder
    n = 0
    for idx, s in enumerate(dc.attention_specs):
        if s is None:
            continue
        if dc.force_monotonic_attention[idx]:
            n += min(s.window_backward + s.window_ahead, text_lengths)
        else:
            n += Tk
    return n


def work(cfg, B, Tk, steps, text_lengths):
    """(operations, bytes) of a decode of `steps` steps at B rows over Tk
    padded keys: per row and step one MAC per decoder weight and 2 E per
    key scored; bytes: the weights, K/V, mask, speaker biases and position
    rows read once, the frame, alignment, done and state written once."""
    dc = cfg.decoder
    shapes = leaf_shapes(cfg)
    E, C = dc.embed_dim, dc.convolutions[0][0]
    n_att = dc.num_attention_layers
    keys = sum(keys_scored(cfg, Tk, int(n)) for n in text_lengths) * steps
    flops = 2.0 * (decode_weight_macs(cfg) * B * steps + 2 * E * keys)
    weights = sum(math.prod(s) for k, s in shapes.items()
                  if k.startswith("decoder.") and "positions" not in k
                  and "key_proj" not in k and "value_proj" not in k
                  and "speaker_proj" not in k)
    n_sp = sum(s.out_channels for s in dc.prenet_specs + dc.conv_specs
               if s.kind == "glu" and s.speaker_proj) \
        if cfg.n_speakers > 1 else 0
    nbytes = 4 * (weights + n_att * 2 * B * Tk * E + B * Tk + B * n_sp
                  + steps * C + B * steps * (dc.in_dim * dc.r + Tk + 1 + C))
    return flops, nbytes
