# coding: utf-8
"""Operations and bytes of the work a cell's traffic asks for, from shapes
alone: whatever implements the work, the same work counts the same. A
multiply-add is two operations; each input byte is read once and each
output byte written once."""

import math

from .reference import params as ref_params


def leaf_shapes(cfg):
    """{dotted name: shape} of the configuration's parameter tree."""
    draw = ref_params._Draw("meta")
    return {k: tuple(v.shape) for k, v in
            ref_params.flatten(ref_params._tree(cfg, draw)).items()}


def n_params(cfg, trained=None):
    return sum(math.prod(s) for k, s in leaf_shapes(cfg).items()
               if trained is None or trained(k))


def spec_flops(spec, B, T, multispeaker, speaker_dim):
    """(operations, T after the layer) of one conv-block layer at B rows of
    T frames: its conv as a product of (B T, kw in) by (kw in, out), and
    a GLU layer's speaker projection."""
    if spec.kind == "convT":
        return 2 * B * T * spec.in_channels * spec.out_channels \
            * spec.kernel_size, T * spec.stride
    n_out = spec.out_channels * (2 if spec.kind in ("glu", "highway")
                                 else 1)
    f = 2 * B * T * spec.kernel_size * spec.in_channels * n_out
    if spec.speaker_proj and multispeaker:
        f += 2 * B * T * speaker_dim * spec.out_channels
    return f, T


def stack_flops(specs, B, T, cfg):
    total = 0
    for s in specs:
        f, T = spec_flops(s, B, T, cfg.n_speakers > 1, cfg.speaker_embed_dim)
        total += f
    return total, T


def encoder_flops(cfg, B, Tk):
    ec = cfg.encoder
    f, _ = stack_flops(ec.specs, B, Tk, cfg)
    if cfg.n_speakers > 1:      # speaker_fc1 and speaker_fc2
        f += 2 * 2 * B * Tk * cfg.speaker_embed_dim * ec.embed_dim
    return f


def key_value_flops(cfg, B, Tk):
    """The attention layers' key and value projections, once a text."""
    dc = cfg.decoder
    E = dc.embed_dim
    n = sum(int(s.key_projection) + int(s.value_projection)
            for s in dc.attention_specs if s is not None)
    return 2 * B * Tk * E * E * n


def decoder_flops(cfg, B, Tq, Tk):
    """The teacher-forced decoder over Tq query frames and Tk keys (the
    key and value projections apart): stacks, every key scored."""
    dc = cfg.decoder
    f, _ = stack_flops(dc.prenet_specs, B, Tq, cfg)
    g, _ = stack_flops(dc.conv_specs, B, Tq, cfg)
    f += g
    C, E = dc.convolutions[0][0], dc.embed_dim
    for s in dc.attention_specs:
        if s is not None:
            f += 2 * B * Tq * C * E * 2 + 2 * 2 * B * Tq * Tk * E
    f += 2 * B * Tq * C * dc.in_dim * dc.r + 2 * B * Tq * dc.in_dim * dc.r
    if cfg.n_speakers > 1:      # speaker_proj1 and speaker_proj2
        f += 2 * 2 * B * cfg.speaker_embed_dim
    return f


def converter_flops(cfg, B, T_dec):
    f, _ = stack_flops(cfg.converter.specs, B, T_dec * cfg.r, cfg)
    return f


def forward_flops(cfg, B, Tk, T_dec):
    """The whole teacher-forced forward at B rows, Tk text positions and
    T_dec decoder frames."""
    return (encoder_flops(cfg, B, Tk) + key_value_flops(cfg, B, Tk)
            + decoder_flops(cfg, B, T_dec, Tk) + converter_flops(cfg, B, T_dec))


ADAM_FLOPS_PER_PARAM = 16   # moments 5, the bias-corrected update 7, clip 4


def train_step_flops(cfg, B, Tk, T_dec, trained):
    """Forward, backward (twice the forward's products) and Adam."""
    return 3 * forward_flops(cfg, B, Tk, T_dec) \
        + ADAM_FLOPS_PER_PARAM * n_params(cfg, trained)


def synthesis_flops(cfg, hp, B, Tk, steps, text_lengths):
    """{precision: operations} of one tts_batch call that decodes `steps`
    steps: encoder, key/value projections and converter in f32, the decode
    (B1) in f32, Griffin-Lim (B2) in bf16."""
    from .kernels import b1, b2
    n_lin = steps * cfg.r * cfg.converter.time_upsampling
    f32 = (encoder_flops(cfg, B, Tk) + key_value_flops(cfg, B, Tk)
           + converter_flops(cfg, B, steps)
           + b1.work(cfg, B, Tk, steps, text_lengths)[0])
    return {"float32": f32, "bfloat16": b2.work(hp, B, n_lin)[0]}

