# coding: utf-8
"""DeepVoice3 encoder / decoder / converter in plain PyTorch: a frozen copy
of the port's (deepvoice3_pytorch_tpu_torch/models/deepvoice3.py) without
its decode through kernel B1 or sequence parallelism.

Configs are frozen dataclasses; parameters are nested dicts with the JAX
package's key paths. The full-sequence applies take `training` and a
`generator` for dropout, drawn in the port's order. A multi-speaker model
(n_speakers > 1) takes a (B, D) speaker embedding: softsign biases in the
encoder and in every GLU layer, per-sample key and query position rates in
the decoder.
"""

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import attention as attn_ops
from . import conv_blocks as cb
from . import core
from .positional import position_encoding_init, sinusoidal_encoding

SQRT_HALF = math.sqrt(0.5)


def expand_speaker_embed(speaker_embed, T):
    """(B, D) -> (B, T, D)."""
    if speaker_embed is None:
        return None
    return speaker_embed[:, None, :].expand(-1, T, -1)


class _GradMultiply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def grad_multiply(x, scale):
    """Identity forward; the gradient is multiplied by `scale`."""
    return _GradMultiply.apply(x, scale)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_conv_specs(embed_dim, convolutions, dropout, multispeaker):
    specs = []
    in_channels = embed_dim
    std_mul = 1.0
    for (out_channels, kernel_size, dilation) in convolutions:
        if in_channels != out_channels:
            specs.append(cb.conv1x1_spec(in_channels, out_channels, std_mul,
                                         activation="relu"))
            in_channels = out_channels
            std_mul = 2.0
        specs.append(cb.glu_spec(in_channels, out_channels, kernel_size,
                                 dilation, False, True, std_mul, dropout,
                                 multispeaker=multispeaker))
        in_channels = out_channels
        std_mul = 4.0
    specs.append(cb.conv1x1_spec(in_channels, embed_dim, std_mul,
                                 init_dropout=dropout))
    return tuple(specs)


@dataclass(frozen=True)
class EncoderConfig:
    n_vocab: int
    embed_dim: int
    n_speakers: int = 1
    speaker_embed_dim: int = 16
    padding_idx: Optional[int] = 0
    embedding_weight_std: float = 0.1
    convolutions: Tuple = ((64, 5, 1),) * 7
    dropout: float = 0.1
    apply_grad_scaling: bool = False
    num_attention_layers: int = 1

    @property
    def specs(self):
        return encoder_conv_specs(self.embed_dim, self.convolutions,
                                  self.dropout, self.n_speakers > 1)


def encoder_init(generator, cfg: EncoderConfig):
    params = {
        "embed_tokens": core.embedding_init(
            generator, cfg.n_vocab, cfg.embed_dim, cfg.padding_idx,
            cfg.embedding_weight_std),
        "layers": cb.stack_init(generator, cfg.specs, cfg.speaker_embed_dim),
    }
    if cfg.n_speakers > 1:
        for name in ("speaker_fc1", "speaker_fc2"):
            params[name] = core.linear_init(
                generator, cfg.speaker_embed_dim, cfg.embed_dim,
                dropout=cfg.dropout)
    return params


def encoder_apply(params, cfg: EncoderConfig, text_sequences, *,
                  speaker_embed=None, training=False, generator=None):
    """(B, T) int tokens -> (keys, values), each (B, T, embed_dim).
    speaker_embed: (B, D) for a multi-speaker model, else None."""
    x = core.embedding_apply(params["embed_tokens"], text_sequences)
    x = core.dropout(generator, x, cfg.dropout, training)
    se = expand_speaker_embed(speaker_embed, x.shape[1])
    if se is not None:
        se = core.dropout(generator, se, cfg.dropout, training)
        x = x + core.softsign(core.linear_apply(params["speaker_fc1"], se))
    keys = cb.stack_apply(params["layers"], cfg.specs, x,
                          speaker_embed_btc=se, training=training,
                          generator=generator)
    if se is not None:
        keys = keys + core.softsign(
            core.linear_apply(params["speaker_fc2"], se))
    if cfg.apply_grad_scaling and cfg.num_attention_layers:
        keys = grad_multiply(keys, 1.0 / (2.0 * cfg.num_attention_layers))
    return keys, (keys + x) * SQRT_HALF


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def decoder_prenet_specs(in_dim, r, preattention, dropout, multispeaker):
    specs = []
    in_channels = in_dim * r
    std_mul = 1.0
    for (out_channels, kernel_size, dilation) in preattention:
        if in_channels != out_channels:
            specs.append(cb.conv1x1_spec(in_channels, out_channels, std_mul,
                                         activation="relu"))
            in_channels = out_channels
            std_mul = 2.0
        specs.append(cb.glu_spec(in_channels, out_channels, kernel_size,
                                 dilation, True, True, std_mul, dropout,
                                 multispeaker=multispeaker))
        in_channels = out_channels
        std_mul = 4.0
    return tuple(specs)


def decoder_conv_specs(convolutions, dropout, multispeaker):
    """Main causal stack; the residual is applied outside, after attention."""
    return tuple(cb.glu_spec(out_channels, out_channels, kernel_size,
                             dilation, True, False, 4.0, dropout,
                             multispeaker=multispeaker)
                 for (out_channels, kernel_size, dilation) in convolutions)


@dataclass(frozen=True)
class DecoderConfig:
    embed_dim: int
    n_speakers: int = 1
    speaker_embed_dim: int = 16
    in_dim: int = 80
    r: int = 5
    max_positions: int = 512
    padding_idx: Optional[int] = 0
    preattention: Tuple = ((128, 5, 1),) * 4
    convolutions: Tuple = ((128, 5, 1),) * 4
    attention: Tuple = (True,) * 4          # per-conv-layer attention flags
    dropout: float = 0.1
    use_memory_mask: bool = False
    force_monotonic_attention: Tuple = (False,) * 4
    query_position_rate: float = 1.0
    key_position_rate: float = 1.29
    window_ahead: int = 3
    window_backward: int = 1
    key_projection: bool = True
    value_projection: bool = True
    max_decoder_steps: int = 200
    min_decoder_steps: int = 10
    trainable_positional_encodings: bool = False

    @property
    def prenet_specs(self):
        return decoder_prenet_specs(self.in_dim, self.r, self.preattention,
                                    self.dropout, self.n_speakers > 1)

    @property
    def conv_specs(self):
        return decoder_conv_specs(self.convolutions, self.dropout,
                                  self.n_speakers > 1)

    @property
    def attention_specs(self):
        conv_channels = self.convolutions[0][0]
        return tuple(
            attn_ops.AttentionSpec(conv_channels, self.embed_dim, self.dropout,
                                   self.window_ahead, self.window_backward,
                                   self.key_projection, self.value_projection)
            if use else None for use in self.attention)

    @property
    def num_attention_layers(self):
        return sum(1 for a in self.attention if a)


def decoder_init(generator, cfg: DecoderConfig):
    conv_channels = cfg.convolutions[0][0]
    dev = generator.device
    params = {
        # raw-angle tables; sin/cos and the rate are applied at lookup
        "embed_query_positions": {"w": torch.from_numpy(position_encoding_init(
            cfg.max_positions, conv_channels, 1.0, sinusoidal=False)).to(dev)},
        "embed_keys_positions": {"w": torch.from_numpy(position_encoding_init(
            cfg.max_positions, cfg.embed_dim, 1.0, sinusoidal=False)).to(dev)},
        "prenet": cb.stack_init(generator, cfg.prenet_specs,
                                cfg.speaker_embed_dim),
        "convs": cb.stack_init(generator, cfg.conv_specs,
                               cfg.speaker_embed_dim),
        "attention": [attn_ops.attention_init(generator, spec)
                      if spec is not None else {}
                      for spec in cfg.attention_specs],
        "last_conv": core.conv1d_init(generator, conv_channels,
                                      cfg.in_dim * cfg.r, 1,
                                      dropout=cfg.dropout, std_mul=4.0),
        "fc": core.linear_init(generator, cfg.in_dim * cfg.r, 1),
    }
    if cfg.n_speakers > 1:
        for name in ("speaker_proj1", "speaker_proj2"):
            params[name] = core.linear_init(
                generator, cfg.speaker_embed_dim, 1, dropout=cfg.dropout)
    return params


def attention_params(params, cfg):
    """The decoder's attention parameters, one entry per conv layer: a tree
    rebuilt from a state_dict (`params.nest`) has no entry for layers past
    the last one with attention, so those are filled with {}."""
    attn = list(params["attention"])
    return attn + [{}] * (len(cfg.attention) - len(attn))


def _position_rates(params, cfg, speaker_embed):
    """Key and query position rates: the configured floats, or (B,) tensors
    scaled by sigmoid(speaker_proj(speaker_embed)) for a multi-speaker
    model."""
    w_key, w_query = cfg.key_position_rate, cfg.query_position_rate
    if speaker_embed is not None and "speaker_proj1" in params:
        w_key = w_key * torch.sigmoid(
            core.linear_apply(params["speaker_proj1"], speaker_embed))[..., 0]
        w_query = w_query * torch.sigmoid(
            core.linear_apply(params["speaker_proj2"], speaker_embed))[..., 0]
    return w_key, w_query


def decoder_apply(params, cfg: DecoderConfig, encoder_out, inputs, *,
                  text_positions=None, frame_positions=None,
                  speaker_embed=None, lengths=None, training=False,
                  generator=None):
    """Teacher-forced decoder forward.

    inputs: (B, T, in_dim) mel frames or (B, T // r, in_dim * r) grouped.
    Returns (outputs (B, T//r, in_dim*r), alignments (n_att, B, T//r, T_k),
    done (B, T//r, 1), decoder_states (B, T//r, C))."""
    keys, values = encoder_out
    B = keys.shape[0]
    if inputs.shape[-1] == cfg.in_dim:
        inputs = inputs.reshape(B, inputs.shape[1] // cfg.r,
                                cfg.in_dim * cfg.r)
    se = expand_speaker_embed(speaker_embed, inputs.shape[1])
    if se is not None:
        se = core.dropout(generator, se, cfg.dropout, training)
    mask = (core.get_mask_from_lengths(lengths, keys.shape[1])
            if cfg.use_memory_mask and lengths is not None else None)
    w_key, w_query = _position_rates(params, cfg, speaker_embed)
    if text_positions is not None:
        keys = keys + sinusoidal_encoding(
            text_positions, params["embed_keys_positions"]["w"], w_key)
    frame_pos_embed = None
    if frame_positions is not None:
        frame_pos_embed = sinusoidal_encoding(
            frame_positions, params["embed_query_positions"]["w"], w_query)

    x = core.dropout(generator, inputs, cfg.dropout, training)
    x = cb.stack_apply(params["prenet"], cfg.prenet_specs, x,
                       speaker_embed_btc=se, training=training,
                       generator=generator)
    alignments = []
    for p_conv, spec, p_attn, attn_spec in zip(
            params["convs"], cfg.conv_specs, attention_params(params, cfg),
            cfg.attention_specs):
        residual = x
        x = cb.spec_apply(p_conv, spec, x, speaker_embed_btc=se,
                          training=training, generator=generator)
        if attn_spec is not None:
            q = x if frame_pos_embed is None else x + frame_pos_embed
            keys_i, values_i = attn_ops.project_keys_values(
                p_attn, attn_spec, keys, values)
            x, alignment = attn_ops.attention_apply(
                p_attn, attn_spec, q, keys_i, values_i, mask=mask,
                training=training, generator=generator)
            alignments.append(alignment)
        x = (x + residual) * SQRT_HALF

    decoder_states = x
    x = core.conv1d_apply(params["last_conv"], x)
    outputs = torch.sigmoid(x)
    done = torch.sigmoid(core.linear_apply(params["fc"], x))
    return outputs, torch.stack(alignments), done, decoder_states


def decoder_init_state(cfg: DecoderConfig, batch: int, device=None):
    """Decode state: ring buffers + per-batch last_attended + per-batch
    positions (frames decoded)."""
    return {
        "prenet": cb.stack_init_state(cfg.prenet_specs, batch, device),
        "convs": cb.stack_init_state(cfg.conv_specs, batch, device),
        "last_attended": torch.zeros(batch, len(cfg.convolutions),
                                     dtype=torch.int64, device=device),
        "pos": torch.zeros(batch, dtype=torch.int64, device=device),
    }


def decoder_precompute(params, cfg: DecoderConfig, encoder_out, *,
                       text_positions=None, speaker_embed=None):
    """Once-per-utterance work: text position encodings on the keys and the
    per-attention-layer key/value projections. Returns (projected_kv,
    w_query), w_query a float or, multi-speaker, a (B,) tensor."""
    keys, values = encoder_out
    w_key, w_query = _position_rates(params, cfg, speaker_embed)
    if text_positions is not None:
        keys = keys + sinusoidal_encoding(
            text_positions, params["embed_keys_positions"]["w"], w_key)
    projected = [None if spec is None else attn_ops.project_keys_values(
                     p_attn, spec, keys, values)
                 for p_attn, spec in zip(attention_params(params, cfg),
                                         cfg.attention_specs)]
    return projected, w_query


# ---------------------------------------------------------------------------
# Converter (postnet)
# ---------------------------------------------------------------------------


def converter_specs(in_dim, out_dim, convolutions, time_upsampling, dropout,
                    multispeaker):
    ch = convolutions[0][0]
    ms = multispeaker

    def up_block(std_mul):
        return [cb.convT_spec(ch, ch, 2, 2, std_mul=std_mul),
                cb.glu_spec(ch, ch, 3, 1, False, True, 1.0, dropout, ms),
                cb.glu_spec(ch, ch, 3, 3, False, True, 4.0, dropout, ms)]

    specs = [cb.conv1x1_spec(in_dim, ch, 1.0)]
    if time_upsampling == 4:
        specs += up_block(1.0) + up_block(4.0)
    elif time_upsampling == 2:
        specs += up_block(1.0)
    elif time_upsampling == 1:
        specs += [cb.glu_spec(ch, ch, 3, 3, False, True, 4.0, dropout, ms)]
    else:
        raise ValueError("Not supported time_upsampling: %d" % time_upsampling)

    in_channels = ch
    std_mul = 4.0
    for (out_channels, kernel_size, dilation) in convolutions:
        if in_channels != out_channels:
            specs.append(cb.conv1x1_spec(in_channels, out_channels, std_mul,
                                         activation="relu"))
            in_channels = out_channels
            std_mul = 2.0
        specs.append(cb.glu_spec(in_channels, out_channels, kernel_size,
                                 dilation, False, True, std_mul, dropout, ms))
        in_channels = out_channels
        std_mul = 4.0
    specs.append(cb.conv1x1_spec(in_channels, out_dim, std_mul,
                                 init_dropout=dropout))
    return tuple(specs)


@dataclass(frozen=True)
class ConverterConfig:
    in_dim: int
    out_dim: int
    n_speakers: int = 1
    speaker_embed_dim: int = 16
    convolutions: Tuple = ((256, 5, 1),) * 4
    time_upsampling: int = 1
    dropout: float = 0.1

    @property
    def specs(self):
        return converter_specs(self.in_dim, self.out_dim, self.convolutions,
                               self.time_upsampling, self.dropout,
                               self.n_speakers > 1)


def converter_init(generator, cfg: ConverterConfig):
    return {"layers": cb.stack_init(generator, cfg.specs,
                                    cfg.speaker_embed_dim)}


def converter_apply(params, cfg: ConverterConfig, x, *, speaker_embed=None,
                    training=False, generator=None):
    """(B, T, in_dim) -> (B, T * upsampling, out_dim), sigmoid output. The
    speaker embedding is expanded (and, training, dropped out) again
    whenever an upsampling layer has changed T."""
    se = None
    for p, s in zip(params["layers"], cfg.specs):
        if s.speaker_proj and speaker_embed is not None and (
                se is None or se.shape[1] != x.shape[1]):
            se = core.dropout(generator,
                              expand_speaker_embed(speaker_embed, x.shape[1]),
                              cfg.dropout, training)
        x = cb.spec_apply(p, s, x, speaker_embed_btc=se, training=training,
                          generator=generator)
    return torch.sigmoid(x)
