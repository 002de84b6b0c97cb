# coding: utf-8
"""Nyanko / DCTTS-style model, counterpart of
deepvoice3_pytorch_tpu/models/nyanko.py: a highway-conv encoder split into
keys and values, an audio encoder -> one attention layer -> audio decoder,
and a highway converter with two 2x deconvolutions. Single-speaker only
(the builder refuses n_speakers > 1). The query and key position tables
hold finished sinusoidal encodings with the rates baked in."""

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops import attention as attn_ops
from ..ops import conv_blocks as cb
from ..ops import core
from ..ops.positional import position_encoding_init
from .deepvoice3 import POS_CAP, query_position_table


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_specs(embed_dim, channels, kernel_size, dropout):
    E, D, k = embed_dim, channels, kernel_size

    def hw(dil, kw=None):
        return cb.highway_spec(2 * D, 2 * D, kw or k, dil, False, dropout,
                               std_mul=1.0)

    return (
        cb.conv1x1_spec(E, 2 * D, 1.0, activation="relu"),
        cb.conv1x1_spec(2 * D, 2 * D, 2.0),
        hw(1), hw(3), hw(9), hw(27),
        hw(1), hw(3), hw(9), hw(27),
        hw(1), hw(1),
        hw(1, kw=1),
    )


@dataclass(frozen=True)
class NyankoEncoderConfig:
    n_vocab: int
    embed_dim: int
    channels: int
    kernel_size: int = 3
    padding_idx: Optional[int] = 0
    embedding_weight_std: float = 0.01
    dropout: float = 0.1

    @property
    def specs(self):
        return encoder_specs(self.embed_dim, self.channels, self.kernel_size,
                             self.dropout)


def encoder_init(generator, cfg: NyankoEncoderConfig):
    return {
        "embed_tokens": core.embedding_init(
            generator, cfg.n_vocab, cfg.embed_dim, cfg.padding_idx,
            cfg.embedding_weight_std),
        "layers": cb.stack_init(generator, cfg.specs),
    }


def encoder_apply(params, cfg: NyankoEncoderConfig, text_sequences, *,
                  speaker_embed=None, training=False, generator=None):
    """(B, T) int tokens -> (keys, values), each (B, T, channels)."""
    x = core.embedding_apply(params["embed_tokens"], text_sequences)
    x = cb.stack_apply(params["layers"], cfg.specs, x, training=training,
                       generator=generator)
    keys, values = torch.chunk(x, 2, dim=-1)
    return keys, values


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def audio_encoder_specs(in_dim, r, channels, kernel_size, dropout):
    D, k, F = channels, kernel_size, in_dim * r

    def hwc(dil):
        return cb.highway_spec(D, D, k, dil, True, dropout, std_mul=1.0)

    return (
        cb.conv1x1_spec(F, D, 1.0, activation="relu"),
        cb.conv1x1_spec(D, D, 2.0, activation="relu"),
        cb.conv1x1_spec(D, D, 2.0),
        hwc(1), hwc(3), hwc(9), hwc(27),
        hwc(1), hwc(3), hwc(9), hwc(27),
        hwc(3), hwc(3),
    )


def audio_decoder_specs(channels, kernel_size, dropout):
    D, k = channels, kernel_size

    def hwc(dil):
        return cb.highway_spec(D, D, k, dil, True, dropout, std_mul=1.0)

    return (
        cb.conv1x1_spec(2 * D, D, 1.0),
        hwc(1), hwc(3), hwc(9), hwc(27),
        hwc(1), hwc(1),
        cb.conv1x1_spec(D, D, 1.0, activation="relu"),
        cb.conv1x1_spec(D, D, 2.0, activation="relu"),
        cb.conv1x1_spec(D, D, 2.0, activation="relu"),
    )


@dataclass(frozen=True)
class NyankoDecoderConfig:
    embed_dim: int
    in_dim: int = 80
    r: int = 1
    channels: int = 256
    kernel_size: int = 3
    max_positions: int = 512
    padding_idx: Optional[int] = 0
    dropout: float = 0.1
    use_memory_mask: bool = False
    force_monotonic_attention: bool = False
    query_position_rate: float = 1.0
    key_position_rate: float = 1.29
    window_ahead: int = 3
    window_backward: int = 1
    key_projection: bool = False
    value_projection: bool = False
    max_decoder_steps: int = 200
    min_decoder_steps: int = 10
    trainable_positional_encodings: bool = False

    @property
    def audio_encoder(self):
        return audio_encoder_specs(self.in_dim, self.r, self.channels,
                                   self.kernel_size, self.dropout)

    @property
    def audio_decoder(self):
        return audio_decoder_specs(self.channels, self.kernel_size,
                                   self.dropout)

    @property
    def attention_spec(self):
        return attn_ops.AttentionSpec(
            self.channels, self.channels, self.dropout, self.window_ahead,
            self.window_backward, self.key_projection, self.value_projection)

    @property
    def num_attention_layers(self):
        return 1


def decoder_init(generator, cfg: NyankoDecoderConfig):
    D, F = cfg.channels, cfg.in_dim * cfg.r
    dev = generator.device

    def table(rate):
        return {"w": torch.from_numpy(position_encoding_init(
            cfg.max_positions, D, rate, sinusoidal=True)).to(dev)}

    return {
        # finished sinusoidal tables with the rates baked in
        "embed_query_positions": table(cfg.query_position_rate),
        "embed_keys_positions": table(cfg.key_position_rate),
        "audio_encoder": cb.stack_init(generator, cfg.audio_encoder),
        "attention": attn_ops.attention_init(generator, cfg.attention_spec),
        "audio_decoder": cb.stack_init(generator, cfg.audio_decoder),
        "last_conv": core.conv1d_init(generator, D, F, 1, std_mul=2.0),
        "fc": core.linear_init(generator, F, 1),
    }


def _embed_positions(table, positions):
    """Rows of a finished encoding table, positions clamped to its end."""
    return table[positions.clamp(0, table.shape[0] - 1)]


def decoder_apply(params, cfg: NyankoDecoderConfig, encoder_out, inputs, *,
                  text_positions=None, frame_positions=None,
                  speaker_embed=None, lengths=None, training=False,
                  generator=None):
    """Teacher-forced forward. Returns (outputs (B, T, in_dim*r),
    alignments (1, B, T, T_k), done (B, T, 1), decoder_states (B, T, D))."""
    keys, values = encoder_out
    B = keys.shape[0]
    if inputs.shape[-1] == cfg.in_dim:
        inputs = inputs.reshape(B, inputs.shape[1] // cfg.r,
                                cfg.in_dim * cfg.r)
    mask = (core.get_mask_from_lengths(lengths, keys.shape[1])
            if cfg.use_memory_mask and lengths is not None else None)
    if text_positions is not None:
        keys = keys + _embed_positions(params["embed_keys_positions"]["w"],
                                       text_positions)
    x = cb.stack_apply(params["audio_encoder"], cfg.audio_encoder, inputs,
                       training=training, generator=generator)
    Q = x
    if frame_positions is not None:
        x = x + _embed_positions(params["embed_query_positions"]["w"],
                                 frame_positions)
    keys, values = attn_ops.project_keys_values(
        params["attention"], cfg.attention_spec, keys, values)
    R, alignments = attn_ops.attention_apply(
        params["attention"], cfg.attention_spec, x, keys, values, mask=mask,
        training=training, generator=generator)
    x = cb.stack_apply(params["audio_decoder"], cfg.audio_decoder,
                       torch.cat([R, Q], dim=-1), training=training,
                       generator=generator)
    decoder_states = x
    x = core.conv1d_apply(params["last_conv"], x)
    outputs = torch.sigmoid(x)
    done = torch.sigmoid(core.linear_apply(params["fc"], x))
    return outputs, alignments[None], done, decoder_states


def decoder_init_state(cfg: NyankoDecoderConfig, batch: int, device=None):
    """Decode state: ring buffers + per-batch last_attended + per-batch
    positions (frames decoded)."""
    return {
        "audio_encoder": cb.stack_init_state(cfg.audio_encoder, batch, device),
        "audio_decoder": cb.stack_init_state(cfg.audio_decoder, batch, device),
        "last_attended": torch.zeros(batch, 1, dtype=torch.int64,
                                     device=device),
        "pos": torch.zeros(batch, dtype=torch.int64, device=device),
    }


def decoder_precompute(params, cfg: NyankoDecoderConfig, encoder_out, *,
                       text_positions=None, speaker_embed=None):
    """Text position encodings on the keys, then the (optional) key/value
    projections. Returns (projected_kv, None): nyanko has no query rate."""
    keys, values = encoder_out
    if text_positions is not None:
        keys = keys + _embed_positions(params["embed_keys_positions"]["w"],
                                       text_positions)
    return attn_ops.project_keys_values(
        params["attention"], cfg.attention_spec, keys, values), None


def make_decoder_step(params, cfg: NyankoDecoderConfig, projected_kv,
                      w_query=None, *, speaker_embed=None, mask=None,
                      ctx_scale=None):
    """step_fn(state, x_t) for ops/fused_decode.PlainDecoder and
    PlainSlotDecoder. projected_kv is one (keys, values) pair or a
    one-element list of it. Row b of a step adds the finished encoding of
    position state["pos"][b] + 1 (clamped to the table); ctx_scale: (B,)
    per-row attention context scales, None for sqrt(T_k)."""
    if isinstance(projected_kv, list):
        (projected_kv,) = projected_kv
    keys, values = projected_kv
    table = params["embed_query_positions"]["w"]
    w_last = core.conv1d_weight(params["last_conv"])[0]
    b_last = params["last_conv"]["b"]
    monotonic = cfg.force_monotonic_attention

    def step_fn(state, x_t):
        pos = state["pos"]
        fpe = _embed_positions(table, pos + 1)
        ae_states, x = cb.stack_step(params["audio_encoder"],
                                     cfg.audio_encoder,
                                     state["audio_encoder"], x_t)
        Q = x
        la = state["last_attended"]
        R, align = attn_ops.attention_step(
            params["attention"], cfg.attention_spec, x + fpe, keys, values,
            mask=mask, last_attended=la[:, 0] if monotonic else None,
            ctx_scale=ctx_scale)
        if monotonic:
            la = torch.argmax(align, dim=-1)[:, None]
        ad_states, x = cb.stack_step(params["audio_decoder"],
                                     cfg.audio_decoder,
                                     state["audio_decoder"],
                                     torch.cat([R, Q], dim=-1))
        y = x @ w_last + b_last
        done = torch.sigmoid(core.linear_apply(params["fc"], y))[:, 0]
        new_state = {"audio_encoder": ae_states, "audio_decoder": ad_states,
                     "last_attended": la,
                     "pos": torch.clamp(pos + 1, max=POS_CAP)}
        return new_state, (torch.sigmoid(y), align, done, x)

    return step_fn


def fused_decode_inputs(params, cfg: NyankoDecoderConfig, encoder_out,
                        text_positions, max_steps=None, *,
                        speaker_embed=None):
    """Launch-ready inputs for ops/fused_decode: the projected K/V and the
    finished query encodings of frames 1..max_steps (`fpe_raw` False: the
    kernel adds the row as it stands)."""
    projected_kv, _ = decoder_precompute(params, cfg, encoder_out,
                                         text_positions=text_positions)
    return dict(projected_kv=[projected_kv],
                fpe_table=query_position_table(
                    params["embed_query_positions"]["w"], max_steps),
                fpe_raw=False, w_query=None, speaker_bias=None,
                speaker_embed=None)


def decoder_decode(params, cfg: NyankoDecoderConfig, encoder_out,
                   text_positions, *, speaker_embed=None, lengths=None,
                   initial_input=None, test_inputs=None,
                   max_decoder_steps=None, early_exit=False):
    """Greedy autoregressive decoding through ops/fused_decode: the CUDA
    kernel for CUDA tensors, its plain version for CPU tensors. The padding
    mask is applied whenever `lengths` is given. With test_inputs (B, T,
    in_dim * r) the decode is teacher-forced over its T frames, one frame a
    launch (max_decoder_steps and early_exit unused)."""
    from . import decode as decode_lib
    from ..ops import fused_decode as fd

    keys, _ = encoder_out
    B, Tk = keys.shape[0], keys.shape[1]
    max_steps = max_decoder_steps or cfg.max_decoder_steps
    mask = (core.get_mask_from_lengths(lengths, Tk)
            if lengths is not None else None)
    if test_inputs is not None:
        test_inputs = test_inputs.to(device=keys.device, dtype=keys.dtype)
        max_steps = test_inputs.shape[1]
    elif initial_input is None:
        initial_input = torch.zeros(B, cfg.in_dim * cfg.r, device=keys.device)
    fi = fused_decode_inputs(params, cfg, encoder_out, text_positions,
                             max_steps)
    out = fd.fused_decode(params, cfg, fi, mask, initial_input, max_steps,
                          cfg.min_decoder_steps, early_exit=early_exit,
                          test_inputs=test_inputs)
    return decode_lib.DecodeLoopOut(
        out.outputs, out.alignments, out.done, out.decoder_states,
        decode_lib._length_from_done(out.done, cfg.min_decoder_steps,
                                     out.num_steps),
        out.num_steps)


# ---------------------------------------------------------------------------
# Converter
# ---------------------------------------------------------------------------


def converter_specs(in_dim, out_dim, channels, kernel_size, dropout):
    C, k, F, Fd = channels, kernel_size, in_dim, out_dim

    def hw(ch, dil):
        return cb.highway_spec(ch, ch, k, dil, False, dropout, std_mul=1.0)

    return (
        cb.conv1x1_spec(F, C, 1.0),
        hw(C, 1), hw(C, 3),
        cb.convT_spec(C, C, 2, 2, std_mul=1.0),
        hw(C, 1), hw(C, 3),
        cb.convT_spec(C, C, 2, 2, std_mul=1.0),
        hw(C, 1), hw(C, 3),
        cb.conv1x1_spec(C, 2 * C, 1.0),
        hw(2 * C, 1), hw(2 * C, 1),
        cb.conv1x1_spec(2 * C, Fd, 1.0),
        cb.conv1x1_spec(Fd, Fd, 1.0, activation="relu"),
        cb.conv1x1_spec(Fd, Fd, 2.0, activation="relu"),
        cb.conv1x1_spec(Fd, Fd, 2.0, activation="sigmoid"),
    )


@dataclass(frozen=True)
class NyankoConverterConfig:
    in_dim: int
    out_dim: int
    channels: int = 512
    kernel_size: int = 3
    dropout: float = 0.1
    time_upsampling: int = 4  # fixed: two 2x deconvolutions

    @property
    def specs(self):
        return converter_specs(self.in_dim, self.out_dim, self.channels,
                               self.kernel_size, self.dropout)


def converter_init(generator, cfg: NyankoConverterConfig):
    return {"layers": cb.stack_init(generator, cfg.specs)}


def converter_apply(params, cfg: NyankoConverterConfig, x, *,
                    speaker_embed=None, training=False, generator=None):
    """(B, T, in_dim) -> (B, 4T, out_dim); the last layer is a sigmoid."""
    return cb.stack_apply(params["layers"], cfg.specs, x, training=training,
                          generator=generator)
