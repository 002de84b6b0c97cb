# coding: utf-8
"""Frozen copy of the port's deepvoice3_pytorch_tpu_torch/ops/conv_blocks.py,
for the benchmark's plain reference. Conv stack building blocks, counterpart
of deepvoice3_pytorch_tpu/ops/conv_blocks.py.

A stack is a static tuple of `ConvSpec`s plus a parallel list of parameter
nodes. The same specs drive the full-sequence path (`stack_apply`, with
input dropout before each GLU conv when training) and the one-frame path
against ring buffers (`stack_step`). GLU layers of a multi-speaker model
add a softsign speaker bias to the gate's value half; highway layers (nyanko)
gate between the conv output and their input, or add a GLU residual.
"""

import math
from dataclasses import dataclass
from typing import Optional

import torch

from . import core

SQRT_HALF = math.sqrt(0.5)


@dataclass(frozen=True)
class ConvSpec:
    """Static description of one layer in a conv stack."""
    kind: str                 # 'glu' | 'highway' | 'conv1x1' | 'conv' | 'convT'
    in_channels: int
    out_channels: int
    kernel_size: int = 1
    dilation: int = 1
    causal: bool = False
    residual: bool = False    # glu blocks: residual add * sqrt(0.5)
    std_mul: float = 1.0
    init_dropout: float = 0.0   # dropout used in the init std formula
    dropout: float = 0.0        # runtime input dropout (glu / highway)
    activation: Optional[str] = None  # 'conv1x1'/'conv': 'relu'|'sigmoid'|None
    stride: int = 1           # for 'convT'
    highway_glu: bool = False
    speaker_proj: bool = False


def glu_spec(in_ch, out_ch, kw, dilation, causal, residual, std_mul, dropout,
             multispeaker=False):
    return ConvSpec("glu", in_ch, out_ch, kw, dilation, causal, residual,
                    std_mul, init_dropout=dropout, dropout=dropout,
                    speaker_proj=multispeaker)


def highway_spec(in_ch, out_ch, kw, dilation, causal, dropout, std_mul=None,
                 glu=False):
    if std_mul is None:
        std_mul = 4.0 if glu else 1.0
    return ConvSpec("highway", in_ch, out_ch, kw, dilation, causal, False,
                    std_mul, init_dropout=dropout, dropout=dropout,
                    highway_glu=glu)


def conv1x1_spec(in_ch, out_ch, std_mul, init_dropout=0.0, activation=None):
    return ConvSpec("conv1x1", in_ch, out_ch, 1, 1, False, False, std_mul,
                    init_dropout=init_dropout, activation=activation)


def convT_spec(in_ch, out_ch, kw=2, stride=2, std_mul=1.0):
    return ConvSpec("convT", in_ch, out_ch, kw, stride=stride, std_mul=std_mul)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def spec_init(generator, spec: ConvSpec, speaker_embed_dim: int = 0):
    if spec.kind == "convT":
        return {"conv": core.conv_transpose1d_init(
            generator, spec.in_channels, spec.out_channels, spec.kernel_size,
            dropout=spec.init_dropout, std_mul=spec.std_mul)}
    n_out = spec.out_channels * (2 if spec.kind in ("glu", "highway") else 1)
    params = {"conv": core.conv1d_init(
        generator, spec.in_channels, n_out, spec.kernel_size,
        dropout=spec.init_dropout, std_mul=spec.std_mul)}
    if spec.speaker_proj:
        params["speaker_proj"] = core.linear_init(
            generator, speaker_embed_dim, spec.out_channels)
    return params


def stack_init(generator, specs, speaker_embed_dim: int = 0):
    return [spec_init(generator, s, speaker_embed_dim) for s in specs]


# ---------------------------------------------------------------------------
# full-sequence apply
# ---------------------------------------------------------------------------


def _activate(x, name):
    if name == "relu":
        return torch.relu(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    return x


def _gate(params, spec, y, residual, speaker_embed):
    """Gate of a GLU or highway layer on a conv output with 2*out_channels
    on the last axis. speaker_embed: (B, T, D) or (B, D), the same leading
    axes as y; a GLU layer with a speaker projection adds
    softsign(speaker_proj(speaker_embed)) to the value half."""
    a, b = torch.chunk(y, 2, dim=-1)
    if spec.kind == "glu":
        if spec.speaker_proj and speaker_embed is not None:
            a = a + core.softsign(
                core.linear_apply(params["speaker_proj"], speaker_embed))
        x = a * torch.sigmoid(b)
        return (x + residual) * SQRT_HALF if spec.residual else x
    if spec.highway_glu:
        return (a * torch.sigmoid(b) + residual) * SQRT_HALF
    gate = torch.sigmoid(b)
    return gate * a + (1.0 - gate) * residual


def spec_apply(params, spec: ConvSpec, x, *, speaker_embed_btc=None,
               training=False, generator=None):
    """Apply one layer to (B, T, C). Returns (B, T', C'). When training, a
    GLU or highway layer's input is dropped out (rate spec.dropout) before
    the conv; the residual is the undropped input."""
    if spec.kind in ("conv1x1", "conv"):
        y = core.conv1d_apply(params["conv"], x, dilation=spec.dilation,
                              causal=spec.causal)
        return _activate(y, spec.activation)
    if spec.kind == "convT":
        return core.conv_transpose1d_apply(params["conv"], x,
                                           stride=spec.stride)
    residual = x
    x = core.dropout(generator, x, spec.dropout, training)
    y = core.conv1d_apply(params["conv"], x, dilation=spec.dilation,
                          causal=spec.causal)
    return _gate(params, spec, y, residual, speaker_embed_btc)


def stack_apply(params, specs, x, *, speaker_embed_btc=None, training=False,
                generator=None):
    for p, s in zip(params, specs):
        x = spec_apply(p, s, x, speaker_embed_btc=speaker_embed_btc,
                       training=training, generator=generator)
    return x


# ---------------------------------------------------------------------------
# incremental (ring-buffer) path
# ---------------------------------------------------------------------------


def buffer_len(spec: ConvSpec) -> int:
    return (spec.kernel_size - 1) * spec.dilation + 1


def spec_init_state(spec: ConvSpec, batch: int, device=None):
    """Ring buffer for one layer (None if stateless)."""
    if spec.kind in ("glu", "highway") and spec.kernel_size > 1:
        return torch.zeros(batch, buffer_len(spec), spec.in_channels,
                           device=device)
    return None


def stack_init_state(specs, batch: int, device=None):
    return [spec_init_state(s, batch, device) for s in specs]


def _conv_step(conv_params, buf, x, spec):
    """One causal-conv step: push x into buf, one matmul over the dilated
    taps. x: (B, Cin) newest frame. Returns (new_buf, y (B, Cout))."""
    w = core.conv1d_weight(conv_params)        # (kw, in, out)
    kw, cin, cout = w.shape
    if kw == 1:
        return buf, x @ w[0] + conv_params["b"]
    new_buf = torch.cat([buf[:, 1:, :], x[:, None, :]], dim=1)
    taps = new_buf[:, ::spec.dilation, :]      # (B, kw, in)
    y = taps.reshape(x.shape[0], kw * cin) @ w.reshape(kw * cin, cout)
    return new_buf, y + conv_params["b"]


def spec_step(params, spec: ConvSpec, state, x, *, speaker_embed=None):
    """One frame through one layer. x: (B, C); speaker_embed: (B, D) or
    None. Returns (new_state, y)."""
    if spec.kind in ("conv1x1", "conv"):
        w = core.conv1d_weight(params["conv"])
        return state, _activate(x @ w[0] + params["conv"]["b"],
                                spec.activation)
    if spec.kind == "convT":
        raise ValueError("convT has no incremental path (converter is offline)")
    state, y = _conv_step(params["conv"], state, x, spec)
    return state, _gate(params, spec, y, x, speaker_embed)


def stack_step(params, specs, states, x, *, speaker_embed=None):
    new_states = []
    for p, s, st in zip(params, specs, states):
        st, x = spec_step(p, s, st, x, speaker_embed=speaker_embed)
        new_states.append(st)
    return new_states, x
