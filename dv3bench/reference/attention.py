# coding: utf-8
"""Frozen copy of the port's deepvoice3_pytorch_tpu_torch/ops/attention.py, for
the benchmark's plain reference. Single-head dot-product attention with
monotonic windowing, counterpart of deepvoice3_pytorch_tpu/ops/attention.py.

query proj -> QK^T -> padding mask -> optional monotonic window around a
per-batch `last_attended` -> softmax -> (dropout when training) -> AV ->
sqrt(T_k) scale -> out proj -> residual * sqrt(0.5). Key/value projections
are applied once per utterance (`project_keys_values`), outside the decode
loop. Scores and softmax are f32 whatever the activations' type (bf16 under
the mixed-precision train step), as in the JAX package."""

import math
from dataclasses import dataclass

import torch

from . import core

MASK_VALUE = -1.0e9  # large-negative instead of -inf, as the JAX package


@dataclass(frozen=True)
class AttentionSpec:
    conv_channels: int
    embed_dim: int
    dropout: float = 0.1
    window_ahead: int = 3
    window_backward: int = 1
    key_projection: bool = True
    value_projection: bool = True


def attention_init(generator, spec: AttentionSpec):
    params = {"query_proj": core.linear_init(
        generator, spec.conv_channels, spec.embed_dim)}
    if spec.key_projection:
        kp = core.linear_init(generator, spec.embed_dim, spec.embed_dim)
        if spec.conv_channels == spec.embed_dim:
            # DeepVoice3 paper: key projection starts equal to the query's
            kp = {"v": params["query_proj"]["v"].clone(),
                  "g": params["query_proj"]["g"].clone(), "b": kp["b"]}
        params["key_proj"] = kp
    if spec.value_projection:
        params["value_proj"] = core.linear_init(
            generator, spec.embed_dim, spec.embed_dim)
    params["out_proj"] = core.linear_init(
        generator, spec.embed_dim, spec.conv_channels)
    return params


def project_keys_values(params, spec: AttentionSpec, keys, values):
    if spec.key_projection:
        keys = core.linear_apply(params["key_proj"], keys)
    if spec.value_projection:
        values = core.linear_apply(params["value_proj"], values)
    return keys, values


def attention_apply(params, spec: AttentionSpec, query, keys, values, *,
                    mask=None, last_attended=None, training=False,
                    generator=None, ctx_scale=None):
    """(B, T_q, C) queries over (B, T_k, E) keys/values, already passed
    through `project_keys_values`.

    mask: (B, T_k) True where PADDED. last_attended: (B,) int window centres
    (None = no window). When training, the attention weights are dropped out
    (rate spec.dropout) before the weighted sum. ctx_scale: (B,) per-row
    context scales in place of sqrt(T_k) (continuous batching keeps each
    slot's scale at the text length it was admitted at). Returns (out
    (B, T_q, C), attn (B, T_q, T_k) f32)."""
    residual = query
    x = core.linear_apply(params["query_proj"], query)          # (B, Tq, E)
    scores = x.float() @ keys.float().transpose(1, 2)           # (B, Tq, Tk)
    if mask is not None:
        scores = scores.masked_fill(mask[:, None, :], MASK_VALUE)
    if last_attended is not None:
        idx = torch.arange(keys.shape[1], device=keys.device)[None, :]
        la = last_attended[:, None]
        win = (idx < la - spec.window_backward) | \
              (idx >= la + spec.window_ahead)
        scores = scores.masked_fill(win[:, None, :], MASK_VALUE)
    attn = torch.softmax(scores, dim=-1)
    x = core.dropout(generator, attn.to(values.dtype), spec.dropout,
                     training)
    x = x @ values
    # scale by T_k * sqrt(1/T_k) == sqrt(T_k), T_k the PADDED length
    if ctx_scale is None:
        s = values.shape[1]
        x = x * (s * math.sqrt(1.0 / s))
    else:
        x = x * ctx_scale.to(x.dtype)[:, None, None]
    x = core.linear_apply(params["out_proj"], x)
    return (x + residual) * math.sqrt(0.5), attn


def attention_step(params, spec: AttentionSpec, query, keys, values, *,
                   mask=None, last_attended=None, ctx_scale=None):
    """One decode step. query (B, C) -> (out (B, C), attn (B, T_k)); keys
    and values already projected."""
    out, attn = attention_apply(
        params, spec, query[:, None, :], keys, values, mask=mask,
        last_attended=last_attended, ctx_scale=ctx_scale)
    return out[:, 0], attn[:, 0]
