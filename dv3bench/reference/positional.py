# coding: utf-8
"""Frozen copy of the port's deepvoice3_pytorch_tpu_torch/ops/positional.py,
for the benchmark's plain reference. Sinusoidal position encodings with a
runtime (optionally per-sample) rate, counterpart of
deepvoice3_pytorch_tpu/ops/positional.py.

The table holds raw angles; the rate and sin/cos are applied after the
gather (`sin(w * table)[pos] == sin(w * table[pos])`)."""

import numpy as np
import torch


def position_encoding_init(n_position, d_pos_vec, position_rate=1.0,
                           sinusoidal=True, dtype=np.float32):
    """Raw-angle (or sinusoidal) table, row 0 = zeros. Angles are cast to
    f32 before sin/cos, as the JAX package and the reference do."""
    pos = np.arange(n_position, dtype=np.float64)[:, None]
    i = np.arange(d_pos_vec, dtype=np.float64)[None, :]
    angles = position_rate * pos / np.power(10000.0, 2.0 * (i // 2) / d_pos_vec)
    angles[0, :] = 0.0
    angles = angles.astype(dtype)
    if sinusoidal:
        angles[1:, 0::2] = np.sin(angles[1:, 0::2])
        angles[1:, 1::2] = np.cos(angles[1:, 1::2])
    return angles


def sinusoidal_encoding(positions, table, w=1.0):
    """(B, T) int positions -> (B, T, D) encodings.

    w: python float, 0-d tensor or (B,) per-sample rate. Positions past the
    table are clamped to its last row (torch indexing would raise where
    `jnp.take` does not). Position 0 (padding) keeps the raw scaled angle,
    which is 0."""
    idx = positions.clamp(0, table.shape[0] - 1)
    ang = table[idx]                                     # (B, T, D)
    w = torch.as_tensor(w, dtype=ang.dtype, device=ang.device)
    y = w * ang if w.dim() == 0 else w[:, None, None] * ang
    col = torch.arange(table.shape[1], device=ang.device)
    enc = torch.where(col % 2 == 0, torch.sin(y), torch.cos(y))
    return torch.where((positions == 0)[..., None], y, enc)
