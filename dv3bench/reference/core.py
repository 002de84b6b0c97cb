# coding: utf-8
"""Weight-normalized core ops in plain PyTorch: a frozen copy of the port's
plain versions (deepvoice3_pytorch_tpu_torch/ops/core.py) with every
kernel route, tensor and sequence parallelism taken out. Every kw > 1
convolution is `F.conv1d`.

Layouts are the port's (and the JAX package's):
  * activations:        (B, T, C)
  * Linear v:           (in, out)                  g: (out,)   b: (out,)
  * Conv1d v:           (kw, in, out)              g: (out,)   b: (out,)
  * ConvTranspose1d v:  (kw, in, out)              g: (in,)    b: (out,)

The initializers draw through `normal(shape, std)`, a callable the caller
supplies (weights.py: slices of one seeded draw on the card)."""

import math

import torch
import torch.nn.functional as F


def _wn_weight(v, g, axes):
    """w = g * v / ||v|| with the norm over `axes` (broadcast on the rest)."""
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    gshape = [1] * v.dim()
    for i, s in enumerate(v.shape):
        if i not in axes:
            gshape[i] = s
    return v * (g.reshape(gshape) / norm)


def linear_weight(p):
    return _wn_weight(p["v"], p["g"], axes=(0,))


def conv1d_weight(p):
    return _wn_weight(p["v"], p["g"], axes=(0, 1))


def conv_transpose1d_weight(p):
    return _wn_weight(p["v"], p["g"], axes=(0, 2))


# ---------------------------------------------------------------------------
# initializers: the port's shapes and distributions; `normal` is
# normal(shape, std) -> tensor, the generator the port passes
# ---------------------------------------------------------------------------


def linear_init(normal, in_features, out_features, dropout=0.0):
    std = math.sqrt((1.0 - dropout) / in_features)
    v = normal((in_features, out_features), std)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=0)),
            "b": torch.zeros(out_features, device=v.device)}


def embedding_init(normal, num_embeddings, embedding_dim, padding_idx=None,
                   std=0.01):
    w = normal((num_embeddings, embedding_dim), std)
    if padding_idx is not None:
        w[padding_idx] = 0.0
    return {"w": w}


def conv1d_init(normal, in_channels, out_channels, kernel_size, dropout=0.0,
                std_mul=4.0):
    std = math.sqrt((std_mul * (1.0 - dropout)) / (kernel_size * in_channels))
    v = normal((kernel_size, in_channels, out_channels), std)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=(0, 1))),
            "b": torch.zeros(out_channels, device=v.device)}


def conv_transpose1d_init(normal, in_channels, out_channels, kernel_size,
                          dropout=0.0, std_mul=1.0):
    std = math.sqrt((std_mul * (1.0 - dropout)) / (kernel_size * in_channels))
    v = normal((kernel_size, in_channels, out_channels), std)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=(0, 2))),
            "b": torch.zeros(out_channels, device=v.device)}


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------


def linear_apply(p, x):
    return x @ linear_weight(p) + p["b"]


def embedding_apply(p, ids):
    return p["w"][ids]


def conv1d_apply(p, x, *, dilation=1, padding=None, causal=False):
    """1-D convolution on (B, T, C): causal left-pads (kw-1)*dilation,
    otherwise `padding` (l, r) or symmetric (kw-1)//2*dilation."""
    w = conv1d_weight(p)
    kw = w.shape[0]
    if kw == 1:
        return x @ w[0] + p["b"]
    if causal:
        pad = ((kw - 1) * dilation, 0)
    elif padding is None:
        pad = ((kw - 1) // 2 * dilation,) * 2
    else:
        pad = tuple(padding)
    xp = F.pad(x.transpose(1, 2), pad)
    y = F.conv1d(xp, w.permute(2, 1, 0), dilation=dilation)
    return y.transpose(1, 2) + p["b"]


def conv_transpose1d_apply(p, x, *, stride=2):
    """Transposed conv with kernel == stride (the only shape the models
    use): one matmul and an interleave."""
    w = conv_transpose1d_weight(p)                       # (kw, in, out)
    kw, cin, cout = w.shape
    if kw != stride:
        y = F.conv_transpose1d(x.transpose(1, 2), w.flip(0).permute(1, 2, 0),
                               stride=stride,
                               output_padding=max(stride - kw, 0))
        return y.transpose(1, 2) + p["b"]
    B, T, _ = x.shape
    y = x @ w.permute(1, 0, 2).reshape(cin, kw * cout)
    return y.reshape(B, T * kw, cout) + p["b"]


def glu(x, dim=-1):
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def softsign(x):
    return x / (1.0 + torch.abs(x))


def dropout(generator, x, rate, training):
    """Inverted dropout: keep each element with probability 1 - rate, scaled
    by 1 / (1 - rate); the keep mask is a bernoulli draw from `generator`,
    in the port's call order, so the same generator state gives the same
    mask."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def sequence_mask(lengths, max_len):
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()


def get_mask_from_lengths(lengths, max_len):
    """True where PADDED."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos >= lengths[:, None]
