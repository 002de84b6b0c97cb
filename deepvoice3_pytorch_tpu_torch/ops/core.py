# coding: utf-8
"""Weight-normalized core ops, counterpart of deepvoice3_pytorch_tpu/ops/core.py.

Layouts are the JAX package's, so parameters load without any transpose:
  * activations:        (B, T, C)
  * Linear v:           (in, out)                  g: (out,)   b: (out,)
  * Conv1d v:           (kw, in, out)              g: (out,)   b: (out,)
  * ConvTranspose1d v:  (kw, in, out)              g: (in,)    b: (out,)

Weight norm follows torch.nn.utils.weight_norm(dim=0) on the torch layouts,
expressed on the layouts above: Linear normalises over axis 0, Conv1d over
axes (0, 1), ConvTranspose1d over axes (0, 2).

A parameter argument `p` is anything indexable by name (`p["v"]`): a
`params.ParamTree` node or a plain dict of tensors.

Convolutions with kw > 1 lower one of two ways, chosen per thread by the
`conv_mode` context (the counterpart of the JAX package's
`conv_lowering`): "library" (the default, as the JAX default "xla") calls
`F.conv1d`; "kernel" (the counterpart of "pallas") calls the tap-accumulating
kernel B3 through `ops/conv_cuda.conv1d_taps`, which the train step uses.
"""

import contextvars
import math

import torch
import torch.nn.functional as F

from . import conv_cuda


# ---------------------------------------------------------------------------
# weight-norm folds
# ---------------------------------------------------------------------------


def _wn_weight(v, g, axes):
    """w = g * v / ||v|| with the norm over `axes` (broadcast on the rest)."""
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True))
    gshape = [1] * v.dim()
    for i, s in enumerate(v.shape):
        if i not in axes:
            gshape[i] = s
    return v * (g.reshape(gshape) / norm)


def linear_weight(p):
    """Effective (in, out) weight of a weight-normalized linear layer."""
    return _wn_weight(p["v"], p["g"], axes=(0,))


def conv1d_weight(p):
    """Effective (kw, in, out) weight of a weight-normalized conv layer."""
    return _wn_weight(p["v"], p["g"], axes=(0, 1))


def conv_transpose1d_weight(p):
    """Effective (kw, in, out) weight; norm per input channel."""
    return _wn_weight(p["v"], p["g"], axes=(0, 2))


# ---------------------------------------------------------------------------
# initializers (same shapes and distributions as the JAX package; the values
# differ because the generator differs)
# ---------------------------------------------------------------------------


def _normal(generator, shape, std):
    return std * torch.randn(shape, generator=generator,
                             device=generator.device, dtype=torch.float32)


def linear_init(generator, in_features, out_features, dropout=0.0):
    std = math.sqrt((1.0 - dropout) / in_features)
    v = _normal(generator, (in_features, out_features), std)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=0)),
            "b": torch.zeros(out_features, device=v.device)}


def embedding_init(generator, num_embeddings, embedding_dim, padding_idx=None,
                   std=0.01):
    w = _normal(generator, (num_embeddings, embedding_dim), std)
    if padding_idx is not None:
        w[padding_idx] = 0.0
    return {"w": w}


def conv1d_init(generator, in_channels, out_channels, kernel_size, dropout=0.0,
                std_mul=4.0):
    std = math.sqrt((std_mul * (1.0 - dropout)) / (kernel_size * in_channels))
    v = _normal(generator, (kernel_size, in_channels, out_channels), std)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=(0, 1))),
            "b": torch.zeros(out_channels, device=v.device)}


def conv_transpose1d_init(generator, in_channels, out_channels, kernel_size,
                          dropout=0.0, std_mul=1.0):
    std = math.sqrt((std_mul * (1.0 - dropout)) / (kernel_size * in_channels))
    v = _normal(generator, (kernel_size, in_channels, out_channels), std)
    return {"v": v, "g": torch.sqrt(torch.sum(v * v, dim=(0, 2))),
            "b": torch.zeros(out_channels, device=v.device)}


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------


def linear_apply(p, x):
    return x @ linear_weight(p) + p["b"]


def embedding_apply(p, ids):
    return p["w"][ids]


CONV_MODES = ("library", "kernel")
_conv_mode = contextvars.ContextVar("dv3_torch_conv_mode", default="library")


class conv_mode:
    """`with conv_mode("kernel"):` routes every kw > 1 conv1d_apply inside
    the block through kernel B3; "library" through F.conv1d. Per thread and
    exception-safe (ContextVar token reset)."""

    def __init__(self, mode):
        if mode not in CONV_MODES:
            raise ValueError("conv_mode must be one of %s, got %r"
                             % (CONV_MODES, mode))
        self.mode = mode

    def __enter__(self):
        self._token = _conv_mode.set(self.mode)
        return self

    def __exit__(self, *exc):
        _conv_mode.reset(self._token)


def conv1d_apply(p, x, *, dilation=1, causal=False):
    """1-D convolution on (B, T, C), output length == input length.

    causal: left-pad (kw-1)*dilation; otherwise symmetric
    (kw-1)//2*dilation on each side (odd kernels)."""
    w = conv1d_weight(p)
    kw = w.shape[0]
    if kw == 1:
        return x @ w[0] + p["b"]
    if causal:
        pad = ((kw - 1) * dilation, 0)
    else:
        pad = ((kw - 1) // 2 * dilation,) * 2
    if _conv_mode.get() == "kernel":
        return conv_cuda.conv1d_taps(x, w, p["b"], pad, dilation)
    xp = F.pad(x.transpose(1, 2), pad)                   # (B, C, T + pads)
    y = F.conv1d(xp, w.permute(2, 1, 0), dilation=dilation)
    return y.transpose(1, 2) + p["b"]


def conv_transpose1d_apply(p, x, *, stride=2):
    """Transposed conv (B, T, C) -> (B, T*stride, C_out) for kernel_size ==
    stride, the only shape the models use: one matmul plus an interleave,
    y[b, t*stride + j, o] = sum_i x[b, t, i] * w[j, i, o] + b[o]."""
    w = conv_transpose1d_weight(p)                       # (kw, in, out)
    kw, cin, cout = w.shape
    if kw != stride:
        raise NotImplementedError(
            "conv_transpose1d_apply supports kernel_size == stride only "
            "(got %d, %d)" % (kw, stride))
    B, T, _ = x.shape
    y = x @ w.permute(1, 0, 2).reshape(cin, kw * cout)
    return y.reshape(B, T * kw, cout) + p["b"]


def glu(x, dim=-1):
    a, b = torch.chunk(x, 2, dim=dim)
    return a * torch.sigmoid(b)


def softsign(x):
    return x / (1.0 + torch.abs(x))


def dropout(generator, x, rate, training):
    """Inverted dropout (F.dropout's train-time semantics): keep each element
    with probability 1 - rate, scaled by 1 / (1 - rate). The keep mask is a
    bernoulli draw from `generator`, which must live on x's device."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.empty(x.shape, device=x.device).bernoulli_(
        keep, generator=generator)
    return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


def sequence_mask(lengths, max_len):
    """(B,) lengths -> (B, max_len) f32 mask, 1 where valid."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).float()


def get_mask_from_lengths(lengths, max_len):
    """True where PADDED."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos >= lengths[:, None]


class strict_numerics:
    """Full-f32 products on the card: turns TF32 off for matmuls and cuDNN
    convolutions inside the block and restores both flags on exit. TF32
    keeps about three decimal digits; the parity bars assume f32."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved
