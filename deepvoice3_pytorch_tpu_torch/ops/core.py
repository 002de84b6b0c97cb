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

Inside a `tensor_parallel` block, `conv1d_apply` and `linear_apply` on a
layer that tensor parallelism sliced (parallel/mesh.py) run column-parallel:
the rank computes its block of out channels and all-gathers the blocks on
the channel axis, before a GLU or highway gate splits the channels.

Inside a `sequence_parallel` block the activations' frame axis (axis 1) is
this rank's block of the sequence: every kw > 1 conv first takes the halo
of frames its window reaches across the block's edges from the ranks that
hold them (`_Halo`), runs on the halo-extended block with its usual padding
and keeps the block's own rows, and dropout keeps the block's rows of a
mask drawn for the whole sequence. `whole_sequence` lifts it for code whose
time axis is not frame-sharded (the encoder's text).
"""

import contextvars
import functools
import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import conv_cuda
from ..parallel import mesh as mesh_lib


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
    return _column_parallel(p, x, lambda x: x @ linear_weight(p) + p["b"])


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


def conv1d_apply(p, x, *, dilation=1, padding=None, causal=False):
    """1-D convolution on (B, T, C).

    causal: left-pad (kw-1)*dilation; otherwise `padding` (l, r) frames,
    or by default symmetric (kw-1)//2*dilation on each side (odd kernels).
    The output has T + l + r - (kw-1)*dilation frames: T unless an
    explicit padding changes the length. Under conv_mode("kernel") a
    length-changing padding takes F.conv1d (kernel B3 keeps the length, as
    the JAX package's Pallas conv does), counted in
    conv_cuda.LIBRARY_CALLS."""
    return _column_parallel(p, x, lambda x: _conv1d(p, x, dilation, padding,
                                                    causal))


def _conv1d(p, x, dilation, padding, causal):
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
    sp = _sp.get()
    if sp is not None:
        if sum(pad) != (kw - 1) * dilation:
            raise ValueError("a length-changing padding %r under "
                             "sequence_parallel" % (pad,))
        T = x.shape[1]
        xe = _Halo.apply(x, sp, pad[0], pad[1])
        return _conv1d_padded(p, xe, w, pad, dilation)[:, pad[0]:pad[0] + T]
    return _conv1d_padded(p, x, w, pad, dilation)


def _conv1d_padded(p, x, w, pad, dilation):
    if _conv_mode.get() == "kernel":
        if sum(pad) == (w.shape[0] - 1) * dilation:
            return conv_cuda.conv1d_taps(x, w, p["b"], pad, dilation)
        conv_cuda.LIBRARY_CALLS["fwd_length_changing"] += 1
    xp = F.pad(x.transpose(1, 2), pad)                   # (B, C, T + pads)
    y = F.conv1d(xp, w.permute(2, 1, 0), dilation=dilation)
    return y.transpose(1, 2) + p["b"]


# ---------------------------------------------------------------------------
# tensor parallelism: Megatron's column-parallel pair
# ---------------------------------------------------------------------------


_tp = contextvars.ContextVar("dv3_torch_tensor_parallel", default=None)


class tensor_parallel:
    """`with tensor_parallel(group, sharded):` runs every conv1d_apply and
    linear_apply inside the block whose `v` is one of the tensors in
    `sharded` (this rank's blocks of the tp-sliced layers, as given to the
    forward) column-parallel over `group`, the mesh's "model" group. Per
    thread and exception-safe, as conv_mode. The collectives sit in the
    autograd graph, so the backward that follows the block runs them too."""

    def __init__(self, group, sharded):
        self.group = group
        self.ids = frozenset(id(t) for t in sharded)

    def __enter__(self):
        self._token = _tp.set(self)
        return self

    def __exit__(self, *exc):
        _tp.reset(self._token)


class _CopyToModel(torch.autograd.Function):
    """Forward: identity. Backward: dx summed over the model ranks, since a
    rank's layer only sees its own out channels' share of dx."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dx):
        return mesh_lib.all_reduce(dx.contiguous().clone(), ctx.group), None


class _GatherFromModel(torch.autograd.Function):
    """Forward: the ranks' out-channel blocks all-gathered on the last axis.
    Backward: this rank's block of dy. (The upstream gradient is the same on
    every model rank, so it is sliced, not summed: torch.distributed.nn's
    all_gather sums it and would scale it by the group's size.)"""

    @staticmethod
    def forward(ctx, y, group):
        ctx.block = (dist.get_rank(group), y.shape[-1])
        return mesh_lib.all_gather(y, group, dim=-1)

    @staticmethod
    def backward(ctx, dy):
        rank, n = ctx.block
        return dy[..., rank * n:(rank + 1) * n].contiguous(), None


def _column_parallel(p, x, fn):
    """fn(x) for a replicated layer; for a sliced one (inside
    tensor_parallel), fn on this rank's block and the blocks gathered."""
    tp = _tp.get()
    if tp is None or id(p["v"]) not in tp.ids:
        return fn(x)
    y = fn(_CopyToModel.apply(x, tp.group))
    return _GatherFromModel.apply(y, tp.group)


# ---------------------------------------------------------------------------
# sequence parallelism: frame blocks with halo exchanges
# ---------------------------------------------------------------------------


_sp = contextvars.ContextVar("dv3_torch_sequence_parallel", default=None)


class sequence_parallel:
    """`with sequence_parallel(group, groups):` treats axis 1 of the
    activations inside the block as this rank's block of frames: `groups`
    holds every rank of `group`'s block size in decoder groups (mesh
    `frame_groups`), so a tensor of L frames here is at L / groups[rank]
    frames a group and the blocks of all ranks are known at that rate.
    Per thread and exception-safe, as conv_mode. The halo exchanges sit in
    the autograd graph, so the backward that follows the block returns the
    halo frames' gradients to their owners."""

    def __init__(self, group, groups):
        self.group = group
        self.groups = tuple(groups)
        self.rank = dist.get_rank(group)

    def blocks(self, T):
        """(every rank's block length, this rank's start, the sequence's
        length) at the rate of a local tensor of T frames."""
        per, rem = divmod(T, self.groups[self.rank])
        if rem:
            raise ValueError("a block of %d frames is not a whole number of "
                             "its %d decoder groups"
                             % (T, self.groups[self.rank]))
        lengths = tuple(g * per for g in self.groups)
        return lengths, sum(lengths[:self.rank]), sum(lengths)

    def __enter__(self):
        self._token = _sp.set(self)
        return self

    def __exit__(self, *exc):
        _sp.reset(self._token)


class whole_sequence:
    """`with whole_sequence():` lifts sequence_parallel inside the block,
    for tensors whose time axis every rank holds whole (the text)."""

    def __enter__(self):
        self._token = _sp.set(None)
        return self

    def __exit__(self, *exc):
        _sp.reset(self._token)


@functools.lru_cache(maxsize=1024)
def _halo_index(plan, device):
    """The plan's index on `device`, made once (a host-to-card copy each
    conv would wait for the card)."""
    return torch.tensor(plan.index, device=device)


class _Halo(torch.autograd.Function):
    """Forward: x (B, L, C), this rank's block, extended by `left` frames
    before it and `right` after it from the ranks that hold them (zeros past
    the sequence's ends), through one all-gather of every rank's edge strip
    (mesh.HaloPlan). Backward: the halo frames' gradients scattered into
    the strips of their owners, summed over the ranks (one all-reduce), and
    each rank adds its strip's share to its edge frames."""

    @staticmethod
    def forward(ctx, x, sp, left, right):
        B, L, C = x.shape
        lengths, _, _ = sp.blocks(L)
        plan = mesh_lib.halo_plan(lengths, sp.rank, left, right)
        nl, nr = min(left, L), min(right, L)
        strip = x.new_zeros(B, plan.strip, C)
        strip[:, left - nl:left] = x[:, L - nl:]
        strip[:, left:left + nr] = x[:, :nr]
        mesh_lib.count_halo(strip)
        strips = mesh_lib.all_gather(strip, sp.group, dim=1)
        strips = torch.cat([strips, x.new_zeros(B, 1, C)], dim=1)
        index = _halo_index(plan, x.device)
        halo = strips.index_select(1, index)
        ctx.save_for_backward(index)
        ctx.geometry = (sp, plan, L, nl, nr)
        return torch.cat([halo[:, :left], x, halo[:, left:]], dim=1)

    @staticmethod
    def backward(ctx, dxe):
        sp, plan, L, nl, nr = ctx.geometry
        (index,) = ctx.saved_tensors
        left, right = plan.left, plan.right
        B, _, C = dxe.shape
        dx = dxe[:, left:left + L].clone()
        dhalo = torch.cat([dxe[:, :left], dxe[:, left + L:]], dim=1)
        dstrips = dxe.new_zeros(B, plan.zero + 1, C)
        dstrips.index_add_(1, index, dhalo)
        dstrips = dstrips[:, :plan.zero].reshape(
            B, len(sp.groups), plan.strip, C).transpose(0, 1).contiguous()
        mesh_lib.count_halo(dstrips)
        mesh_lib.all_reduce(dstrips, sp.group)
        own = dstrips[sp.rank]
        dx[:, L - nl:] += own[:, left - nl:left]
        dx[:, :nr] += own[:, left:left + nr]
        return dx, None, None, None


def conv_transpose1d_apply(p, x, *, stride=2):
    """Transposed conv (B, T, C) -> (B, L, C_out), what the JAX package's
    `lax.conv_transpose(x, w, (stride,), "VALID")` computes: L = (T - 1) *
    stride + kw frames, or T * stride where kw < stride. For kernel_size ==
    stride, the only shape the models use, L = T * stride and it is one
    matmul plus an interleave, y[b, t*stride + j, o] = sum_i x[b, t, i] *
    w[j, i, o] + b[o]. Otherwise F.conv_transpose1d with the taps flipped:
    lax.conv_transpose (transpose_kernel False) slides w unflipped over the
    stride-dilated input."""
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
    """Inverted dropout (F.dropout's train-time semantics): keep each element
    with probability 1 - rate, scaled by 1 / (1 - rate). The keep mask is a
    bernoulli draw from `generator`, which must live on x's device."""
    if not training or rate <= 0.0:
        return x
    keep = 1.0 - rate
    sp = _sp.get()
    if sp is None:
        mask = torch.empty(x.shape, device=x.device).bernoulli_(
            keep, generator=generator)
    else:       # this block's frames of the whole sequence's mask
        _, start, total = sp.blocks(x.shape[1])
        mask = torch.empty((x.shape[0], total) + x.shape[2:],
                           device=x.device).bernoulli_(
            keep, generator=generator)[:, start:start + x.shape[1]]
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
