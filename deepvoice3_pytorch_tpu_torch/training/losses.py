# coding: utf-8
"""Training losses, counterpart of deepvoice3_pytorch_tpu/training/losses.py.

All tensor code on the device of its inputs; the guided-attention penalty is
a closed-form broadcast, with no host loop.

Inside a `data_shard` block (the train step on a mesh's "data" axis) each
loss is this rank's share of the global batch's loss, so that the shares sum
to it over the ranks: a masked term divides the local sum by the global
sum of its mask (all-reduced once for all masks, `prime_masks`), a plain
mean is the local mean over the number of data ranks (the shards have equal
shapes). A mean of per-shard means is not the global loss when the shards
hold different valid frame counts.

With sequence parallelism (`data_shard(mesh, sp=True)`) the shards are also
blocks of frames over "model", of unequal lengths: the mask sums are
all-reduced over the whole mesh, and a plain mean divides the local sum by
the global count, whose frame axis (axis -2 of every loss term) the caller
gives with `global_frames`."""

import contextlib
import contextvars
import math

import torch

from ..ops.core import sequence_mask
from ..parallel import mesh as mesh_lib

_shard = contextvars.ContextVar("dv3_torch_loss_shard", default=None)


class data_shard:
    """`with data_shard(mesh):` makes the losses inside the block this
    rank's shares of the global batch's (see the module docstring);
    data_shard(None) changes nothing. Per thread, as core.conv_mode."""

    def __init__(self, mesh, sp=False):
        self.mesh = mesh
        self.sp = sp
        self.frames = None        # sp: the global length of axis -2
        self.totals = {}          # id(mask) -> (mask, its global sum)

    def __enter__(self):
        self._token = _shard.set(self if self.mesh is not None else None)
        return self

    def __exit__(self, *exc):
        _shard.reset(self._token)

    @property
    def n_data(self):
        return mesh_lib.axis_size(self.mesh, mesh_lib.DATA_AXIS)

    def prime(self, masks):
        """The global sums of `masks` in one all-reduce over "data"."""
        masks = [m for m in {id(m): m for m in masks
                             if m is not None}.values()
                 if id(m) not in self.totals]
        if not masks:
            return
        sums = torch.stack([torch.sum(m) for m in masks])
        mesh_lib.all_reduce(sums, mesh_lib.mesh_group(self.mesh) if self.sp
                            else mesh_lib.axis_group(self.mesh,
                                                     mesh_lib.DATA_AXIS))
        for i, m in enumerate(masks):
            self.totals[id(m)] = (m, sums[i])


def prime_masks(*masks):
    """Inside data_shard: all-reduce the masks' global sums at once, before
    the losses that divide by them (a no-op outside)."""
    shard = _shard.get()
    if shard is not None:
        shard.prime(masks)


@contextlib.contextmanager
def global_frames(n):
    """Inside data_shard(sp=True): the plain means of the block divide by
    counts whose axis -2 (frames) is n long globally. A no-op elsewhere."""
    shard = _shard.get()
    if shard is None or not shard.sp:
        yield
        return
    saved, shard.frames = shard.frames, n
    try:
        yield
    finally:
        shard.frames = saved


def _mask_total(mask, mask_):
    """sum(mask_), mask_ being mask broadcast over channels: the local sum,
    or inside data_shard the global one."""
    shard = _shard.get()
    if shard is None:
        return torch.sum(mask_)
    if id(mask) not in shard.totals:
        shard.prime([mask])
    return shard.totals[id(mask)][1] * (mask_.numel() // mask.numel())


def _mean(x):
    """torch.mean(x), or inside data_shard this shard's share of the global
    mean."""
    shard = _shard.get()
    if shard is None:
        return torch.mean(x)
    if not shard.sp:
        return torch.mean(x) / shard.n_data
    if shard.frames is None:
        raise RuntimeError("a plain mean of a frame block needs its global "
                           "length (losses.global_frames)")
    others = math.prod(x.shape[:-2] + x.shape[-1:])
    return torch.sum(x) / (others * shard.frames * shard.n_data)


def logit(x, eps=1e-8):
    """log((x + eps) / (1 - x + eps)), each side floored at log(eps) so that
    a sigmoid saturated to exactly 1.0 gives a finite value."""
    floor = torch.tensor(eps, dtype=x.dtype, device=x.device)
    return (torch.log(torch.maximum(x + eps, floor))
            - torch.log(torch.maximum(1.0 - x + eps, floor)))


def masked_l1_loss(y_hat, y, mask):
    """sum(|y_hat - y| * mask) / sum(mask broadcast over channels).
    mask: (B, T, 1)."""
    mask_ = mask.expand(y_hat.shape)
    return torch.sum(torch.abs(y_hat - y) * mask_) / _mask_total(mask, mask_)


def l1_loss(y_hat, y):
    return _mean(torch.abs(y_hat - y))


def masked_mean(y, mask):
    mask_ = mask.expand(y.shape)
    return torch.sum(y * mask_) / _mask_total(mask, mask_)


def softplus(x):
    """log(1 + exp(x)) without the threshold of F.softplus."""
    return torch.logaddexp(x, torch.zeros_like(x))


def binary_divergence(y_hat, y, mask, masked_loss_weight):
    """Logit-domain BCE between [0, 1] spectrograms."""
    y_hat_logits = logit(y_hat)
    z = -y * y_hat_logits + softplus(y_hat_logits)
    w = masked_loss_weight
    if w > 0:
        return w * masked_mean(z, mask) + (1 - w) * _mean(z)
    return _mean(z)


def spec_loss(y_hat, y, mask, *, masked_loss_weight=0.5,
              binary_divergence_weight=0.1, priority_bin=None,
              priority_w=0.0):
    """(l1_loss, binary_div) blend."""
    w = masked_loss_weight
    if w > 0:
        l1 = w * masked_l1_loss(y_hat, y, mask) + (1 - w) * l1_loss(y_hat, y)
    else:
        l1 = l1_loss(y_hat, y)

    if priority_bin is not None and priority_w > 0:
        yp, tp = y_hat[..., :priority_bin], y[..., :priority_bin]
        if w > 0:
            priority = w * masked_l1_loss(yp, tp, mask) \
                + (1 - w) * l1_loss(yp, tp)
        else:
            priority = l1_loss(yp, tp)
        l1 = (1 - priority_w) * l1 + priority_w * priority

    if binary_divergence_weight <= 0:
        binary_div = torch.zeros((), device=y_hat.device)
    else:
        binary_div = binary_divergence(y_hat, y, mask, w)
    return l1, binary_div


def bce_loss(y_hat, y):
    """nn.BCELoss on probabilities, each log term clamped at -100 as torch's
    BCELoss does. Saturated lanes (probability below the smallest normal f32
    from either end) are routed around log entirely, so they take exactly
    -100 and zero gradient instead of 0 * inf."""
    tiny = 1.1754944e-38                    # smallest f32 normal
    lo_sat = y_hat < tiny
    hi_sat = 1.0 - y_hat < tiny
    half = torch.full_like(y_hat, 0.5)
    hundred = torch.full_like(y_hat, -100.0)
    log_p = torch.where(lo_sat, hundred,
                        torch.log(torch.where(lo_sat, half, y_hat)))
    log_1mp = torch.where(hi_sat, hundred,
                          torch.log1p(-torch.where(hi_sat, half, y_hat)))
    return -_mean(y * log_p + (1 - y) * log_1mp)


def guided_attention_matrix(input_lengths, decoder_lengths, max_input_len,
                            max_decoder_len, g=0.2, t_start=0):
    """W[b, t_dec, n_text] = 1 - exp(-((n/N - t/T)^2) / (2 g^2)), zero
    outside the valid lengths. (B, T_dec, N_text) f32. t_start: the global
    index of the first decoder frame (a block's, under sp)."""
    dev = input_lengths.device
    N = input_lengths.float()[:, None, None]
    T = decoder_lengths.float()[:, None, None]
    n = torch.arange(max_input_len, dtype=torch.float32,
                     device=dev)[None, None, :]
    t = torch.arange(t_start, t_start + max_decoder_len, dtype=torch.float32,
                     device=dev)[None, :, None]
    w = 1.0 - torch.exp(-((n / N - t / T) ** 2) / (2.0 * g * g))
    valid = (n < N) & (t < T)
    return torch.where(valid, w, torch.zeros_like(w))


def guided_attention_loss(attn, input_lengths, decoder_lengths, g=0.2,
                          t_start=0):
    """attn: (n_layers, B, T_dec, T_text). Mean of attn * W over the whole
    tensor. t_start: the global index of attn's first decoder frame."""
    W = guided_attention_matrix(input_lengths, decoder_lengths,
                                attn.shape[-1], attn.shape[-2], g, t_start)
    return _mean(attn * W[None])


__all__ = ["data_shard", "prime_masks", "global_frames", "logit", "masked_l1_loss", "l1_loss", "masked_mean",
           "binary_divergence", "spec_loss", "bce_loss",
           "guided_attention_matrix", "guided_attention_loss",
           "sequence_mask"]
