# coding: utf-8
"""Training losses: a frozen copy of the port's plain version
(deepvoice3_pytorch_tpu_torch/training/losses.py) for one process, the
data-shard and sequence-parallel shares taken out.

All tensor code on the device of its inputs."""

import torch

from .core import sequence_mask


def prime_masks(*masks):
    """No-op: the reference runs one process over the whole batch."""


class global_frames:
    """No-op context (one process, whole sequences)."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _mask_total(mask, mask_):
    return torch.sum(mask_)


def _mean(x):
    return torch.mean(x)


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


__all__ = ["prime_masks", "global_frames", "logit", "masked_l1_loss",
           "l1_loss", "masked_mean", "binary_divergence", "spec_loss", "bce_loss",
           "guided_attention_matrix", "guided_attention_loss",
           "sequence_mask"]
