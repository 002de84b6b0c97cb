# coding: utf-8
"""Local-weighted-sums (LWS) phase retrieval in plain PyTorch, counterpart
of deepvoice3_pytorch_tpu/dsp/lws_phase.py (`phase_retrieval="lws"`).

Each iteration applies the spectrogram-consistency operator G = STFT o
iSTFT truncated to a local neighbourhood, then re-imposes the magnitudes.
The local weights are the twisted-convolution kernels of G
(dsp/reference_model.py `consistency_kernels`), indexed by the source frame
index mod k = fft / hop. An iteration is (2k - 1) x (2 dm_max + 1) = 63
rolled complex multiply-adds over the full (..., n, fft) spectrum in the
absolute-phase convention, and no DFT; the final iSTFT is an f32 iDFT
matmul and the windowed overlap-add. The JAX package computes it in XLA, so
this module is its port; on the card it is a few hundred elementwise
launches an iteration.
"""

from functools import lru_cache

import numpy as np
import torch

from . import stft as dsp


@lru_cache(maxsize=8)
def _host_kernels(fft_size, hop, window_key, dm_max=4):
    """The twisted consistency kernels (numpy float64), cached."""
    from . import reference_model as ref
    window = np.frombuffer(window_key, dtype=np.float64)
    return ref.consistency_kernels(fft_size, hop, window, dm_max=dm_max)


def _coef_rows(kers, F):
    """Per-output-row complex coefficients for each (dn, dm) tap:
    coef[dn, dm, n] = K_{(n-dn) mod k}[dn, dm], zeroed where the source row
    n - dn falls outside [0, F) so a circular roll is exact."""
    k, n_dn, n_dm = kers.shape
    dn_max = (n_dn - 1) // 2
    rows = np.arange(F)
    coef = np.zeros((n_dn, n_dm, F), np.complex128)
    for i, dn in enumerate(range(-dn_max, dn_max + 1)):
        c = kers[(rows - dn) % k, i, :].T            # (n_dm, F)
        valid = (rows - dn >= 0) & (rows - dn < F)
        coef[i] = c * valid[None, :]
    return coef


def lws_run(mag, fft_size, hop, window_np, *, n_iters=60, momentum=0.9,
            center=True, dm_max=4):
    """Phase retrieval from |S|: (..., n, fft//2+1) f32 magnitudes in the
    frame-relative layout of `stft.stft` -> waveform (..., hop * n) on the
    magnitudes' device. window_np: the (host) analysis window of the STFT.
    center picks only the final trim (True drops fft_size // 2 samples).
    Needs hop | fft_size: the twisted structure exists only then."""
    if fft_size % hop != 0:
        raise ValueError(
            "lws phase retrieval requires hop to divide fft_size "
            "(got fft=%d hop=%d); use phase_retrieval='gl'"
            % (fft_size, hop))
    dev = mag.device
    window_np = np.asarray(window_np, np.float64)
    kers = _host_kernels(fft_size, hop, window_np.tobytes(), dm_max=dm_max)
    k = fft_size // hop
    dn_max = k - 1

    *lead, F, n_bins = mag.shape
    if n_bins != fft_size // 2 + 1:
        raise ValueError("lws_run expects (..., n, %d) magnitudes, got %s"
                         % (fft_size // 2 + 1, tuple(mag.shape)))
    coef = _coef_rows(kers, F)                       # (n_dn, n_dm, F)
    coef_re = torch.from_numpy(coef.real.astype(np.float32)).to(dev)
    coef_im = torch.from_numpy(coef.imag.astype(np.float32)).to(dev)
    n_dm = coef.shape[1]

    # full-spectrum Hermitian magnitudes (..., F, fft)
    M = torch.cat([mag, torch.flip(mag[..., 1:fft_size // 2], dims=[-1])],
                  dim=-1).float()

    # absolute-phase twist e^{-2pi i (m n mod k) / k}; the restore factor
    # is its conjugate
    m_idx = torch.arange(fft_size, device=dev) % k
    n_idx = torch.arange(F, device=dev) % k
    resid = (n_idx[:, None] * m_idx[None, :]) % k    # (F, fft)
    ang = -2.0 * np.pi * resid.float() / k
    tw_re, tw_im = torch.cos(ang), torch.sin(ang)

    def local_G(re, im):
        out_re = torch.zeros_like(re)
        out_im = torch.zeros_like(im)
        for i, dn in enumerate(range(-dn_max, dn_max + 1)):
            re_n = torch.roll(re, dn, dims=-2)
            im_n = torch.roll(im, dn, dims=-2)
            for j in range(n_dm):
                dm = j - (n_dm - 1) // 2
                cr = coef_re[i, j][:, None]
                ci = coef_im[i, j][:, None]
                sr = torch.roll(re_n, dm, dims=-1)
                si = torch.roll(im_n, dm, dims=-1)
                out_re = out_re + cr * sr - ci * si
                out_im = out_im + cr * si + ci * sr
        return out_re, out_im

    eps = 1e-16
    re, im = M, torch.zeros_like(M)
    pre = pim = torch.zeros_like(M)
    for _ in range(n_iters):
        g_re, g_im = local_G(re, im)
        a_re = g_re + momentum * (g_re - pre)
        a_im = g_im + momentum * (g_im - pim)
        norm = torch.clamp_min(torch.sqrt(a_re * a_re + a_im * a_im), eps)
        re, im, pre, pim = M * a_re / norm, M * a_im / norm, g_re, g_im

    # back to the frame-relative half spectrum, then the iSTFT
    re_rel = re * tw_re + im * tw_im
    im_rel = im * tw_re - re * tw_im
    mats = [torch.from_numpy(m).to(dev) for m in dsp.dft_mats(fft_size)]
    win = torch.from_numpy(window_np.astype(np.float32)).to(dev)
    frames = (re_rel[..., :n_bins] @ mats[2]
              + im_rel[..., :n_bins] @ mats[3]) * win
    y = dsp.ola_raw(frames, fft_size, hop, win)
    if center:
        y = y[..., fft_size // 2:]
    return y[..., :hop * F]
