# coding: utf-8
"""The consistency kernels of local-weighted-sums phase retrieval, in numpy
float64: the part of deepvoice3_pytorch_tpu/dsp/reference_model.py that
dsp/lws_phase.py needs (`consistency_kernels` and what it calls), the same
code, so the kernels are the same bits.

Conventions of the lws package's STFT: the analysis window is the sqrt of
a symmetric Hann scaled so that the steady-state overlap-add of its square
is 1; frame i covers samples [i * hop, i * hop + fft) of a zero-padded
signal; ceil(T / hop) frames.
"""

import numpy as np


def analysis_window(fft_size, hop):
    """sqrt(symmetric Hann) normalized so steady-state OLA(w^2) == 1."""
    n = np.arange(fft_size)
    a = np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * n / (fft_size - 1)))
    t0 = fft_size // 2
    k = fft_size // hop
    c = sum(a[t0 - j * hop] ** 2 for j in range(-k + 1, k)
            if 0 <= t0 - j * hop < fft_size)
    return a / np.sqrt(c)


def _frame_count(T, hop):
    return int(np.ceil(T / hop))


def _pad_for_frames(x, n_frames, fft_size, hop):
    need = (n_frames - 1) * hop + fft_size
    return np.concatenate([x, np.zeros(need - len(x))]) if need > len(x) \
        else x[:need]


def _stft_full(x, fft_size, hop, window):
    """Full-spectrum STFT in the absolute-phase convention used for the
    consistency-kernel analysis:
    S~[n,m] = sum_u x(u) a(u-nH) e^{-2pi i mu/N}."""
    F = _frame_count(len(x), hop)
    xp = _pad_for_frames(np.asarray(x, np.complex128), F, fft_size, hop)
    frames = np.stack([xp[i * hop:i * hop + fft_size] for i in range(F)])
    S = np.fft.fft(frames * window, axis=-1)
    m = np.arange(fft_size)[None, :]
    n = np.arange(F)[:, None]
    return S * np.exp(-2j * np.pi * m * (n * hop) / fft_size)


def _istft_full(S, fft_size, hop, T, window):
    F = S.shape[0]
    m = np.arange(fft_size)[None, :]
    n = np.arange(F)[:, None]
    frames = np.fft.ifft(S * np.exp(2j * np.pi * m * (n * hop) / fft_size),
                         axis=-1)
    need = (F - 1) * hop + fft_size
    y = np.zeros(need, np.complex128)
    norm = np.zeros(need)
    for i in range(F):
        y[i * hop:i * hop + fft_size] += frames[i] * window
        norm[i * hop:i * hop + fft_size] += window ** 2
    return (y / np.maximum(norm, 1e-12))[:T]


def consistency_kernels(fft_size, hop, window=None, dm_max=4):
    """Numerically extract the LOCAL spectrogram-consistency kernels: the
    linear operator G = STFT o iSTFT restricted to a (2k-1) x (2*dm_max+1)
    neighborhood. G is a twisted convolution — the kernel depends on the
    SOURCE frame index mod k (k = fft/hop): K_r[dn, dm] with
    (G S)[n, m] = sum_{dn,dm} K_{(n-dn) mod k}[dn, dm] * S[n-dn, m-dm]
    (m circular over the full spectrum). Extraction is exact by linearity
    (impulse responses at interior positions).

    Returns complex (k, 2k-1, 2*dm_max+1)."""
    if window is None:
        window = analysis_window(fft_size, hop)
    k = fft_size // hop
    dn_max = k - 1
    Fn = 6 * k          # enough interior frames
    T = hop * Fn - hop // 2   # hop does not divide T: frame count exact
    m0 = fft_size // 3
    kers = np.zeros((k, 2 * dn_max + 1, 2 * dm_max + 1), np.complex128)
    for r in range(k):
        n0 = 3 * k + r
        Z = np.zeros((Fn, fft_size), np.complex128)
        Z[n0, m0] = 1.0
        G = _stft_full(_istft_full(Z, fft_size, hop, T, window),
                       fft_size, hop, window)
        for dn in range(-dn_max, dn_max + 1):
            for dm in range(-dm_max, dm_max + 1):
                kers[r, dn + dn_max, dm + dm_max] = \
                    G[n0 + dn, (m0 + dm) % fft_size]
    return kers
