# coding: utf-8
"""DSP helpers for feature extraction and waveform inversion, counterpart of
deepvoice3_pytorch_tpu/dsp/stft.py.

Host-side constants (windows, mel basis, DFT matrices) are the JAX
package's numpy code; the tensor functions take and return torch tensors on
any device. The Griffin-Lim loop itself lives in dsp/gl_cuda.py.
"""

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# windows / mel basis (host-side constants)
# ---------------------------------------------------------------------------


def hann_window_symmetric(n, dtype=np.float64):
    """Symmetric Hann (np.hanning: zeros at both endpoints)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n - 1))) \
        .astype(dtype)


def lws_hann_window(n, hop, dtype=np.float32):
    """LWS-convention window: sqrt of a symmetric Hann, scaled so the
    steady-state overlap-add of its square is 1."""
    a = np.sqrt(hann_window_symmetric(n, np.float64))
    t0 = n // 2
    k = n // hop
    c = sum(a[t0 - j * hop] ** 2 for j in range(-k + 1, k)
            if 0 <= t0 - j * hop < n)
    return (a / np.sqrt(c)).astype(dtype)


def _hz_to_mel(f):
    """Slaney mel scale (librosa htk=False default)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz)
                    / logstep, f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_basis(sample_rate, fft_size, n_mels=80, fmin=125, fmax=7600,
              dtype=np.float32):
    """Slaney-normalized triangular mel filterbank (n_mels, n_freqs),
    librosa.filters.mel defaults."""
    if fmax is None:
        fmax = sample_rate / 2
    n_freqs = fft_size // 2 + 1
    fftfreqs = np.linspace(0.0, sample_rate / 2.0, n_freqs)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(dtype)


def dft_mats(fft_size, dtype=np.float32):
    """(fwd_re, fwd_im) (fft, n_bins) and (inv_re, inv_im) (n_bins, fft) as
    numpy arrays: rfft and, for a Hermitian spectrum, irfft as matmuls."""
    n = np.arange(fft_size)[:, None].astype(np.float64)
    k = np.arange(fft_size // 2 + 1)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * n * k / fft_size
    n_bins = fft_size // 2 + 1
    w = np.full((n_bins, 1), 2.0)
    w[0, 0] = 1.0
    if fft_size % 2 == 0:
        w[-1, 0] = 1.0
    inv_ang = 2.0 * np.pi * k.T * n.T / fft_size
    return (np.cos(ang).astype(dtype), np.sin(ang).astype(dtype),
            (w * np.cos(inv_ang) / fft_size).astype(dtype),
            (-w * np.sin(inv_ang) / fft_size).astype(dtype))


# ---------------------------------------------------------------------------
# framing / forward STFT (lws convention: causal frames, zero tail pad)
# ---------------------------------------------------------------------------


def lws_num_frames(length, hop):
    """ceil(length / hop): every sample covered, no centering."""
    return -(-length // hop)


def lws_pad(x, fft_size, hop):
    """Zero-pad the tail so causal framing covers ceil(T/hop) frames. Works
    on numpy arrays or tensors."""
    T = x.shape[-1]
    need = (lws_num_frames(T, hop) - 1) * hop + fft_size
    if need <= T:
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, need - T)])
    return torch.nn.functional.pad(x, (0, need - T))


def stft(x, fft_size, hop, window):
    """(..., T) -> complex (..., n_frames, fft_size//2+1): causal frames of
    an already padded signal (lws_pad)."""
    frames = x.unfold(-1, fft_size, hop) * window
    return torch.fft.rfft(frames, n=fft_size, dim=-1)


# ---------------------------------------------------------------------------
# SPSI phase start
# ---------------------------------------------------------------------------


def spsi_phase(magnitude, fft_size, hop):
    """Initial Griffin-Lim phase: each bin's instantaneous frequency by
    parabolic interpolation of the magnitude triplet around it, integrated
    hop * omega per frame (frame-relative convention).

    The per-frame increments are wrapped mod 2 pi before the frame cumsum,
    as the Pallas kernel does (dsp/gl_pallas.py) and unlike the JAX XLA
    loop's `spsi_phase`: cos/sin are unchanged, and the running phase stays
    small enough to keep its f32 precision. magnitude (..., n, F) f32."""
    m = magnitude
    left = torch.cat([m[..., :1], m[..., :-1]], dim=-1)
    right = torch.cat([m[..., 1:], m[..., -1:]], dim=-1)
    denom = left - 2.0 * m + right
    big = torch.abs(denom) > 1e-12
    p = torch.where(big, 0.5 * (left - right)
                    / torch.where(big, denom, torch.ones_like(denom)),
                    torch.zeros_like(denom))
    p = torch.clamp(p, -0.5, 0.5)
    k = torch.arange(m.shape[-1], dtype=m.dtype, device=m.device)
    omega = (2.0 * np.pi * hop / fft_size) * (k + p)          # rad / frame
    two_pi = float(np.float32(2.0 * np.pi))
    omega = omega - two_pi * torch.floor(omega / two_pi)
    return torch.cumsum(omega, dim=-2)


# ---------------------------------------------------------------------------
# dB / normalization helpers (reference audio.py:79-93)
# ---------------------------------------------------------------------------


def amp_to_db(x, min_level_db=-100.0):
    min_level = math.exp(min_level_db / 20.0 * math.log(10.0))
    return 20.0 * torch.log10(torch.clamp_min(x, min_level))


def normalize(S, min_level_db=-100.0):
    return torch.clamp((S - min_level_db) / -min_level_db, 0.0, 1.0)


def db_to_amp(x):
    return torch.pow(10.0, x * 0.05)


def denormalize(S, min_level_db=-100.0):
    return (torch.clamp(S, 0.0, 1.0) * -min_level_db) + min_level_db


# ---------------------------------------------------------------------------
# pre-emphasis and its inverse
# ---------------------------------------------------------------------------


def preemphasis(x, coef=0.97):
    """y[n] = x[n] - coef * x[n-1]."""
    return x - coef * torch.nn.functional.pad(x[..., :-1], (1, 0))


def inv_preemphasis(x, coef=0.97):
    """y[n] = x[n] + coef * y[n-1], solved in ceil(log2 T) shifted
    multiply-adds (Hillis-Steele scan of the affine maps y -> a*y + x)."""
    y = x.clone()
    a = torch.full_like(x, coef)
    d = 1
    T = x.shape[-1]
    while d < T:
        y[..., d:] = y[..., d:] + a[..., d:] * y[..., :-d]
        a[..., d:] = a[..., d:] * a[..., :-d]
        d *= 2
    return y
