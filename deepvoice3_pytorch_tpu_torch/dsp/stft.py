# coding: utf-8
"""DSP helpers for feature extraction and waveform inversion, counterpart of
deepvoice3_pytorch_tpu/dsp/stft.py.

Host-side constants (windows, mel basis, DFT matrices) are the JAX
package's numpy code; the tensor functions take and return torch tensors on
any device. Two framings: "lws" (causal frames over a zero tail pad,
`lws_pad`) and "center" (reflect-padded by fft // 2 on both sides). The
Griffin-Lim of kernel B2 (hop | fft) lives in dsp/gl_cuda.py; `griffin_lim`
here is the JAX package's XLA loop for any hop, in plain PyTorch.
"""

import math

import numpy as np
import torch


# ---------------------------------------------------------------------------
# windows / mel basis (host-side constants)
# ---------------------------------------------------------------------------


def hann_window(n, dtype=np.float32):
    """Periodic Hann (scipy.signal.get_window('hann', n))."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(dtype)


def sqrt_hann_window(n, dtype=np.float32):
    """The centred framing's analysis / synthesis window."""
    return np.sqrt(hann_window(n, np.float64)).astype(dtype)


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
# framing / forward STFT / inverse STFT
# ---------------------------------------------------------------------------


def lws_num_frames(length, hop):
    """ceil(length / hop): every sample covered, no centering."""
    return -(-length // hop)


def num_frames(length, fft_size, hop):
    """Frame count of a centred STFT over a length-`length` signal."""
    del fft_size
    return 1 + length // hop


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


def reflect_pad(x, pad):
    """Reflect-pad the last axis by `pad` on both sides, for any length: a
    pad longer than the signal keeps reflecting (np.pad's and jnp.pad's
    mode="reflect"; torch's reflect pad needs pad < length). A gather, so it
    runs on any device and any number of leading axes."""
    T = x.shape[-1]
    i = torch.arange(-pad, T + pad, device=x.device)
    if T == 1:
        i = torch.zeros_like(i)
    else:
        period = 2 * (T - 1)
        i = torch.remainder(i, period)
        i = torch.where(i >= T, period - i, i)
    return x[..., i]


def frame(x, fft_size, hop, center=False):
    """(..., T) -> (..., n_frames, fft_size) views; center reflect-pads by
    fft_size // 2 on both sides first (librosa-style)."""
    if center:
        x = reflect_pad(x, fft_size // 2)
    return x.unfold(-1, fft_size, hop)


def stft(x, fft_size, hop, window, center=False):
    """(..., T) -> complex (..., n_frames, fft_size//2+1). center=False:
    causal frames of an already padded signal (lws_pad, or a reflect pad
    applied per utterance by the caller); center=True: the centred framing
    (n_frames = 1 + T // hop)."""
    frames = frame(x, fft_size, hop, center) * window
    return torch.fft.rfft(frames, n=fft_size, dim=-1)


def overlap_add(frames, fft_size, hop):
    """(..., n_frames, fft_size) -> (..., (n_frames - 1) * hop + fft_size):
    frame i added at sample i * hop. hop | fft_size: k shifted block adds in
    frame-chunk order (the JAX package's reshape branch); any other hop: a
    fold (col2im: each output sample sums its frames in one thread, so the
    card's sums are deterministic)."""
    *lead, n, _ = frames.shape
    if fft_size % hop == 0:
        k = fft_size // hop
        chunks = frames.reshape(*lead, n, k, hop)
        y = frames.new_zeros(*lead, n + k - 1, hop)
        for c in range(k):
            y[..., c:c + n, :] += chunks[..., :, c, :]
        return y.reshape(*lead, (n + k - 1) * hop)
    T = (n - 1) * hop + fft_size
    cols = frames.reshape(-1, n, fft_size).transpose(1, 2)
    y = torch.nn.functional.fold(cols, (1, T), (1, fft_size),
                                 stride=(1, hop))
    return y.reshape(*lead, T)


def ola_raw(frames, fft_size, hop, window):
    """Overlap-add of windowed frames divided by the overlap-add of the
    squared window (at least 1e-8), untrimmed: frame i covers samples
    [i * hop, i * hop + fft_size). window: a tensor on the frames' device."""
    y = overlap_add(frames, fft_size, hop)
    wsq = (window * window).expand(frames.shape[-2], fft_size)
    norm = overlap_add(wsq, fft_size, hop)
    return y / torch.clamp_min(norm, 1e-8)


def istft(spec, fft_size, hop, window, length=None, center=False):
    """Inverse STFT: complex (..., n_frames, fft_size//2+1) -> (..., T),
    windowed overlap-add over the squared window's. center=True drops the
    fft_size // 2 samples of the centred analysis padding; center=False is
    the lws framing (sample 0 = frame 0, tap 0). T is `length`, else
    hop * n_frames."""
    frames = torch.fft.irfft(spec, n=fft_size, dim=-1) * window
    y = ola_raw(frames, fft_size, hop, window)
    if center:
        y = y[..., fft_size // 2:]
    return y[..., :hop * spec.shape[-2] if length is None else length]


# ---------------------------------------------------------------------------
# SPSI phase start
# ---------------------------------------------------------------------------


def _interpolated_bins(m):
    """k + p: each bin's index plus the parabolic peak offset p in [-1/2,
    1/2] of its magnitude triplet (0 where the triplet is flat)."""
    left = torch.cat([m[..., :1], m[..., :-1]], dim=-1)
    right = torch.cat([m[..., 1:], m[..., -1:]], dim=-1)
    denom = left - 2.0 * m + right
    big = torch.abs(denom) > 1e-12
    p = torch.where(big, 0.5 * (left - right)
                    / torch.where(big, denom, torch.ones_like(denom)),
                    torch.zeros_like(denom))
    p = torch.clamp(p, -0.5, 0.5)
    return torch.arange(m.shape[-1], dtype=m.dtype, device=m.device) + p


def spsi_phase(magnitude, fft_size, hop):
    """Initial Griffin-Lim phase: each bin's instantaneous frequency by
    parabolic interpolation of the magnitude triplet around it, integrated
    hop * omega per frame (frame-relative convention).

    The per-frame increments are wrapped mod 2 pi before the frame cumsum,
    as the Pallas kernel does (dsp/gl_pallas.py) and unlike the JAX XLA
    loop's `spsi_phase`: cos/sin are unchanged, and the running phase stays
    small enough to keep its f32 precision. The cumsum accumulates in f64
    and rounds each frame's phase to f32, on every device: what torch's CPU
    cumsum of f32 does, and what kernel B2 does (csrc/griffin_lim.cu).
    magnitude (..., n, F) f32."""
    kp = _interpolated_bins(magnitude)
    omega = (2.0 * np.pi * hop / fft_size) * kp               # rad / frame
    two_pi = float(np.float32(2.0 * np.pi))
    # divided by a tensor: by a Python number the card multiplies by the
    # reciprocal, and the floor of a quotient near an integer would differ
    # from the CPU's (and the kernel's) by one turn
    omega = omega - two_pi * torch.floor(
        omega / torch.full_like(omega[..., :1, :1], two_pi))
    return torch.cumsum(omega.double(), dim=-2).to(omega.dtype)


def spsi_phase_unwrapped(magnitude, fft_size, hop):
    """The JAX package's XLA-loop SPSI start (its `stft.spsi_phase`): the
    same interpolated per-bin frequencies as `spsi_phase`, integrated
    without the wrap mod 2 pi, hop * omega summed over frames (in f64,
    rounded to f32 per frame, on every device)."""
    omega = 2.0 * np.pi * _interpolated_bins(magnitude) / fft_size
    return torch.cumsum((hop * omega).double(), dim=-2).to(magnitude.dtype)


# ---------------------------------------------------------------------------
# Griffin-Lim for any hop (the JAX package's XLA loop)
# ---------------------------------------------------------------------------

CARRIES = ("bf16", "f32")


def griffin_lim_mats(fft_size, window, device=None, carry="bf16"):
    """The loop's DFT operands: the analysis window on the forward rows,
    the synthesis window on the inverse columns, folded in f32; for the
    bf16 carry rounded to bf16 once (what `gl_cuda.gl_mats` gives), for the
    f32 one kept in f32 (JAX folds its f32 `dft_mats` the same way)."""
    if carry not in CARRIES:
        raise ValueError("carry must be one of %s, got %r" % (CARRIES, carry))
    w = torch.from_numpy(np.asarray(window, np.float32))
    m0, m1, m2, m3 = (torch.from_numpy(m) for m in dft_mats(fft_size))
    dtype = torch.bfloat16 if carry == "bf16" else torch.float32
    return tuple(m.to(dtype).to(device) for m in (
        m0 * w[:, None], m1 * w[:, None], m2 * w[None, :], m3 * w[None, :]))


def griffin_lim(magnitude, fft_size, hop, window, *, n_iters=16,
                momentum=0.9, phase_init="spsi", center=False, length=None,
                mats=None, init_spec=None, pinned_prefix=None,
                return_spec=False, carry="bf16"):
    """Momentum Griffin-Lim for any hop, on any device: the JAX package's
    `stft.griffin_lim`, in one of the two schedules its callers run.

    carry="bf16": the batch vocoder's (its shipped griffin_lim_carry_dtype
    "bfloat16", no matmul dtype): the carry, the synthesised frames and the
    re-framed signal in bf16, every DFT product a bf16 x bf16 matmul summed
    in f32, momentum and the magnitude projection in f32, the last
    synthesis in f32. Overlap-add is `overlap_add` (a fold when hop does
    not divide fft_size), summed in f32 and rounded to bf16 once.
    carry="f32": the stream vocoder's (JAX's `StreamingVocoder` passes no
    carry or matmul dtype): everything in f32, f32 products on f32
    matrices. On the card the f32 products need TF32 off, torch's default
    (`ops.core.strict_numerics` keeps it off; nothing in the package turns
    it on).

    The loop re-frames the untrimmed overlap-add signal, so it is the same
    for both framings: center only picks the trim (True drops fft_size // 2
    samples).

    magnitude (..., n, F); window numpy (fft,); phase_init "spsi" (the
    unwrapped start, `spsi_phase_unwrapped`) or "zero"; mats:
    `griffin_lim_mats(..., carry=carry)` on the magnitudes' device.
    init_spec=(re, im), shaped like the magnitudes: an explicit start
    (overrides phase_init), the magnitudes re-imposed on it. pinned_prefix=
    (re, im), each (..., n_pin, F): the first n_pin frames are set to it
    after every iteration (a stream window's already-played context).
    Returns (..., T), and with return_spec (waveform, (re, im)) with the
    final carry in f32."""
    if phase_init not in ("spsi", "zero"):
        raise ValueError("phase_init must be 'spsi' or 'zero'")
    if carry not in CARRIES:
        raise ValueError("carry must be one of %s, got %r" % (CARRIES, carry))
    S = magnitude.float()
    if init_spec is not None and any(
            tuple(a.shape) != tuple(S.shape) for a in init_spec):
        raise ValueError("griffin_lim: init_spec must be shaped like the "
                         "magnitudes %s" % (tuple(S.shape),))
    dev = S.device
    if mats is None:
        mats = griffin_lim_mats(fft_size, window, dev, carry)
    if carry == "f32" and any(m.dtype != torch.float32 for m in mats):
        raise ValueError("griffin_lim: the f32 carry takes f32 mats "
                         "(griffin_lim_mats(..., carry='f32'))")
    lp = (lambda a: a.to(torch.bfloat16)) if carry == "bf16" \
        else (lambda a: a)       # the carry's rounding
    m_fwd_re, m_fwd_im, m_inv_re, m_inv_im = (m.float() for m in mats)
    win = torch.from_numpy(np.asarray(window, np.float32)).to(dev)
    n = S.shape[-2]
    wsq = (win * win).expand(n, fft_size)
    inv_norm = 1.0 / torch.clamp_min(overlap_add(wsq, fft_size, hop), 1e-8)
    inv_norm_c = lp(inv_norm).float()
    eps = 1e-16

    def synth(c_re, c_im):
        return c_re.float() @ m_inv_re + c_im.float() @ m_inv_im

    def project(c_re, c_im):
        frames = lp(synth(c_re, c_im)).float()
        ola = lp(overlap_add(frames, fft_size, hop)).float()
        f2 = lp(ola * inv_norm_c).float().unfold(-1, fft_size, hop)
        return f2 @ m_fwd_re, f2 @ m_fwd_im

    if pinned_prefix is not None:
        pin_re, pin_im = (a.float() for a in pinned_prefix)
        n_pin = pin_re.shape[-2]

        def pin(re, im):
            return (torch.cat([pin_re, re[..., n_pin:, :]], dim=-2),
                    torch.cat([pin_im, im[..., n_pin:, :]], dim=-2))
    else:
        def pin(re, im):
            return re, im

    if init_spec is not None:
        i_re, i_im = (a.float() for a in init_spec)
        mag0 = torch.clamp_min(torch.sqrt(i_re * i_re + i_im * i_im), eps)
        c_re, c_im = lp(S * i_re / mag0), lp(S * i_im / mag0)
    elif phase_init == "spsi":
        phi = spsi_phase_unwrapped(S, fft_size, hop)
        c_re, c_im = lp(S * torch.cos(phi)), lp(S * torch.sin(phi))
    else:
        c_re, c_im = lp(S), lp(torch.zeros_like(S))
    tp_re = tp_im = lp(torch.zeros_like(S))
    for _ in range(n_iters):
        t_re, t_im = project(c_re, c_im)
        a_re = t_re + momentum * (t_re - tp_re.float())
        a_im = t_im + momentum * (t_im - tp_im.float())
        mag = torch.clamp_min(torch.sqrt(a_re * a_re + a_im * a_im), eps)
        c_re, c_im = pin(S * a_re / mag, S * a_im / mag)
        c_re, c_im = lp(c_re), lp(c_im)
        tp_re, tp_im = lp(t_re), lp(t_im)
    y = overlap_add(synth(c_re, c_im), fft_size, hop) * inv_norm
    if center:
        y = y[..., fft_size // 2:]
    y = y[..., :hop * n if length is None else length]
    if return_spec:
        return y, (c_re.float(), c_im.float())
    return y


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


def inv_preemphasis_carry(x, coef, y_prev):
    """Streaming inv_preemphasis: continue the IIR from the carry y_prev (the
    last output sample of the previous chunk, shape x.shape[:-1]), for
    callers that keep the signal on the device. The chunk's solution is its
    zero-state response plus the zero-input response y_prev * coef**(t+1).
    Returns (y, new carry)."""
    T = x.shape[-1]
    y = inv_preemphasis(x, coef)
    decay = coef ** torch.arange(1, T + 1, dtype=x.dtype, device=x.device)
    y = y + y_prev[..., None] * decay
    return y, y[..., -1]
