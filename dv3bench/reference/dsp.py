# coding: utf-8
"""Griffin-Lim and the STFT in plain PyTorch: a frozen copy of the port's
plain versions (deepvoice3_pytorch_tpu_torch/dsp/stft.py) for the lws
framing, the bf16-carry batch schedule the configuration states, and the
spectral convergence that judges a waveform against the magnitudes it was
made from."""

import numpy as np
import torch

CARRIES = ("bf16", "f32", "fp8")
# the carry's rounding type; "fp8" (e4m3) is the control's, one precision
# below the bf16 the configuration states
_CARRY_DTYPE = {"bf16": torch.bfloat16, "f32": torch.float32,
                "fp8": torch.float8_e4m3fn}


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


def frame(x, fft_size, hop):
    """(..., T) -> (..., n_frames, fft_size) views (lws framing)."""
    return x.unfold(-1, fft_size, hop)


def stft(x, fft_size, hop, window):
    """(..., T) of an lws_pad-ded signal -> complex (..., n_frames,
    fft_size // 2 + 1)."""
    return torch.fft.rfft(frame(x, fft_size, hop) * window, n=fft_size,
                          dim=-1)


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

CARRIES = ("bf16", "f32", "fp8")
# the carry's rounding type; "fp8" (e4m3) is the control's, one precision
# below the bf16 the configuration states
_CARRY_DTYPE = {"bf16": torch.bfloat16, "f32": torch.float32,
                "fp8": torch.float8_e4m3fn}


def griffin_lim_mats(fft_size, window, device=None, carry="bf16"):
    """The loop's DFT operands: the analysis window on the forward rows,
    the synthesis window on the inverse columns, folded in f32; for the
    bf16 carry rounded to bf16 once (what `gl_cuda.gl_mats` gives), for the
    f32 one kept in f32 (JAX folds its f32 `dft_mats` the same way)."""
    if carry not in CARRIES:
        raise ValueError("carry must be one of %s, got %r" % (CARRIES, carry))
    w = torch.from_numpy(np.asarray(window, np.float32))
    m0, m1, m2, m3 = (torch.from_numpy(m) for m in dft_mats(fft_size))
    dtype = _CARRY_DTYPE[carry]
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
    dtype = _CARRY_DTYPE[carry]
    lp = (lambda a: a.to(dtype)) if dtype != torch.float32 \
        else (lambda a: a)       # the carry's rounding
    if carry == "fp8":           # saturating, as an fp8 GEMM's operands
        lp = (lambda a: a.clamp(-448.0, 448.0).to(dtype))
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


def db_to_amp(x):
    return torch.pow(10.0, x * 0.05)


def denormalize(S, min_level_db=-100.0):
    return (torch.clamp(S, 0.0, 1.0) * -min_level_db) + min_level_db


def preemphasis(x, coef=0.97):
    """y[n] = x[n] - coef * x[n-1]."""
    return x - coef * torch.nn.functional.pad(x[..., :-1], (1, 0))


def magnitudes(linear_db, hp):
    """The linear spectrogram in dB (B, n, F) -> the magnitudes Griffin-Lim
    is given: db_to_amp(dB + ref_level_db) ** power."""
    return db_to_amp(linear_db + hp["ref_level_db"]) ** hp["power"]


def spectral_convergence(wav, S, hp, emphasised=True):
    """Per row, || |STFT(preemphasis(wav))| - S || / || S || over S's
    frames (lws framing): how well a waveform's spectrum meets the
    magnitudes it was retrieved from. wav (B, T), S (B, n, F)."""
    fft, hop = hp["fft_size"], hp["hop_size"]
    win = torch.from_numpy(lws_hann_window(fft, hop)).to(wav.device)
    x = wav.double()
    if emphasised:      # a waveform after inverse pre-emphasis
        x = preemphasis(x, hp["preemphasis"])
    x = lws_pad(x, fft, hop)
    M = torch.abs(stft(x, fft, hop, win.double()))[..., :S.shape[-2], :]
    S = S.double()
    return (torch.linalg.vector_norm(M - S, dim=(-2, -1))
            / torch.linalg.vector_norm(S, dim=(-2, -1)))


def griffin_lim_run(S, hp, carry="bf16"):
    """The configuration's Griffin-Lim on magnitudes S (B, n, F), before
    inverse pre-emphasis (which spectral_convergence undoes)."""
    fft, hop = hp["fft_size"], hp["hop_size"]
    window = lws_hann_window(fft, hop)
    return griffin_lim(S, fft, hop, window, n_iters=hp["griffin_lim_iters"],
                       momentum=hp["griffin_lim_momentum"],
                       phase_init=hp["griffin_lim_phase_init"],
                       mats=griffin_lim_mats(fft, window, S.device, carry),
                       carry=carry)
