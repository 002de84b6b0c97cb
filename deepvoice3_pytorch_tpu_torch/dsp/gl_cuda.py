# coding: utf-8
"""Griffin-Lim phase retrieval: kernel B2, counterpart of
deepvoice3_pytorch_tpu/dsp/gl_pallas.py, and of the probe kernel of
tools/gl_pallas2_probe.py (`fold_windows=False`).

`griffin_lim` dispatches on the device of the magnitudes:
  * CPU  -> `griffin_lim_plain`, the kernel's schedule in plain PyTorch;
  * CUDA -> the hand-written kernels of `csrc/griffin_lim.cu`; nothing
    falls back.

Both follow the Pallas kernel's numerics, not the JAX XLA loop's: bf16
operands with f32 accumulation, f32 overlap-add times the pre-inverted
normaliser, bf16 re-framed chunks, momentum in f32 against the bf16 previous
projection, projection by rsqrt(a^2 + 1e-30), bf16 carries, and SPSI
increments wrapped mod 2 pi before the frame cumsum. Framing needs
hop | fft_size; other hops raise.

Options, as `griffin_lim_pallas` has them:
  * fold_windows (default True): the windows folded into the bf16 DFT
    matrices. False is the probe's schedule: plain bf16 DFT matrices, the
    synthesis window on each f32 frame chunk before overlap-add, the
    analysis window on the f32 overlap-add signal before the bf16 cast.
  * init_spec=(re, im): an explicit start, overriding phase_init; the
    magnitudes are re-imposed, c = bf16(i * S * rsqrt(|i|^2 + 1e-30)).
  * n_pinned: the first n_pinned frames of each item keep those start values
    through every iteration (needs init_spec).
  * return_spec: also return the final carry as f32 (re, im).
The kernel counts its launches by mode in `KERNEL.by_entry`: "batch",
"init" (init_spec), "pinned" (n_pinned > 0) and "unfolded".
"""

import ctypes
import functools
import math

import numpy as np
import torch

from .. import _build
from . import stft as dsp

INIT_CODES = {"zero": 0, "spsi": 1, "given": 2}   # csrc/griffin_lim.cu


def ola_norm(n_frames, fft_size, hop, window):
    """Squared-window overlap-add normaliser in (n+k-1, hop) block layout,
    pre-inverted (callers multiply)."""
    k = fft_size // hop
    norm = np.zeros((n_frames + k - 1, hop), np.float32)
    w2 = (window * window).reshape(k, hop)
    for c in range(k):
        norm[c:c + n_frames, :] += w2[c]
    return 1.0 / np.maximum(norm, 1e-8)


def gl_mats(fft_size, window, device=None, fold=True):
    """bf16 DFT matrices: (m0, m1) (fft, F) forward re/im, (m2, m3) (F, fft)
    inverse re/im. fold: the analysis window on the forward rows and the
    synthesis window on the inverse columns."""
    mats = [torch.from_numpy(m) for m in dsp.dft_mats(fft_size)]
    if fold:
        w = torch.from_numpy(np.asarray(window, np.float32))
        mats = (mats[0] * w[:, None], mats[1] * w[:, None],
                mats[2] * w[None, :], mats[3] * w[None, :])
    return tuple(m.to(torch.bfloat16).to(device) for m in mats)


def _check_shapes(magnitude, fft_size, hop):
    if fft_size % hop:
        raise ValueError("griffin_lim needs hop_size to divide fft_size "
                         "(got fft_size=%d hop_size=%d)" % (fft_size, hop))
    if magnitude.dim() != 3 or magnitude.shape[-1] != fft_size // 2 + 1:
        raise ValueError("griffin_lim expects (B, n, %d) magnitudes, got %s"
                         % (fft_size // 2 + 1, tuple(magnitude.shape)))


def _check_modes(magnitude, init_spec, n_pinned):
    if init_spec is not None and any(
            tuple(a.shape) != tuple(magnitude.shape) for a in init_spec):
        raise ValueError("griffin_lim: init_spec must be shaped like the "
                         "magnitudes %s" % (tuple(magnitude.shape),))
    if n_pinned and init_spec is None:
        raise ValueError("griffin_lim: n_pinned needs init_spec")
    if not 0 <= n_pinned <= magnitude.shape[1]:
        raise ValueError("griffin_lim: n_pinned=%d outside 0..%d"
                         % (n_pinned, magnitude.shape[1]))


def _mode(init_spec, n_pinned, fold_windows):
    """Launch-count key of a call."""
    if not fold_windows:
        return "unfolded"
    if n_pinned:
        return "pinned"
    return "batch" if init_spec is None else "init"


def griffin_lim(magnitude, fft_size, hop, window, *, n_iters=16,
                momentum=0.9, phase_init="spsi", mats=None, init_spec=None,
                n_pinned=0, return_spec=False, fold_windows=True):
    """(B, n, F) or (n, F) magnitudes -> (B, n * hop) / (n * hop,) waveform
    on the lws framing convention (sample 0 = frame 0, tap 0); with
    return_spec, (waveform, (re, im)) with the final (B, n, F) carry.

    window: numpy (fft,) analysis/synthesis window. mats: `gl_mats(...,
    fold=fold_windows)` on the magnitudes' device, built here when None."""
    squeeze = magnitude.dim() == 2
    if squeeze:
        magnitude = magnitude[None]
        if init_spec is not None:
            init_spec = tuple(a[None] for a in init_spec)
    if phase_init not in ("spsi", "zero"):
        raise ValueError("phase_init must be 'spsi' or 'zero'")
    _check_shapes(magnitude, fft_size, hop)
    _check_modes(magnitude, init_spec, n_pinned)
    if mats is None:
        mats = gl_mats(fft_size, window, magnitude.device, fold=fold_windows)
    kw = dict(n_iters=n_iters, momentum=momentum, phase_init=phase_init,
              mats=mats, init_spec=init_spec, n_pinned=n_pinned,
              return_spec=return_spec, fold_windows=fold_windows)
    dev = magnitude.device.type
    if dev == "cpu":
        res = griffin_lim_plain(magnitude, fft_size, hop, window, **kw)
    elif dev == "cuda":
        res = _griffin_lim_cuda(magnitude, fft_size, hop, window, **kw)
    else:
        raise ValueError("griffin_lim: unsupported device %s"
                         % magnitude.device)
    wav, spec = res if return_spec else (res, None)
    wav = wav[:, :hop * magnitude.shape[1]]
    if squeeze:
        wav = wav[0]
        spec = None if spec is None else tuple(a[0] for a in spec)
    return (wav, spec) if return_spec else wav


def griffin_lim_plain(magnitude, fft_size, hop, window, *, n_iters=16,
                      momentum=0.9, phase_init="spsi", mats=None,
                      init_spec=None, n_pinned=0, return_spec=False,
                      fold_windows=True):
    """Plain PyTorch version of the kernel. (B, n, F) -> untrimmed
    (B, (n + k - 1) * hop) overlap-add signal, and with return_spec the
    final carry (re, im) as f32. bf16 operands with f32 accumulation are
    emulated as `a.to(bfloat16).float() @ m.float()`."""
    _check_shapes(magnitude, fft_size, hop)
    _check_modes(magnitude, init_spec, n_pinned)
    bf16 = torch.bfloat16
    S = magnitude.float()
    B, n, F = S.shape
    k = fft_size // hop
    nb = n + k - 1
    if mats is None:
        mats = gl_mats(fft_size, window, S.device, fold=fold_windows)
    m0, m1, m2, m3 = (m.float() for m in mats)
    win_np = np.asarray(window, np.float32)
    inorm = torch.from_numpy(ola_norm(n, fft_size, hop, win_np)).to(S.device)
    win = torch.from_numpy(win_np.reshape(k, hop)).to(S.device)

    if init_spec is not None:
        i_re, i_im = (a.float() for a in init_spec)
        scale0 = S * torch.rsqrt(i_re * i_re + i_im * i_im + 1e-30)
        c_re, c_im = (i_re * scale0).to(bf16), (i_im * scale0).to(bf16)
        pin_re, pin_im = c_re[:, :n_pinned], c_im[:, :n_pinned]
    elif phase_init == "spsi":
        phi = dsp.spsi_phase(S, fft_size, hop)
        c_re, c_im = (S * torch.cos(phi)).to(bf16), (S * torch.sin(phi)).to(bf16)
    else:
        c_re, c_im = S.to(bf16), torch.zeros_like(S, dtype=bf16)
    tp_re = tp_im = torch.zeros_like(S, dtype=bf16)

    def synth(c_re, c_im):
        frames = c_re.float() @ m2 + c_im.float() @ m3       # (B, n, fft)
        y = torch.zeros(B, nb, hop, device=S.device)
        for c in range(k):
            chunk = frames[..., c * hop:(c + 1) * hop]
            y[:, c:c + n] += chunk if fold_windows else chunk * win[c]
        return y * inorm

    for _ in range(n_iters):
        y = synth(c_re, c_im)
        tre = torch.zeros_like(S)
        tim = torch.zeros_like(S)
        for c in range(k):
            chunk = y[:, c:c + n]
            if not fold_windows:
                chunk = chunk * win[c]
            chunk = chunk.to(bf16).float()
            tre = tre + chunk @ m0[c * hop:(c + 1) * hop]
            tim = tim + chunk @ m1[c * hop:(c + 1) * hop]
        a_re = tre + momentum * (tre - tp_re.float())
        a_im = tim + momentum * (tim - tp_im.float())
        scale = S * torch.rsqrt(a_re * a_re + a_im * a_im + 1e-30)
        c_re, c_im = (a_re * scale).to(bf16), (a_im * scale).to(bf16)
        if n_pinned:
            c_re = torch.cat([pin_re, c_re[:, n_pinned:]], dim=1)
            c_im = torch.cat([pin_im, c_im[:, n_pinned:]], dim=1)
        tp_re, tp_im = tre.to(bf16), tim.to(bf16)
    wav = synth(c_re, c_im).reshape(B, nb * hop)
    if return_spec:
        return wav, (c_re.float(), c_im.float())
    return wav


# ---------------------------------------------------------------------------
# kernel binding
# ---------------------------------------------------------------------------


class _Args(ctypes.Structure):
    """Mirror of GriffinLimArgs in csrc/griffin_lim.cu."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "S", "inorm", "synT", "anaT", "win", "init_re", "init_im", "c", "tp",
        "pin", "frames", "y", "out", "spec_re", "spec_im")]
        + [(n, ctypes.c_int) for n in (
            "B", "n", "F", "fft", "hop", "Kp", "Np", "n_iters", "init",
            "n_pinned", "fold")]
        + [("momentum", ctypes.c_float), ("omega_scale", ctypes.c_float)])


KERNEL = _build.Kernel("griffin_lim.cu", {
    "dv3_griffin_lim": [ctypes.POINTER(_Args), ctypes.c_void_p, ctypes.c_int],
})


@functools.lru_cache(maxsize=64)
def _device_consts(fft_size, hop, n, window_bytes, device):
    """(window, inverse overlap-add normaliser) on the card, uploaded once
    per shape: a blocking upload would wait for the stream's earlier work.
    The kernel only reads them."""
    win_np = np.frombuffer(window_bytes, np.float32).copy()
    return (torch.from_numpy(win_np).to(device), torch.from_numpy(
        ola_norm(n, fft_size, hop, win_np)).to(device))


def _round_up(v, m):
    return -(-v // m) * m


def _ptr(t):
    return None if t is None else t.data_ptr()


def _griffin_lim_cuda(magnitude, fft_size, hop, window, *, n_iters, momentum,
                      phase_init, mats, init_spec, n_pinned, return_spec,
                      fold_windows):
    if fft_size % 64 or hop % 4:
        raise ValueError("the CUDA Griffin-Lim needs fft_size % 64 == 0 and "
                         "hop % 4 == 0 (got %d, %d)" % (fft_size, hop))
    dev = magnitude.device
    bf16 = torch.bfloat16
    S = magnitude.float().contiguous()
    B, n, F = S.shape
    if B * n * max(2 * F, fft_size) >= 2 ** 31:
        raise ValueError("griffin_lim: batch too large for 32-bit indexing")
    for m, shape in zip(mats, ((fft_size, F), (fft_size, F),
                               (F, fft_size), (F, fft_size))):
        if m.device != dev or m.dtype != bf16 or tuple(m.shape) != shape:
            raise ValueError("griffin_lim: mats must be gl_mats(...) on %s"
                             % dev)
    k = fft_size // hop
    nb = n + k - 1
    M = B * n
    Kp = _round_up(2 * F, 32)
    Np = _round_up(2 * F, 64)
    m0, m1, m2, m3 = mats
    # B operands transposed (K contiguous), re/im interleaved per bin
    synT = torch.zeros(fft_size, Kp, dtype=bf16, device=dev)
    synT[:, 0:2 * F:2] = m2.t()
    synT[:, 1:2 * F:2] = m3.t()
    anaT = torch.zeros(Np, fft_size, dtype=bf16, device=dev)
    anaT[0:2 * F:2] = m0.t()
    anaT[1:2 * F:2] = m1.t()
    win, inorm = _device_consts(fft_size, hop, n, np.asarray(
        window, np.float32).tobytes(), str(dev))
    init_re = init_im = pin = spec_re = spec_im = None
    if init_spec is not None:
        init_re, init_im = (a.to(dev, torch.float32).contiguous()
                            for a in init_spec)
        if n_pinned:
            pin = torch.empty(B, n_pinned, 2 * F, dtype=bf16, device=dev)
    if return_spec:
        spec_re, spec_im = torch.empty_like(S), torch.empty_like(S)
    c = torch.zeros(M, Kp, dtype=bf16, device=dev)
    tp = torch.zeros(M, 2 * F, dtype=bf16, device=dev)
    frames = torch.empty(M, fft_size, device=dev)
    y = torch.empty(B, nb, hop, device=dev)
    out = torch.empty(B, nb, hop, device=dev)
    init = "given" if init_spec is not None else phase_init
    args = _Args(S.data_ptr(), inorm.data_ptr(), synT.data_ptr(),
                 anaT.data_ptr(), win.data_ptr(), _ptr(init_re),
                 _ptr(init_im), c.data_ptr(), tp.data_ptr(), _ptr(pin),
                 frames.data_ptr(), y.data_ptr(), out.data_ptr(),
                 _ptr(spec_re), _ptr(spec_im),
                 B, n, F, fft_size, hop, Kp, Np, n_iters, INIT_CODES[init],
                 n_pinned, int(fold_windows), momentum,
                 2.0 * math.pi * hop / fft_size)
    lib = KERNEL.lib
    rc = lib.dv3_griffin_lim(ctypes.byref(args),
                             torch.cuda.current_stream(dev).cuda_stream,
                             dev.index or 0)
    KERNEL.launched(_mode(init_spec, n_pinned, fold_windows))
    KERNEL.check(rc, "griffin_lim launch")
    wav = out.reshape(B, nb * hop)
    return (wav, (spec_re, spec_im)) if return_spec else wav
