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
increments wrapped mod 2 pi before the frame cumsum. The kernel takes every
shape the Pallas kernel takes, any hop that divides fft_size (`b2_takes`,
asked by every route choice); other hops raise (dsp/stft.py `griffin_lim`
takes them).
The iteration re-frames the untrimmed overlap-add signal, so it is the same
for both framings of dsp/audio.py: `center` picks only the final trim (the
lws framing keeps samples [0, hop n); the centred one drops the fft // 2
samples of its analysis padding first), and the window (the lws-normalised
sqrt of a symmetric Hann, or the centred framing's periodic sqrt-Hann)
reaches the kernel only through the folded DFT operands and the
pre-inverted overlap-add normaliser.

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
  * phase_init="anchored" with context_spec=(re, im) or None: the start of a
    streaming window (`anchored_start`), computed in the kernel; the context
    frames are pinned.
The kernel counts its launches by mode in `KERNEL.by_entry`: "batch",
"init" (a start without pinned frames), "pinned" (n_pinned > 0),
"unfolded" and "center" (any call with center=True); and by route in
`KERNEL.by_route`. Route and tiles come from the shape alone (`gl_plan`);
the DFT operands are built once per `mats` (`gl_operands`). `_griffin_lim_cuda` also takes a forced `plan` and a
`trace` of per-step stamps; only measurements use them. Its window route
with `one_launch=False` (a launch a step) is the alternative that the one
cooperative launch was measured against, and the card test's witness that
the one launch computes the same bits.
"""

import collections
import ctypes
import functools
import math
import threading

import numpy as np
import torch

from .. import _build
from . import stft as dsp

INIT_CODES = {"zero": 0, "spsi": 1, "given": 2,    # csrc/griffin_lim.cu
              "anchored": 3}
ROUTE_CODES = {"batch": 0, "window": 1}


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
    synthesis window on the inverse columns (`stft.griffin_lim_mats`)."""
    if fold:
        return dsp.griffin_lim_mats(fft_size, window, device)
    return tuple(torch.from_numpy(m).to(torch.bfloat16).to(device)
                 for m in dsp.dft_mats(fft_size))


def b2_takes(fft_size, hop):
    """True when kernel B2 (and its plain version) takes the framing: hop
    divides fft_size, at any k = fft_size / hop. The Pallas kernel's guard
    (`gl_pallas.fits_vmem`) asks the same of the shape; its VMEM budget has
    no counterpart on the H100, where only a batch past 32-bit indexing
    raises."""
    return hop > 0 and fft_size % hop == 0


def _check_shapes(magnitude, fft_size, hop):
    if not b2_takes(fft_size, hop):
        raise ValueError("griffin_lim needs hop_size to divide fft_size "
                         "(got fft_size=%d hop_size=%d)" % (fft_size, hop))
    if magnitude.dim() != 3 or magnitude.shape[-1] != fft_size // 2 + 1:
        raise ValueError("griffin_lim expects (B, n, %d) magnitudes, got %s"
                         % (fft_size // 2 + 1, tuple(magnitude.shape)))


def _check_modes(magnitude, init_spec, n_pinned, phase_init="spsi",
                 context_spec=None):
    if phase_init not in ("spsi", "zero", "anchored"):
        raise ValueError("phase_init must be 'spsi', 'zero' or 'anchored'")
    if init_spec is not None and any(
            tuple(a.shape) != tuple(magnitude.shape) for a in init_spec):
        raise ValueError("griffin_lim: init_spec must be shaped like the "
                         "magnitudes %s" % (tuple(magnitude.shape),))
    if n_pinned and init_spec is None:
        raise ValueError("griffin_lim: n_pinned needs init_spec")
    if not 0 <= n_pinned <= magnitude.shape[1]:
        raise ValueError("griffin_lim: n_pinned=%d outside 0..%d"
                         % (n_pinned, magnitude.shape[1]))
    if phase_init == "anchored" and init_spec is not None:
        raise ValueError("griffin_lim: the anchored start takes "
                         "context_spec, not init_spec")
    if context_spec is not None:
        if phase_init != "anchored":
            raise ValueError("griffin_lim: context_spec needs "
                             "phase_init='anchored'")
        B, n, F = magnitude.shape
        shape = tuple(context_spec[0].shape)
        if len(shape) != 3 or shape[0] != B or shape[2] != F or \
                not 0 < shape[1] <= n or \
                tuple(context_spec[1].shape) != shape:
            raise ValueError("griffin_lim: context_spec must be (B, n_ctx, F) "
                             "with 0 < n_ctx <= n, got %s" % (shape,))


def _mode(given, n_pinned, fold_windows, center=False):
    """Launch-count key of a call; given: a start other than zero or SPSI."""
    if center:
        return "center"
    if not fold_windows:
        return "unfolded"
    if n_pinned:
        return "pinned"
    return "init" if given else "batch"


def anchored_start(S, fft_size, hop, context_spec, unwrapped=False):
    """The start of a streaming window, in plain PyTorch: (i_re, i_im, n_ctx).
    S (B, n, F) f32 magnitudes; context_spec: the previous window's retrieved
    (re, im) of this window's first n_ctx frames, each (B, n_ctx, F), or None.
    The context frames start from it; the later frames get the SPSI phase
    shifted per bin so that it meets the retrieved phase of the last context
    frame: phi + atan2(pim[-1], pre[-1]) - phi[n_ctx - 1]. Without a context
    every frame gets the SPSI start. Griffin-Lim re-imposes the magnitudes on
    this start (the given-start rule) and pins the context frames.
    unwrapped: the SPSI phase of the JAX package's stream vocoder
    (`stft.spsi_phase_unwrapped`, for the general-hop loop) instead of
    B2's wrapped one."""
    phi = (dsp.spsi_phase_unwrapped if unwrapped else dsp.spsi_phase)(
        S, fft_size, hop)
    if context_spec is None:
        return S * torch.cos(phi), S * torch.sin(phi), 0
    pre, pim = context_spec
    n_ctx = pre.shape[1]
    delta = torch.atan2(pim[:, -1], pre[:, -1]) - phi[:, n_ctx - 1]
    phi = phi + delta[:, None, :]
    i_re = torch.cat([pre, (S * torch.cos(phi))[:, n_ctx:]], dim=1)
    i_im = torch.cat([pim, (S * torch.sin(phi))[:, n_ctx:]], dim=1)
    return i_re, i_im, n_ctx


# ---------------------------------------------------------------------------
# route choice and the cached DFT operands
# ---------------------------------------------------------------------------

SMS = 132   # streaming multiprocessors of the H100 the plan fills

# route: "batch" (128-row tiles, a launch a step) or "window" (64- or
# 128-row tiles, one persistent launch); bm: tile rows; bn_syn, bn_ana:
# synthesis and analysis tile columns; one_launch: the window route's steps
# in one cooperative launch (False: a launch a step)
Plan = collections.namedtuple("Plan", "route bm bn_syn bn_ana one_launch")


def frame_stride(fft_size):
    """Elements between rows of the kernel's frames and re-framed signal:
    fft_size rounded up to 64 (16-byte TMA rows for any fft; the synthesis
    tiles write the zero columns past fft_size, and nothing reads them)."""
    return _round_up(fft_size, 64)


def gl_plan(B, n, fft_size, hop):
    """Route and tiles of a (B, n, F) retrieval, from the shape alone.
    The batch route's 128 x 256 synthesis tiles must divide the frame
    stride (`frame_stride`) and give at least one tile per SM; otherwise the
    window route: 128 x 128 tiles where 64 x 64 ones would number two per SM
    or more and divide the stride (narrow tiles re-read their operands from
    L2 once per tile), else 64-row tiles 64 columns wide if that fills the
    SMs, else 32. Neither GEMM is split along K: on the H100 the partial
    sums cost more than the idle SMs they would fill (PERF.md)."""
    del hop   # the tiles do not depend on it: the analysis reads a16 frames
    M = B * n
    fs = frame_stride(fft_size)
    if fs % 256 == 0 and -(-M // 128) * (fs // 256) >= SMS:
        return Plan("batch", 128, 256, 208, False)
    tiles64 = -(-M // 64) * (fs // 64)
    if tiles64 >= 2 * SMS and fs % 128 == 0:
        bm, bn = 128, 128
    else:
        bm, bn = 64, 64 if tiles64 >= SMS else 32
    return Plan("window", bm, bn, bn, True)


def gl_launches(plan, n_iters, return_spec):
    """CUDA launches of one call on `plan`."""
    if plan.route == "window":
        return 1 if plan.one_launch else 3 * n_iters + 3
    return 3 * n_iters + 3 + int(bool(return_spec))


_OPERANDS = []          # [(mats, their versions, (synT, anaT))], newest first
_OPERANDS_LOCK = threading.Lock()


def _row_pad(F):
    return _round_up(2 * F, 8)     # 16-byte rows for the tensor maps


def gl_operands(mats):
    """(synT, anaT) of `mats` (gl_mats(...), either fold mode), built once on
    their device and cached: synT (fft, Kp) bf16 with synT[t, 2f] = inverse
    re[f, t], synT[t, 2f + 1] = inverse im[f, t] (Kp = 2F rounded up to 8;
    the kernel never reads the columns past 2F); anaT (2F, fft rounded up
    to 8) bf16 with anaT[2f] = forward re[:, f], anaT[2f + 1] = forward
    im[:, f] (16-byte rows; the kernel never reads the columns past fft,
    which are zero). A different tuple of tensors, or one written in place
    since (`_version`), builds anew (an inference tensor keeps no version:
    only a new tuple rebuilds); the cache holds the last eight."""
    mats = tuple(mats)
    versions = tuple(None if m.is_inference() else m._version for m in mats)
    with _OPERANDS_LOCK:
        for i, (ms, vs, ops) in enumerate(_OPERANDS):
            if all(a is b for a, b in zip(ms, mats)):
                if vs == versions:
                    return ops
                del _OPERANDS[i]
                break
    m0, m1, m2, m3 = mats
    fft_size, F = m0.shape
    synT = torch.empty(fft_size, _row_pad(F), dtype=m0.dtype,
                       device=m0.device)
    synT[:, 0:2 * F:2] = m2.t()
    synT[:, 1:2 * F:2] = m3.t()
    anaT = torch.zeros(2 * F, _round_up(fft_size, 8), dtype=m0.dtype,
                       device=m0.device)
    anaT[0::2, :fft_size] = m0.t()
    anaT[1::2, :fft_size] = m1.t()
    with _OPERANDS_LOCK:
        _OPERANDS.insert(0, (mats, versions, (synT, anaT)))
        del _OPERANDS[8:]
    return synT, anaT


def griffin_lim(magnitude, fft_size, hop, window, *, n_iters=16,
                momentum=0.9, phase_init="spsi", mats=None, init_spec=None,
                n_pinned=0, return_spec=False, fold_windows=True,
                context_spec=None, center=False):
    """(B, n, F) or (n, F) magnitudes -> (B, n * hop) / (n * hop,) waveform;
    with return_spec, (waveform, (re, im)) with the final (B, n, F) carry.
    center=False: the lws framing (sample 0 = frame 0, tap 0); True: the
    centred framing, whose first fft_size // 2 samples are dropped.

    window: numpy (fft,) analysis/synthesis window. mats: `gl_mats(...,
    fold=fold_windows)` on the magnitudes' device, built here when None.
    phase_init="anchored": a streaming window's start (`anchored_start`) on
    context_spec, (B, n_ctx, F) each, or None; its n_ctx frames are pinned.
    On the card the route and tiles are `gl_plan`'s."""
    squeeze = magnitude.dim() == 2
    if squeeze:
        magnitude = magnitude[None]
        if init_spec is not None:
            init_spec = tuple(a[None] for a in init_spec)
        if context_spec is not None:
            context_spec = tuple(a[None] for a in context_spec)
    _check_shapes(magnitude, fft_size, hop)
    _check_modes(magnitude, init_spec, n_pinned, phase_init, context_spec)
    if mats is None:
        mats = gl_mats(fft_size, window, magnitude.device, fold=fold_windows)
    kw = dict(n_iters=n_iters, momentum=momentum, phase_init=phase_init,
              mats=mats, init_spec=init_spec, n_pinned=n_pinned,
              return_spec=return_spec, fold_windows=fold_windows,
              context_spec=context_spec)
    dev = magnitude.device.type
    if dev == "cpu":
        res = griffin_lim_plain(magnitude, fft_size, hop, window, **kw)
    elif dev == "cuda":
        res = _griffin_lim_cuda(magnitude, fft_size, hop, window,
                                center=center, **kw)
    else:
        raise ValueError("griffin_lim: unsupported device %s"
                         % magnitude.device)
    wav, spec = res if return_spec else (res, None)
    lo = fft_size // 2 if center else 0
    wav = wav[:, lo:lo + hop * magnitude.shape[1]]
    if squeeze:
        wav = wav[0]
        spec = None if spec is None else tuple(a[0] for a in spec)
    return (wav, spec) if return_spec else wav


def griffin_lim_plain(magnitude, fft_size, hop, window, *, n_iters=16,
                      momentum=0.9, phase_init="spsi", mats=None,
                      init_spec=None, n_pinned=0, return_spec=False,
                      fold_windows=True, context_spec=None):
    """Plain PyTorch version of the kernel. (B, n, F) -> untrimmed
    (B, (n + k - 1) * hop) overlap-add signal, and with return_spec the
    final carry (re, im) as f32. bf16 operands with f32 accumulation are
    emulated as `a.to(bfloat16).float() @ m.float()`."""
    _check_shapes(magnitude, fft_size, hop)
    _check_modes(magnitude, init_spec, n_pinned, phase_init, context_spec)
    bf16 = torch.bfloat16
    S = magnitude.float()
    if phase_init == "anchored":
        i_re, i_im, n_pinned = anchored_start(S, fft_size, hop, context_spec)
        init_spec = (i_re, i_im)
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
        "pin", "frames", "a16", "out", "spec_re", "spec_im", "sync", "trace")]
        + [("init_stride", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "B", "n", "F", "fft", "hop", "Kp", "fs", "n_iters", "init",
            "n_pinned", "fold", "route", "bm", "bn", "one_launch")]
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


_SYNC = {}   # (device, stream) -> the window route's barrier counters


def _sync_counters(dev, stream):
    """Two uint32 counters for the one-launch window route's grid barrier,
    zeroed once per (device, stream): each launch leaves them at zero, and
    launches on one stream never overlap."""
    key = (dev.index or 0, stream.cuda_stream)
    if key not in _SYNC:
        _SYNC[key] = torch.zeros(2, dtype=torch.int32, device=dev)
    return _SYNC[key]


def _round_up(v, m):
    return -(-v // m) * m


def _ptr(t):
    return None if t is None else t.data_ptr()


def _griffin_lim_cuda(magnitude, fft_size, hop, window, *, mats, n_iters=16,
                      momentum=0.9, phase_init="spsi", init_spec=None,
                      n_pinned=0, return_spec=False, fold_windows=True,
                      context_spec=None, plan=None, trace=None,
                      center=False):
    """The kernel on (B, n, F) CUDA magnitudes (`griffin_lim` checks the
    arguments first; measurements call this directly): the untrimmed (B, (n + k - 1) * hop) waveform, and with return_spec the
    final carry. plan: the route and tiles (`gl_plan` of the shape when
    None). trace: on the window route, a zeroed (3 n_iters + 4, 1024, 2)
    int64 tensor that receives, for each of the first 1024 blocks, the
    globaltimer (ns) at the start and the end of each step and, in the last
    row, the block's SM (a block that did not run keeps zeros). center:
    the caller trims the centred framing's padding (counted as "center")."""
    _check_shapes(magnitude, fft_size, hop)
    dev = magnitude.device
    S = magnitude.float().contiguous()
    B, n, F = S.shape
    fs = frame_stride(fft_size)
    if B * (n + fft_size // hop) * max(_row_pad(F), fs) >= 2 ** 31:
        raise ValueError("griffin_lim: a batch of %d x %d frames at "
                         "fft_size=%d is too large for the kernel's 32-bit "
                         "indexing; split it" % (B, n, fft_size))
    synT, anaT = gl_operands(mats)
    if synT.device != dev or synT.dtype != torch.bfloat16 or \
            tuple(anaT.shape) != (2 * F, _round_up(fft_size, 8)):
        raise ValueError("griffin_lim: mats must be gl_mats(...) on %s" % dev)
    plan = gl_plan(B, n, fft_size, hop) if plan is None else plan
    bn_syn = 256 if plan.route == "batch" else plan.bn_syn
    if fs % bn_syn:
        raise ValueError("griffin_lim: %d-column synthesis tiles do not "
                         "divide the frame stride %d (fft_size=%d)"
                         % (bn_syn, fs, fft_size))
    nb = n + fft_size // hop - 1
    M, Kp = B * n, synT.shape[1]
    win, inorm = _device_consts(fft_size, hop, n, np.asarray(
        window, np.float32).tobytes(), str(dev))
    stream = torch.cuda.current_stream(dev)
    init_re = init_im = spec_re = spec_im = None
    init_stride = 0
    if phase_init == "anchored":
        init = "anchored"
        if context_spec is not None:
            init_re, init_im = (_context_plane(a, dev) for a in context_spec)
            if init_re.stride() != init_im.stride():   # one item stride
                init_re, init_im = init_re.contiguous(), init_im.contiguous()
            n_pinned = init_re.shape[1]
            init_stride = init_re.stride(0)
    elif init_spec is not None:
        init = "given"
        init_re, init_im = (a.to(dev, torch.float32).contiguous()
                            for a in init_spec)
    else:
        init = phase_init
    # One allocation for the scratch (every element the kernel reads it
    # writes first: no zero fills): carry c (M, Kp) bf16, previous
    # projection (M, 2F) bf16, pinned starts (B, n_pinned, 2F) bf16, frames
    # (M, fs) f32, re-framed signal a16 (M, fs) bf16; and one for the
    # results: the waveform and the returned spectrum.
    sizes = (2 * M * Kp, 4 * M * F, 4 * B * n_pinned * F, 4 * M * fs,
             2 * M * fs)
    scratch = torch.empty(sum(_round_up(s, 256) for s in sizes),
                          dtype=torch.uint8, device=dev)
    ptrs, at = [], scratch.data_ptr()
    for s in sizes:
        ptrs.append(at if s else None)
        at += _round_up(s, 256)
    c, tp, pin, frames, a16 = ptrs
    n_out = B * nb * hop
    results = torch.empty(n_out + (2 * M * F if return_spec else 0),
                          device=dev)
    out = results[:n_out]
    if return_spec:
        spec_re = results[n_out:n_out + M * F].view(B, n, F)
        spec_im = results[n_out + M * F:].view(B, n, F)
    sync = (_sync_counters(dev, stream)
            if plan.route == "window" and plan.one_launch else None)
    args = _Args(S.data_ptr(), inorm.data_ptr(), synT.data_ptr(),
                 anaT.data_ptr(), win.data_ptr(), _ptr(init_re),
                 _ptr(init_im), c, tp, pin, frames, a16, out.data_ptr(),
                 _ptr(spec_re), _ptr(spec_im), _ptr(sync), _ptr(trace),
                 init_stride, B, n, F, fft_size, hop, Kp, fs, n_iters,
                 INIT_CODES[init], n_pinned, int(fold_windows),
                 ROUTE_CODES[plan.route], plan.bm, plan.bn_syn,
                 int(plan.one_launch), momentum,
                 2.0 * math.pi * hop / fft_size)
    rc = KERNEL.lib.dv3_griffin_lim(ctypes.byref(args), stream.cuda_stream,
                                    dev.index or 0)
    KERNEL.check(rc, "griffin_lim launch")
    KERNEL.launched(_mode(init in ("given", "anchored"), n_pinned,
                          fold_windows, center), plan.route)
    wav = out.reshape(B, nb * hop)
    return (wav, (spec_re, spec_im)) if return_spec else wav


def _context_plane(a, dev):
    """A (B, n_ctx, F) f32 context plane as the kernel reads it: frames F
    apart, items any stride apart (a slice of a returned spectrum needs no
    copy)."""
    a = a.to(dev, torch.float32)
    if a.stride(2) != 1 or a.stride(1) != a.shape[2]:
        a = a.contiguous()
    return a
