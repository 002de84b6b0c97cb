# coding: utf-8
"""Kernel B2 at every framing the Pallas kernel takes, on the CPU: the
port's plain version (what its CUDA kernel is held to on the card) against
`griffin_lim_pallas` in interpret mode at k = fft / hop = 8, at a hop off 4
and at an fft off 8 and off 64, with the SPSI start and with the streaming
modes (init_spec, n_pinned, return_spec); and the shape rule that picks the
route (`gl_cuda.b2_takes`, `AudioProcessor.inversion_route` and
`window_route`) against the Pallas kernel's own guard, with the refusals
that remain.

Tolerances are those of tests/test_torch_gl.py, for the same reason: both
run bf16 carries whose f32 sums differ in order, so a value near a bf16
rounding boundary may round the other way, and iterations amplify it. One
iteration: 1e-3 of the peak; sixteen: 0.12 of the peak and spectral error
no worse than 1.05x the JAX kernel's. The returned spectrum after one
iteration is the bf16 carry: 2^-8 (bf16's precision) in relative L2 norm,
as tests/test_torch_streaming.py holds it; pinned frames exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu.dsp import gl_pallas
from deepvoice3_pytorch_tpu.dsp.gl_pallas import griffin_lim_pallas
from deepvoice3_pytorch_tpu_torch import streaming
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp import stft as tdsp
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams

from test_torch_gl import _rel, _spec_err

SHAPES = [(256, 32), (200, 50), (132, 33)]   # k = 8; hop % 4 = 2; fft % 8
BF16_EPS = 2.0 ** -8


def _mags(fft, n, B=2, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, n, fft // 2 + 1) ** 2).astype(np.float32)


def _run(S, fft, hop, n_iters, mode):
    """(port waveform, port spectrum, JAX waveform, JAX spectrum, window,
    pinned frames) of one call in `mode`: "spsi" or "given" (a random
    start with 6 frames pinned, the spectrum returned)."""
    win = tdsp.lws_hann_window(fft, hop)
    kw, n_pin = dict(n_iters=n_iters, momentum=0.9), 0
    if mode == "given":
        rs = np.random.RandomState(1)
        init = [rs.randn(*S.shape).astype(np.float32) for _ in range(2)]
        n_pin = 6
        jkw = dict(init_spec=tuple(jnp.asarray(a) for a in init),
                   n_pinned=n_pin, return_spec=True)
        tkw = dict(init_spec=tuple(torch.from_numpy(a) for a in init),
                   n_pinned=n_pin, return_spec=True)
    else:
        jkw = tkw = dict(phase_init="spsi")
    wj = griffin_lim_pallas(jnp.asarray(S), fft, hop, jnp.asarray(win),
                            center=False, interpret=True, **kw, **jkw)
    wt = gl_cuda.griffin_lim(torch.from_numpy(S), fft, hop, win, **kw, **tkw)
    sj = st = None
    if mode == "given":
        (wj, sj), (wt, st) = wj, wt
        sj = np.asarray(sj[0]) + 1j * np.asarray(sj[1])
        st = st[0].numpy() + 1j * st[1].numpy()
    wj, wt = np.asarray(wj), wt.numpy()
    assert wt.shape == wj.shape == (S.shape[0], S.shape[1] * hop)
    return wt, st, wj, sj, win, n_pin


@pytest.mark.parametrize("mode", ["spsi", "given"])
@pytest.mark.parametrize("fft,hop", SHAPES)
def test_plain_version_matches_pallas_one_iteration(fft, hop, mode):
    S = _mags(fft, 30)
    wt, st, wj, sj, _, n_pin = _run(S, fft, hop, 1, mode)
    assert _rel(wt, wj) <= 1e-3
    if mode == "given":
        assert np.linalg.norm(st - sj) <= BF16_EPS * np.linalg.norm(sj)
        assert np.array_equal(st[:, :n_pin], sj[:, :n_pin])


@pytest.mark.parametrize("mode", ["spsi", "given"])
@pytest.mark.parametrize("fft,hop", SHAPES)
def test_plain_version_matches_pallas_16_iterations(fft, hop, mode):
    S = _mags(fft, 30, seed=2)
    wt, st, wj, sj, win, n_pin = _run(S, fft, hop, 16, mode)
    assert np.isfinite(wt).all()
    assert _rel(wt, wj) < 0.12
    err_t = _spec_err(wt, S, fft, hop, win)
    err_j = _spec_err(wj, S, fft, hop, win)
    assert err_t <= 1.05 * err_j, (err_t, err_j)
    if mode == "given":
        assert np.array_equal(st[:, :n_pin], sj[:, :n_pin])


# (fft, hop): B2 takes it exactly when hop | fft, at any k
FRAMINGS = [(1024, 256), (1024, 128), (1024, 64), (2048, 256), (800, 200),
            (1100, 275), (200, 50), (132, 33), (1024, 240), (800, 160 + 1),
            (1100, 300), (128, 48)]


@pytest.mark.parametrize("fft,hop", FRAMINGS)
def test_b2_takes_what_the_pallas_guard_takes(fft, hop):
    """b2_takes against gl_pallas.fits_vmem at a window's size (where the
    TPU's VMEM budget holds every framing here, so only the shape rule
    speaks); the routes of an AudioProcessor at that framing."""
    takes = gl_cuda.b2_takes(fft, hop)
    assert takes == (fft % hop == 0)
    assert takes == gl_pallas.fits_vmem(32, fft, hop, fft // 2 + 1,
                                        with_init=True, return_spec=True)
    hp = default_hparams()
    hp.fft_size, hp.hop_size = fft, hop
    ap = AudioProcessor(hp)
    assert ap.window_route == ap.inversion_route == (
        "b2" if takes else "general")
    hp.phase_retrieval = "lws"
    if takes:
        assert AudioProcessor(hp).inversion_route == "lws"
        assert AudioProcessor(hp).window_route == "b2"


def test_refusals_format_their_messages():
    """What B2 still refuses raises a ValueError whose message formats: a
    hop that does not divide fft, a batch past 32-bit indexing, and a
    forced plan whose synthesis tiles do not divide the frame stride."""
    win = tdsp.lws_hann_window(1024, 256)
    with pytest.raises(ValueError, match="divide fft_size .got fft_size=1024 "
                                         "hop_size=240"):
        gl_cuda.griffin_lim(torch.rand(1, 8, 513), 1024, 240, win)
    with pytest.raises(ValueError, match="32-bit indexing"):
        gl_cuda._griffin_lim_cuda(torch.empty(2048, 2048, 513,
                                              device="meta"), 1024, 256,
                                  win, mats=None)
    S = torch.rand(1, 8, 401)
    mats = gl_cuda.gl_mats(800, tdsp.lws_hann_window(800, 200), "cpu")
    with pytest.raises(ValueError, match="256-column synthesis tiles do not "
                                         "divide the frame stride 832"):
        gl_cuda._griffin_lim_cuda(S, 800, 200, win, mats=mats,
                                  plan=gl_cuda.Plan("batch", 128, 256, 208,
                                                    False))


@pytest.mark.parametrize("fft,want", [
    (1024, 1024), (800, 832), (1100, 1152), (132, 192), (2048, 2048)])
def test_frame_stride_and_operands(fft, want):
    """Frame rows 64-aligned; the analysis operand's rows padded to 8 with
    zero columns past fft; the plan's tiles divide the stride."""
    assert gl_cuda.frame_stride(fft) == want
    mats = gl_cuda.gl_mats(fft, np.ones(fft, np.float32), "cpu")
    synT, anaT = gl_cuda.gl_operands(mats)
    F = fft // 2 + 1
    assert synT.shape == (fft, -(-2 * F // 8) * 8)
    assert anaT.shape == (2 * F, -(-fft // 8) * 8)
    assert torch.equal(anaT[0::2, :fft], mats[0].t())
    assert not anaT[:, fft:].any()
    for B, n in ((1, 40), (8, 152), (32, 400), (32, 800)):
        p = gl_cuda.gl_plan(B, n, fft, fft // 4)
        assert want % (256 if p.route == "batch" else p.bn_syn) == 0


def test_hop_240_windows_take_the_general_route():
    """At 16 kHz / hop 240 a stream window takes the general-hop loop in
    f32 (counted as "general"); B2 is not launched, and the window's
    samples are n * hop as on B2's route."""
    hp = default_hparams().parse("sample_rate=16000,hop_size=240")
    ap = AudioProcessor(hp)
    assert ap.window_route == "general"
    rs = np.random.RandomState(3)
    spec = torch.from_numpy(rs.rand(1, 20, 513).astype(np.float32))
    gl_cuda.KERNEL.reset_counts()
    wav, (re, im) = streaming.gl_window(ap, spec, None, 2)
    assert wav.shape == (1, 20 * 240) and re.dtype == torch.float32
    ctx = (re[:, -4:], im[:, -4:])
    wav2, (re2, im2) = streaming.gl_window(ap, spec, ctx, 2)
    assert torch.equal(re2[:, :4], ctx[0]) and torch.equal(im2[:, :4],
                                                           ctx[1])
    assert ap.routes == {"general": 2} and gl_cuda.KERNEL.launches == 0
