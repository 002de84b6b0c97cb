# coding: utf-8
"""Kernel B2's host side on the CPU: the route each shape takes
(`gl_cuda.gl_plan`), the cached DFT operands (`gl_cuda.gl_operands`), and
the anchored start of a streaming window (`phase_init="anchored"`) against
the eager composition that `streaming.gl_window` built before the kernel
took it over.

Tolerances: the route and the operands are exact. The anchored start's
plain version is held to the old composition at 1e-6 relative (start
spectra) and, after Griffin-Lim, at the bars of tests/test_torch_streaming.py
(waveform 1e-3 of the peak, returned spectrum 2^-8 in relative L2 norm):
both run the same f32 operations on the CPU, so they agree exactly today.
"""

import numpy as np
import pytest
import torch

from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

BF16_EPS = 2.0 ** -8


# (B, n, fft) -> (route, bm, bn_syn, bn_ana, one_launch): the five calls
# of B2's aims
@pytest.mark.parametrize("B,n,want", [
    (32, 400, ("batch", 128, 256, 208, False)),     # tts_batch
    (32, 600, ("batch", 128, 256, 208, False)),     # P
    (8, 152, ("window", 128, 128, 128, True)),      # a B = 8 stream
    (1, 152, ("window", 64, 32, 32, True)),         # a B = 1 window
    (1, 40, ("window", 64, 32, 32, True)),          # a short window
])
def test_route_is_chosen_from_the_shape(B, n, want):
    assert tuple(gl_cuda.gl_plan(B, n, 1024, 256)) == want


def test_no_window_takes_the_batch_route():
    """Every stream and serving window (up to 8 rows of 16 context + 128
    emitted + 8 lookahead frames) takes the window route, on one of its
    three tiles: 64 x 32 while 64 x 64 tiles would not fill the SMs, 64 x 64
    while they would fill them less than twice, 128 x 128 above."""
    for B in range(1, 9):
        for n in range(1, 153):
            p = gl_cuda.gl_plan(B, n, 1024, 256)
            assert p.route == "window" and p.one_launch, (B, n, p)
            tiles64 = -(-B * n // 64) * 16
            want = ((64, 32) if tiles64 < gl_cuda.SMS else (64, 64)
                    if tiles64 < 2 * gl_cuda.SMS else (128, 128))
            assert (p.bm, p.bn_syn) == want and p.bn_ana == p.bn_syn
    # the batch route starts where its 128 x 256 synthesis tiles fill the
    # 132 SMs once: 33 row tiles
    assert gl_cuda.gl_plan(1, 128 * 33, 1024, 256).route == "batch"
    assert gl_cuda.gl_plan(1, 128 * 33 - 128, 1024, 256).route == "window"
    # fft sizes the batch tiles do not divide stay on the window route
    assert gl_cuda.gl_plan(64, 400, 128, 32).route == "window"


def test_launches_per_call():
    window = gl_cuda.gl_plan(1, 152, 1024, 256)
    assert gl_cuda.gl_launches(window, 32, True) == 1
    assert gl_cuda.gl_launches(window._replace(one_launch=False), 32,
                               True) == 99
    batch = gl_cuda.gl_plan(32, 400, 1024, 256)
    assert gl_cuda.gl_launches(batch, 16, False) == 51
    assert gl_cuda.gl_launches(batch, 16, True) == 52


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("fft", [128, 1024])
def test_operands_interleave_the_dft_matrices(fft, fold):
    """synT[t, 2f] / [t, 2f + 1] = inverse re / im [f, t]; anaT[2f] /
    [2f + 1] = forward re / im [:, f]; rows of synT are 16-byte multiples.
    Exact."""
    mats = gl_cuda.gl_mats(fft, dsp.lws_hann_window(fft, fft // 4),
                           "cpu", fold=fold)
    synT, anaT = gl_cuda.gl_operands(mats)
    F = fft // 2 + 1
    assert synT.shape == (fft, -(-2 * F // 8) * 8) and anaT.shape == (2 * F,
                                                                      fft)
    assert synT.dtype == anaT.dtype == torch.bfloat16
    assert torch.equal(synT[:, 0:2 * F:2], mats[2].t())
    assert torch.equal(synT[:, 1:2 * F:2], mats[3].t())
    assert torch.equal(anaT[0::2], mats[0].t())
    assert torch.equal(anaT[1::2], mats[1].t())


def test_operands_are_built_once_per_mats():
    """One build per tuple of matrices; another tuple builds anew; a tuple
    written in place since builds anew, with the new values."""
    win = dsp.lws_hann_window(128, 32)
    mats = gl_cuda.gl_mats(128, win, "cpu")
    first = gl_cuda.gl_operands(mats)
    again = gl_cuda.gl_operands(list(mats))
    assert all(a is b for a, b in zip(first, again))
    other = gl_cuda.gl_operands(gl_cuda.gl_mats(128, win, "cpu"))
    assert all(a is not b for a, b in zip(first, other))
    mats[1].mul_(2.0)
    rebuilt = gl_cuda.gl_operands(mats)
    assert all(a is not b for a, b in zip(first, rebuilt))
    assert torch.equal(rebuilt[1][1::2], mats[1].t())
    assert not torch.equal(rebuilt[1], first[1])
    assert all(a is b for a, b in zip(rebuilt, gl_cuda.gl_operands(mats)))


def _old_gl_window_start(S, fft, hop, prev_spec):
    """streaming.gl_window's start as it was built from eager ops before
    the kernel computed it: (i_re, i_im, n_pinned)."""
    phi = dsp.spsi_phase(S, fft, hop)
    n_ctx = 0
    if prev_spec is not None:
        pre, pim = prev_spec
        n_ctx = pre.shape[1]
        delta = torch.atan2(pim[:, -1], pre[:, -1]) - phi[:, n_ctx - 1]
        phi = phi + delta[:, None, :]
        i_re = torch.cat([pre, (S * torch.cos(phi))[:, n_ctx:]], dim=1)
        i_im = torch.cat([pim, (S * torch.sin(phi))[:, n_ctx:]], dim=1)
    else:
        i_re, i_im = S * torch.cos(phi), S * torch.sin(phi)
    return i_re, i_im, n_ctx


def _rel(a, b):
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


@pytest.mark.parametrize("n_ctx", [0, 1, 6])
def test_anchored_start_matches_the_old_composition(n_ctx):
    fft, hop, B, n = 128, 32, 2, 20
    rs = np.random.RandomState(3)
    S = torch.from_numpy((rs.rand(B, n, fft // 2 + 1) ** 2)
                         .astype(np.float32))
    ctx = None
    if n_ctx:
        # a slice of a returned spectrum, as the vocoders pass it
        full = [torch.from_numpy(rs.randn(B, n, fft // 2 + 1)
                                 .astype(np.float32)) for _ in range(2)]
        ctx = tuple(a[:, n - n_ctx:] for a in full)
    win = dsp.lws_hann_window(fft, hop)
    o_re, o_im, o_pin = _old_gl_window_start(S, fft, hop, ctx)
    a_re, a_im, a_pin = gl_cuda.anchored_start(S, fft, hop, ctx)
    assert a_pin == o_pin == n_ctx
    assert _rel(a_re, o_re) <= 1e-6 and _rel(a_im, o_im) <= 1e-6

    kw = dict(n_iters=3, momentum=0.9, return_spec=True)
    wav, spec = gl_cuda.griffin_lim(S, fft, hop, win, phase_init="anchored",
                                    context_spec=ctx, **kw)
    w_old, s_old = gl_cuda.griffin_lim(S, fft, hop, win,
                                       init_spec=(o_re, o_im),
                                       n_pinned=o_pin, **kw)
    assert _rel(wav, w_old) <= 1e-3
    c, c_old = torch.complex(*spec), torch.complex(*s_old)
    assert float((c - c_old).abs().norm()) <= BF16_EPS * float(
        c_old.abs().norm())
    # the context frames stay at their start through every iteration
    _, start = gl_cuda.griffin_lim(S, fft, hop, win, phase_init="anchored",
                                   context_spec=ctx, n_iters=0,
                                   return_spec=True)
    for got, st in zip(spec, start):
        assert torch.equal(got[:, :n_ctx], st[:, :n_ctx])


def test_anchored_start_rejects_bad_arguments():
    S = torch.rand(1, 8, 65)
    win = dsp.lws_hann_window(128, 32)
    ctx = (torch.rand(1, 3, 65), torch.rand(1, 3, 65))
    with pytest.raises(ValueError):       # a context needs the mode
        gl_cuda.griffin_lim(S, 128, 32, win, n_iters=1, context_spec=ctx)
    with pytest.raises(ValueError):       # the mode takes no init_spec
        gl_cuda.griffin_lim(S, 128, 32, win, n_iters=1,
                            phase_init="anchored", init_spec=(S, S))
    with pytest.raises(ValueError):       # a context longer than the window
        long_ctx = (torch.rand(1, 9, 65), torch.rand(1, 9, 65))
        gl_cuda.griffin_lim(S, 128, 32, win, n_iters=1,
                            phase_init="anchored", context_spec=long_ctx)
    with pytest.raises(ValueError):
        gl_cuda.griffin_lim(S, 128, 32, win, phase_init="random")
