# coding: utf-8
"""The port's CUDA kernels against their plain versions on the card, at
small shapes that reach the cases chip_smoke.py does not: chunk hand-off
of the decode carry across launches, non-monotonic attention, no mask,
long padded texts, tile edges of the Griffin-Lim GEMMs, and the ragged
edges of the tap-accumulating conv (T, C, N off the tiles, B = 1, taps
wholly in the pad) with the determinism of its weight gradient.

Marked `cuda`: each test skips when no CUDA device is present. On a machine
with a card (the JAX package need not be installed):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from deepvoice3_pytorch_tpu_torch import builder
from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp
from deepvoice3_pytorch_tpu_torch.models import deepvoice3 as dv3
from deepvoice3_pytorch_tpu_torch.ops import core
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with core.strict_numerics():
        yield torch.device("cuda", 0)


def _decoder(dev, width=32, monotonic=True, Tk=12, B=3, seed=0):
    cfg = builder.deepvoice3(
        n_vocab=149, embed_dim=width, mel_dim=16, linear_dim=65, r=1,
        downsample_step=4, kernel_size=3, encoder_channels=width,
        decoder_channels=width, converter_channels=width,
        use_memory_mask=True, key_projection=True, value_projection=True,
        max_positions=max(64, Tk + 1), force_monotonic_attention=monotonic)
    params = builder.model_init(cfg, torch.Generator().manual_seed(seed), dev)
    g = torch.Generator().manual_seed(seed + 1)
    enc = tuple(torch.randn(B, Tk, width, generator=g).to(dev) * 0.5
                for _ in range(2))
    lengths = torch.randint(Tk // 2, Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    return cfg, params["decoder"], enc, pos, lengths


def _close(got, want, tol):
    """Within tol of each output's scale (max(1, max|want|)), last_attended
    and step counts exact."""
    for name in ("outputs", "alignments", "done", "decoder_states"):
        a, b = getattr(got, name), getattr(want, name)
        d = float((a - b).abs().max())
        assert d <= tol * max(1.0, float(b.abs().max())), (name, d)
    assert torch.equal(got.last_attended, want.last_attended)
    assert got.num_steps == want.num_steps


@pytest.mark.parametrize("chunk,monotonic,masked,early_exit", [
    (32, True, True, False), (3, True, True, False), (4, False, True, False),
    (5, True, False, False), (4, True, True, True)])
def test_fused_decode_kernel_matches_plain(dev, chunk, monotonic, masked,
                                           early_exit):
    cfg, pd, enc, pos, lengths = _decoder(dev, monotonic=monotonic)
    T = 11
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 12) if masked else None
    init = torch.zeros(3, 16, device=dev)
    args = (pd, cfg.decoder, fi, mask, init, T, 2)
    fd.KERNEL.launches = 0
    got = fd.fused_decode(*args, early_exit=early_exit, chunk=chunk)
    assert fd.KERNEL.launches == -(-got.num_steps // min(chunk, T))
    want = fd.fused_decode_plain(*args, early_exit=early_exit, chunk=chunk)
    _close(got, want, 1e-4)


def test_fused_decode_kernel_long_text(dev):
    """Tk = 500 padded positions (more than one score per thread) at width
    64."""
    cfg, pd, enc, pos, lengths = _decoder(dev, width=64, Tk=500, B=2)
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 500)
    args = (pd, cfg.decoder, fi, mask, torch.zeros(2, 16, device=dev), 9, 2)
    _close(fd.fused_decode(*args, early_exit=False),
           fd.fused_decode_plain(*args, early_exit=False), 1e-4)


def test_fused_decode_carry_resumes(dev):
    """Two launches through the public FusedDecoder interface equal one."""
    cfg, pd, enc, pos, lengths = _decoder(dev)
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, enc, pos)
    mask = core.get_mask_from_lengths(lengths, 12)
    dec = fd.FusedDecoder(pd, cfg.decoder, fi, mask, 10)
    init = torch.zeros(3, 16, device=dev)
    c1, o1 = dec.zero_carry(init), dec.new_outputs(10)
    dec.launch(c1, o1, 0, 10)
    c2, o2 = dec.zero_carry(init), dec.new_outputs(10)
    dec.launch(c2, o2, 0, 6)
    dec.launch(c2, o2, 6, 4)
    for a, b in zip(o1 + tuple(c1), o2 + tuple(c2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fft,hop,B,n,n_iters,phase_init", [
    (1024, 256, 2, 37, 0, "spsi"), (1024, 256, 2, 37, 1, "spsi"),
    (1024, 256, 3, 21, 1, "zero"), (128, 32, 2, 40, 1, "spsi")])
def test_griffin_lim_kernel_matches_plain(dev, fft, hop, B, n, n_iters,
                                          phase_init):
    """Where little amplifies bf16 rounding flips (<= 1 iteration) the
    kernel and the plain version agree to 3e-3 of the peak (one iteration
    measured 1.1e-3 on the card; the CPU tests see 7e-4 against the Pallas
    kernel); B*n is not a multiple of the 64-row GEMM tile."""
    g = torch.Generator().manual_seed(0)
    S = (torch.rand(B, n, fft // 2 + 1, generator=g) ** 2).to(dev)
    win = dsp.lws_hann_window(fft, hop)
    gl_cuda.KERNEL.launches = 0
    got = gl_cuda.griffin_lim(S, fft, hop, win, n_iters=n_iters,
                              phase_init=phase_init)
    assert gl_cuda.KERNEL.launches == 1
    want = gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=n_iters,
                                     phase_init=phase_init)[:, :n * hop]
    rel = float((got - want).abs().max() / want.abs().max())
    assert rel <= 3e-3, rel


def test_griffin_lim_kernel_rejects_bad_framing(dev):
    S = torch.rand(1, 8, 513, device=dev)
    with pytest.raises(ValueError):
        gl_cuda.griffin_lim(S, 1024, 240, torch.ones(1024).numpy())


CONV_CASES = [  # B, T, C, N, kw, dil, causal
    (2, 37, 20, 70, 3, 1, False),      # T, C, N off every tile
    (1, 130, 64, 128, 3, 3, True),     # B = 1, causal
    (3, 40, 16, 24, 3, 27, False),     # dilation 27, T < 54: taps in the pad
    (2, 300, 256, 512, 3, 9, True),    # decoder width, several row tiles
    (4, 33, 24, 8, 5, 1, False),       # kw 5, N below one tile
]


def _conv_inputs(dev, B, T, C, N, kw, dil, causal, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g)
    w = torch.randn(kw, C, N, generator=g) / (kw * C) ** 0.5
    b = torch.randn(N, generator=g) * 0.1
    dy = torch.randn(B, T, N, generator=g)
    pad = ((kw - 1) * dil, 0) if causal else ((kw - 1) // 2 * dil,) * 2
    return [a.to(dev, dtype) for a in (x, w, b, dy)] + [pad]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,N,kw,dil,causal", CONV_CASES)
def test_conv_taps_kernel_matches_plain(dev, dtype, B, T, C, N, kw, dil,
                                        causal):
    """Forward, dgrad and wgrad kernels against the plain versions on the
    same card. f32: 1e-5 of the output's scale (the kernel's FMA order
    against the plain matmul's). bf16: the plain version computes in f32
    from the same bf16 operands and rounds once, so the bar is one bf16
    ulp of the largest value (2^-7 relative) for the bf16 outputs and 1e-5
    for the f32 weight gradient."""
    x, w, b, dy, pad = _conv_inputs(dev, B, T, C, N, kw, dil, causal, dtype)
    conv_cuda.KERNEL.reset_counts()
    pairs = [
        (conv_cuda.conv_fwd(x, w, b, pad, dil),
         conv_cuda.conv1d_taps_plain(x, w, b, pad, dil), dtype),
        (conv_cuda.conv_dgrad(dy, w, pad, dil),
         conv_cuda.conv1d_taps_plain(dy, w.flip(0).transpose(1, 2), None,
                                     (pad[1], pad[0]), dil), dtype),
        (conv_cuda.conv_wgrad(x, dy, pad, dil, kw),
         conv_cuda.conv1d_taps_wgrad_plain(x, dy, pad, dil, kw),
         torch.float32),
    ]
    torch.cuda.synchronize()
    assert conv_cuda.KERNEL.by_entry == {"fwd": 2, "wgrad": 1}
    for got, want, out_dtype in pairs:
        assert got.dtype == out_dtype and got.shape == want.shape
        scale = max(1.0, float(want.float().abs().max()))
        tol = 2.0 ** -7 if out_dtype == torch.bfloat16 else 1e-5
        err = float((got.float() - want.float()).abs().max())
        assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_taps_wgrad_is_deterministic(dev, dtype):
    """Split rows summed in a fixed order, no atomics: bit-equal runs."""
    x, w, b, dy, pad = _conv_inputs(dev, 8, 200, 256, 512, 3, 3, False,
                                    dtype)
    splits, _ = conv_cuda.wgrad_splits(8, 200, 256, 512, 3, dtype)
    assert splits > 1
    a = conv_cuda.conv_wgrad(x, dy, pad, 3, 3)
    c = conv_cuda.conv_wgrad(x, dy, pad, 3, 3)
    assert torch.equal(a, c)


def test_conv_taps_autograd_runs_three_kernels(dev):
    """One differentiable conv: forward, then dgrad + wgrad in backward;
    gradients equal the plain version's through autograd."""
    x, w, b, dy, pad = _conv_inputs(dev, 2, 50, 32, 64, 3, 1, True,
                                    torch.float32)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, b)]
    conv_cuda.KERNEL.reset_counts()
    conv_cuda.conv1d_taps(*leaves, pad, 1).backward(dy)
    assert conv_cuda.KERNEL.by_entry == {"fwd": 2, "wgrad": 1}
    ref = [a.clone().requires_grad_(True) for a in (x, w, b)]
    conv_cuda.conv1d_taps_plain(*ref, pad, 1).backward(dy)
    for got, want in zip(leaves, ref):
        assert torch.allclose(got.grad, want.grad, rtol=1e-5, atol=1e-5)


def test_conv_taps_kernel_rejects_bad_calls(dev):
    x = torch.zeros(1, 8, 4, device=dev)
    w = torch.zeros(3, 4, 4, device=dev)
    with pytest.raises(ValueError):
        conv_cuda.conv1d_taps(x, w, None, (1, 0), 1)
    with pytest.raises(TypeError):
        conv_cuda.conv_fwd(x.half(), w.half(), None, (1, 1), 1)
    with pytest.raises(ValueError):
        conv_cuda.conv_fwd(x, w.to(torch.bfloat16), None, (1, 1), 1)
