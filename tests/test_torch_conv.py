# coding: utf-8
"""Kernel B3's plain version (deepvoice3_pytorch_tpu_torch/ops/conv_cuda.py)
against the JAX package's Pallas kernel (ops/conv_pallas.py, interpret mode
on the CPU): forward and gradients, for causal, dilated and symmetric
padding, through the weight-normalised conv1d_apply of both packages.

f32 bar 1e-5 of the output's scale: both sum the taps in f32; what remains
is summation order inside the products. bf16 bar: one bf16 ulp of the
largest value (2^-7 relative), since both round an f32 accumulator once and
a sum-order difference can move a value across a rounding boundary."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu.ops import conv_pallas
from deepvoice3_pytorch_tpu.ops import core as j_core
from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
from deepvoice3_pytorch_tpu_torch.ops import core as t_core

from torch_port_common import maxdiff, t

CASES = [  # kw, dilation, causal, B, T, C, N
    (3, 1, False, 2, 21, 16, 24),    # symmetric
    (3, 1, True, 1, 17, 8, 16),      # causal
    (3, 9, True, 2, 24, 16, 8),      # dilated causal
    (5, 3, False, 3, 19, 12, 20),    # dilated symmetric, kw 5
    (3, 27, False, 2, 40, 8, 8),     # dilation 27: taps wholly in the pad
]


def _close(got, want, tol=1e-5):
    scale = max(1.0, float(np.abs(np.asarray(want, np.float64)).max()))
    d = maxdiff(got, want)
    assert d <= tol * scale, (d, scale)


def _params(rs, kw, cin, cout):
    return {"v": (rs.randn(kw, cin, cout) * 0.3).astype(np.float32),
            "g": (rs.rand(cout) + 0.5).astype(np.float32),
            "b": (rs.randn(cout) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("kw,dilation,causal,B,T,C,N", CASES)
def test_forward_matches_pallas(kw, dilation, causal, B, T, C, N):
    rs = np.random.RandomState(0)
    p = _params(rs, kw, C, N)
    x = rs.randn(B, T, C).astype(np.float32)
    with j_core.conv_lowering("pallas"):
        want = j_core.conv1d_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), dilation=dilation,
                                   causal=causal)
    with t_core.conv_mode("kernel"):
        got = t_core.conv1d_apply({k: t(v) for k, v in p.items()}, t(x),
                                  dilation=dilation, causal=causal)
    _close(got, want)


@pytest.mark.parametrize("kw,dilation,causal,B,T,C,N", CASES)
def test_gradients_match_pallas(kw, dilation, causal, B, T, C, N):
    """dx, dv, dg, db of sum(sin(y)) (a non-constant dy) through the
    weight-normalised conv: JAX's custom_vjp against _ConvTaps' backward."""
    rs = np.random.RandomState(1)
    p = _params(rs, kw, C, N)
    x = rs.randn(B, T, C).astype(np.float32)

    def f(p, x):
        with j_core.conv_lowering("pallas"):
            y = j_core.conv1d_apply(p, x, dilation=dilation, causal=causal)
        return jnp.sum(jnp.sin(y))

    want_p, want_x = jax.grad(f, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    pt = {k: t(v).requires_grad_(True) for k, v in p.items()}
    xt = t(x).requires_grad_(True)
    with t_core.conv_mode("kernel"):
        y = t_core.conv1d_apply(pt, xt, dilation=dilation, causal=causal)
    torch.sin(y).sum().backward()
    _close(xt.grad, want_x)
    for k in ("v", "g", "b"):
        _close(pt[k].grad, want_p[k])


@pytest.mark.parametrize("kw,dilation,causal", [(3, 1, True), (3, 3, False)])
def test_bf16_matches_pallas(kw, dilation, causal):
    """bf16 operands, f32 accumulation, one rounding: forward, dx and dw of
    a fixed dy against the Pallas kernel's custom_vjp."""
    rs = np.random.RandomState(2)
    B, T, C, N = 2, 20, 16, 32
    x = rs.randn(B, T, C).astype(np.float32)
    w = (rs.randn(kw, C, N) * 0.3).astype(np.float32)
    b = (rs.randn(N) * 0.1).astype(np.float32)
    dy = rs.randn(B, T, N).astype(np.float32)
    pad = ((kw - 1) * dilation, 0) if causal else ((kw - 1) // 2 * dilation,) * 2
    bf = jnp.bfloat16
    y_j, vjp = jax.vjp(
        lambda x, w, b: conv_pallas.conv1d_pallas(x, w, b, pad, dilation),
        jnp.asarray(x, bf), jnp.asarray(w, bf), jnp.asarray(b, bf))
    dx_j, dw_j, db_j = vjp(jnp.asarray(dy, bf))

    xt, wt, bt = (t(a).to(torch.bfloat16).requires_grad_(True)
                  for a in (x, w, b))
    y_t = conv_cuda.conv1d_taps(xt, wt, bt, pad, dilation)
    y_t.backward(t(dy).to(torch.bfloat16))
    assert y_t.dtype == torch.bfloat16 and xt.grad.dtype == torch.bfloat16

    def f32(a):
        return np.asarray(jnp.asarray(a, jnp.float32))

    for got, want in ((y_t, y_j), (xt.grad, dx_j), (wt.grad, dw_j),
                      (bt.grad, db_j)):
        want = f32(want)
        assert maxdiff(got.float(), want) <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("pad", [(1, 0), (0, 0), (3, 0), (-1, 3)])
def test_outside_contract_raises(pad):
    """Output length must equal input length: no silent fallback."""
    x = torch.zeros(1, 8, 4)
    w = torch.zeros(3, 4, 4)
    with pytest.raises(ValueError, match="pl \\+ pr"):
        conv_cuda.conv1d_taps(x, w, None, pad, 1)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU no kernel is built or launched."""
    conv_cuda.KERNEL.reset_counts()
    x = torch.randn(2, 9, 4, requires_grad=True)
    w = torch.randn(3, 4, 6, requires_grad=True)
    conv_cuda.conv1d_taps(x, w, torch.zeros(6), (1, 1), 1).sum().backward()
    assert conv_cuda.KERNEL.launches == 0 and conv_cuda.KERNEL._lib is None


@pytest.mark.parametrize("B,T,C,N,dtype", [
    (16, 128, 512, 1024, torch.float32), (16, 512, 256, 512, torch.float32),
    (64, 128, 256, 512, torch.bfloat16), (1, 7, 3, 5, torch.float32)])
def test_wgrad_splits_cover_every_row(B, T, C, N, dtype):
    splits, rows = conv_cuda.wgrad_splits(B, T, C, N, 3, dtype)
    M = B * T
    assert splits >= 1 and rows >= 1
    assert (splits - 1) * rows < M <= splits * rows
    assert 3 * splits <= 65535
