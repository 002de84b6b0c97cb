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
    (64, 128, 256, 512, torch.bfloat16), (1, 7, 3, 5, torch.float32),
    (8, 200, 256, 512, torch.bfloat16), (2, 37, 20, 70, torch.bfloat16)])
def test_wgrad_splits_cover_every_row(B, T, C, N, dtype):
    """Every row tile (fast route) or row (ragged route) in exactly one
    split, no split empty, the grid's z inside its limit."""
    plan = conv_cuda.wgrad_plan(B, T, C, N, 3, dtype)
    splits, per = plan.splits, plan.per_split
    units = B * T if plan.route == "simple" else \
        B * -(-T // plan.tile[2])
    assert splits >= 1 and per >= 1
    assert (splits - 1) * per < units <= splits * per
    assert 3 * splits <= 65535


# the train step's five conv classes at bench.py's shapes (LJSpeech
# preset): (C, N, T) of the forward (dgrad swaps C and N), and per type the
# columns of the forward's and the dgrad's tiles and the wgrad's splits
BENCH_CLASSES = {
    "encoder": ((512, 1024, 128), {"f32": (128, 64, 4),
                                   "bf16": (256, 256, 4)}),
    "decoder": ((256, 512, 128), {"f32": (64, 64, 5),
                                  "bf16": (256, 128, 5)}),
    "converter_2T": ((256, 512, 256), {"f32": (128, 64, 5),
                                       "bf16": (256, 256, 11)}),
    "converter_4T": ((256, 512, 512), {"f32": (128, 128, 11),
                                       "bf16": (256, 256, 11)}),
    "converter_4T_wide": ((512, 1024, 512), {"f32": (128, 128, 4),
                                             "bf16": (256, 256, 4)}),
}


@pytest.mark.parametrize("name", sorted(BENCH_CLASSES))
@pytest.mark.parametrize("B,dtype,key,fast,rows", [
    (16, torch.float32, "f32", "pipe", 32),
    (64, torch.bfloat16, "bf16", "wgmma", 64)])
def test_bench_classes_take_the_fast_route(name, B, dtype, key, fast, rows):
    """Route, tiles and splits of the five classes, fixed from the shape
    alone: 128-row tiles of one batch item; forward tiles of 256 (bf16) or
    128 (f32) columns, halved where they would leave half of the 132 SMs
    idle; wgrad splits in whole waves of one block an SM."""
    (C, N, T), want = BENCH_CLASSES[name]
    fwd_cols, dgrad_cols, splits = want[key]
    assert conv_cuda.fwd_plan(B, T, C, N, dtype) == (fast, (128, fwd_cols))
    assert conv_cuda.fwd_plan(B, T, N, C, dtype) == (fast, (128, dgrad_cols))
    plan = conv_cuda.wgrad_plan(B, T, C, N, 3, dtype)
    assert plan.route == fast and plan.tile == (128, 128, rows)
    assert plan.splits == splits


@pytest.mark.parametrize("B,T,C,N,dtype,route", [
    (2, 37, 20, 70, torch.bfloat16, "simple"),   # C, N not multiples of 8
    (2, 37, 20, 70, torch.float32, "simple"),    # N not a multiple of 4
    (3, 40, 16, 24, torch.bfloat16, "wgmma"),
    (4, 33, 24, 8, torch.float32, "pipe"),
    (3, 40, 12, 24, torch.bfloat16, "simple"),   # C = 12: 24-byte rows
    (3, 40, 12, 24, torch.float32, "pipe"),      # 48-byte rows
])
def test_route_is_chosen_from_the_shape(B, T, C, N, dtype, route):
    assert conv_cuda.route(C, N, dtype) == route
    assert conv_cuda.fwd_plan(B, T, C, N, dtype)[0] == route
    assert conv_cuda.wgrad_plan(B, T, C, N, 3, dtype).route == route
