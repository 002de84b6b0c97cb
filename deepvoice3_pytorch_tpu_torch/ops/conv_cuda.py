# coding: utf-8
"""Tap-accumulating 1-D convolution: kernel B3, counterpart of
deepvoice3_pytorch_tpu/ops/conv_pallas.py.

    y[b, t] = sum_j x[b, t + j*dil - pl] @ w[j] + bias,   pl + pr = (kw-1)*dil

with rows outside [0, T) reading zero, every tap summed into one f32
accumulator and one rounding to x's type at the end. `conv1d_taps` is
differentiable (`_ConvTaps`, the counterpart of the JAX `custom_vjp`):

  * dx is the same convolution of dy with the taps flipped and transposed and
    the padding mirrored (derivation in conv_pallas._pconv_bwd), so it runs
    the forward kernel again;
  * dw[j] = sum_{b,t} x[b, t + j*dil - pl]^T dy[b, t] in f32, cast to w's
    type, from its own kernel;
  * db = dy.sum((0, 1)) in f32, a torch reduction as in the JAX package.

Each of the three dispatches on the device of its tensors: a CPU tensor takes
the plain PyTorch version (`conv1d_taps_plain`, `conv1d_taps_wgrad_plain`), a
CUDA tensor launches the hand-written kernel of `csrc/conv_taps.cu` or raises.
A call outside the contract (output length != input length) raises on both;
nothing falls back.
"""

import ctypes

import torch
import torch.nn.functional as F

from .. import _build

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = _build.Kernel("conv_taps.cu", {
    "dv3_conv_taps_fwd": [_P, _P, _P, _P] + [_I] * 9 + [_P, _I],
    "dv3_conv_taps_wgrad": [_P, _P, _P, _P] + [_I] * 12 + [_P, _I],
})

# wgrad output tiles (csrc/conv_taps.cu FM x FN for f32, HM x HN for bf16)
_WGRAD_TILE = {torch.float32: (128, 64), torch.bfloat16: (64, 64)}
_TARGET_BLOCKS = 2 * 132     # two blocks for each of the H100's 132 SMs
_MIN_ROWS_PER_SPLIT = 256


def check_contract(kw, pad, dil):
    if pad[0] < 0 or pad[1] < 0 or pad[0] + pad[1] != (kw - 1) * dil:
        raise ValueError(
            "conv1d_taps needs pl + pr == (kw - 1) * dilation (output length "
            "== input length); got pad %r, kw %d, dilation %d"
            % (tuple(pad), kw, dil))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _taps(x, pad, dil, kw):
    """The kw shifted (B, T, C) views of zero-padded x, in f32."""
    T = x.shape[1]
    xp = F.pad(x.float(), (0, 0, pad[0], pad[1]))
    return [xp[:, j * dil:j * dil + T] for j in range(kw)]


def conv1d_taps_plain(x, w, b, pad, dil):
    """Forward in plain PyTorch: f32 tap sum, bias in f32, one rounding to
    x's type. x (B, T, C), w (kw, C, N), b (N,) or None."""
    kw = w.shape[0]
    check_contract(kw, pad, dil)
    acc = None
    for j, tap in enumerate(_taps(x, pad, dil, kw)):
        d = tap @ w[j].float()
        acc = d if acc is None else acc + d
    if b is not None:
        acc = acc + b.float()
    return acc.to(x.dtype)


def conv1d_taps_wgrad_plain(x, dy, pad, dil, kw):
    """Weight gradient in plain PyTorch: (kw, C, N) f32."""
    check_contract(kw, pad, dil)
    C, N = x.shape[-1], dy.shape[-1]
    g = dy.float().reshape(-1, N)
    return torch.stack([tap.reshape(-1, C).t() @ g
                        for tap in _taps(x, pad, dil, kw)])


# ---------------------------------------------------------------------------
# kernel launches
# ---------------------------------------------------------------------------


def _check_cuda(name, *tensors):
    dt = tensors[0].dtype
    if dt not in _WGRAD_TILE:
        raise TypeError("%s: the kernel takes float32 or bfloat16, got %s"
                        % (name, dt))
    for t in tensors:
        if t.dtype != dt or t.device != tensors[0].device or t.dim() != 3:
            raise ValueError("%s: operands must be 3-D %s tensors on %s"
                             % (name, dt, tensors[0].device))
        if t.numel() == 0 or t.numel() >= 2 ** 31:
            raise ValueError("%s: operand of %d elements is outside 32-bit "
                             "indexing" % (name, t.numel()))


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _launch_fwd(x, wt, b, pl, dil):
    """y (B, T, N) from x (B, T, C) and wt (kw, N, C), taps laid out
    (out, in) so that each tap's reduction runs contiguous."""
    _check_cuda("conv1d_taps", x, wt)
    x, wt = x.contiguous(), wt.contiguous()
    B, T, C = x.shape
    kw, N, _ = wt.shape
    if wt.shape[2] != C:
        raise ValueError("conv1d_taps: weight (kw, N, %d) expected, got %s"
                         % (C, tuple(wt.shape)))
    bias = None if b is None else b.float().contiguous()
    if bias is not None and bias.shape != (N,):
        raise ValueError("conv1d_taps: bias of shape (%d,) expected" % N)
    y = torch.empty(B, T, N, dtype=x.dtype, device=x.device)
    is_bf16 = x.dtype == torch.bfloat16
    vec = int(C % 8 == 0 and _aligned(x, wt))
    dev = x.device
    rc = KERNEL.lib.dv3_conv_taps_fwd(
        x.data_ptr(), wt.data_ptr(), 0 if bias is None else bias.data_ptr(),
        y.data_ptr(), B, T, C, N, kw, dil, pl, int(is_bf16), vec,
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    KERNEL.launched("fwd")
    KERNEL.check(rc, "conv_taps forward launch")
    return y


def wgrad_splits(B, T, C, N, kw, dtype):
    """Row ranges for the weight gradient: enough blocks for two per SM,
    each range at least _MIN_ROWS_PER_SPLIT rows. Returns (splits,
    rows_per_split)."""
    tm, tn = _WGRAD_TILE[dtype]
    M = B * T
    blocks = -(-C // tm) * -(-N // tn) * kw
    splits = max(1, min(-(-_TARGET_BLOCKS // blocks),
                        M // _MIN_ROWS_PER_SPLIT, 65535 // kw))
    rows = -(-M // splits)
    return -(-M // rows), rows


def _launch_wgrad(x, dy, pad, dil, kw):
    _check_cuda("conv1d_taps wgrad", x, dy)
    x, dy = x.contiguous(), dy.contiguous()
    B, T, C = x.shape
    N = dy.shape[2]
    if dy.shape[:2] != x.shape[:2]:
        raise ValueError("conv1d_taps wgrad: dy %s does not match x %s"
                         % (tuple(dy.shape), tuple(x.shape)))
    splits, rows = wgrad_splits(B, T, C, N, kw, x.dtype)
    dev = x.device
    dw = torch.empty(kw, C, N, dtype=torch.float32, device=dev)
    part = (torch.empty(splits, kw, C, N, dtype=torch.float32, device=dev)
            if splits > 1 else None)
    is_bf16 = x.dtype == torch.bfloat16
    rc = KERNEL.lib.dv3_conv_taps_wgrad(
        x.data_ptr(), dy.data_ptr(), 0 if part is None else part.data_ptr(),
        dw.data_ptr(), B, T, C, N, kw, dil, pad[0], splits, rows,
        int(is_bf16), int(C % 8 == 0 and _aligned(x)),
        int(N % 8 == 0 and _aligned(dy)),
        torch.cuda.current_stream(dev).cuda_stream, dev.index or 0)
    KERNEL.launched("wgrad")
    KERNEL.check(rc, "conv_taps wgrad launch")
    return dw


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _device_kind(x):
    kind = x.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError("conv1d_taps: unsupported device %s" % x.device)
    return kind


def conv_fwd(x, w, b, pad, dil):
    """Forward of the convolution (no autograd). w (kw, C, N)."""
    if _device_kind(x) == "cpu":
        return conv1d_taps_plain(x, w, b, pad, dil)
    check_contract(w.shape[0], pad, dil)
    return _launch_fwd(x, w.transpose(1, 2), b, pad[0], dil)


def conv_dgrad(dy, w, pad, dil):
    """Input gradient: the forward on dy with taps flipped and transposed,
    padding mirrored. The kernel takes the taps as (kw, out, in), which for
    the flipped-transposed weight is flip(w, 0)."""
    mirrored = (pad[1], pad[0])
    if _device_kind(dy) == "cpu":
        return conv1d_taps_plain(dy, w.flip(0).transpose(1, 2), None,
                                 mirrored, dil)
    check_contract(w.shape[0], pad, dil)
    return _launch_fwd(dy, w.flip(0), None, mirrored[0], dil)


def conv_wgrad(x, dy, pad, dil, kw):
    """Weight gradient (kw, C, N) in f32."""
    if _device_kind(x) == "cpu":
        return conv1d_taps_wgrad_plain(x, dy, pad, dil, kw)
    check_contract(kw, pad, dil)
    return _launch_wgrad(x, dy, pad, dil, kw)


class _ConvTaps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, pad, dil):
        ctx.save_for_backward(x, w)
        ctx.pad, ctx.dil, ctx.b_dtype = pad, dil, \
            None if b is None else b.dtype
        return conv_fwd(x, w, b, pad, dil)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = conv_dgrad(dy, w, ctx.pad, ctx.dil)
        if ctx.needs_input_grad[1]:
            dw = conv_wgrad(x, dy, ctx.pad, ctx.dil, w.shape[0]).to(w.dtype)
        if ctx.b_dtype is not None and ctx.needs_input_grad[2]:
            db = dy.float().sum((0, 1)).to(ctx.b_dtype)
        return dx, dw, db, None, None


def conv1d_taps(x, w, b, pad, dil):
    """Differentiable tap-accumulated conv1d.

    x: (B, T, C)   w: (kw, C, N)   b: (N,) or None   pad: (pl, pr) with
    pl + pr == (kw - 1) * dil. Returns (B, T, N) in x's type."""
    return _ConvTaps.apply(x, w, b, tuple(pad), int(dil))
