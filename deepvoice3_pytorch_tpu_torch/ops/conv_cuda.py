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

On the card each launch takes one of two routes, chosen from the shape alone
(`route`, `fwd_plan`, `wgrad_plan`): the fast route (bf16: TMA + wgmma,
"wgmma"; f32: cp.async ring + FMA, "pipe") when C and N are multiples of 8
(bf16) or 4 (f32), else the simple kernels ("simple"). `KERNEL.by_entry`
counts each launch under "fwd_<route>" or "wgrad_<route>".
"""

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from .. import _build

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = _build.Kernel("conv_taps.cu", {
    "dv3_conv_taps_fwd": [_P, _P, _P, _P] + [_I] * 9 + [_P, _I],
    "dv3_conv_taps_wgrad": [_P, _P, _P, _P] + [_I] * 12 + [_P, _I],
    "dv3_conv_taps_fwd_fast": [_P, _P, _P, _P] + [_I] * 10 + [_P, _I],
    "dv3_conv_taps_wgrad_fast": [_P, _P, _P, _P] + [_I] * 11 + [_P, _I],
    "dv3_conv_taps_encode_ns": [_P, _I],
})

_SMS = 132                   # the H100's streaming multiprocessors
# Fast route per type: rows of C and N must be 16-byte multiples (TMA boxes
# for bf16, 16-byte cp.async for f32)
_FAST = {torch.float32: ("pipe", 4), torch.bfloat16: ("wgmma", 8)}
# fast tiles: forward (time steps, out channels); wgrad (C, N, rows a tile),
# as csrc/conv_taps.cu fixes them (bf16 GM x GN x GK, f32 PM x PWN x PK)
_FWD_TILE = {torch.float32: (128, 128), torch.bfloat16: (128, 256)}
_WGRAD_TILE = {torch.float32: (128, 128, 32), torch.bfloat16: (128, 128, 64)}
# ragged route's wgrad tiles (csrc/conv_taps.cu FM x FN, HM x HN)
_SIMPLE_WGRAD_TILE = {torch.float32: (128, 64), torch.bfloat16: (64, 64)}
_SIMPLE_TARGET_BLOCKS = 2 * _SMS
_MIN_ROWS_PER_SPLIT = 256
# bf16 wgrad: row tiles (64 rows each) summed in the tensor cores before
# each f32 add; see the kernel's note on drift
WGRAD_KBLOCK = 8


def _cdiv(a, b):
    return -(-a // b)


def route(C, N, dtype):
    """"wgmma" (bf16) or "pipe" (f32) when every row of the operands is a
    16-byte multiple, else "simple". From the shape alone."""
    name, q = _FAST[dtype]
    return name if C % q == 0 and N % q == 0 else "simple"


@functools.lru_cache(maxsize=256)
def fwd_plan(B, T, C, N, dtype):
    """(route, (tile rows, tile columns)) of a forward launch; x (B, T, C),
    N output channels. The wide tiles (bf16 128 x 256, f32 128 x 128, one
    block an SM) halve their columns where they would leave half the SMs
    idle."""
    r = route(C, N, dtype)
    if r == "simple":
        return r, (128, 64) if dtype == torch.float32 else (64, 64)
    tm, tn = _FWD_TILE[dtype]
    if 2 * B * _cdiv(T, tm) * _cdiv(N, tn) <= _SMS:
        tn //= 2
    return r, (tm, tn)


def _fast_splits(blocks, row_tiles, kw, min_tiles=4):
    """Row splits for the fast wgrad, one block an SM: the split count S
    that minimises the waves times the row tiles a block walks (plus two
    tiles of prologue and epilogue), each split at least `min_tiles`."""
    best = None
    for s in range(1, max(1, min(row_tiles // min_tiles, 65535 // kw)) + 1):
        per = _cdiv(row_tiles, s)
        cost = _cdiv(blocks * s, _SMS) * (per + 2)
        if best is None or cost < best[0]:
            best = (cost, s)
    s = best[1]
    per = _cdiv(row_tiles, s)
    return _cdiv(row_tiles, per), per


# per_split: row tiles a split (fast route) or rows (ragged route)
WgradPlan = collections.namedtuple("WgradPlan",
                                   "route tile splits per_split")


@functools.lru_cache(maxsize=256)
def wgrad_plan(B, T, C, N, kw, dtype):
    """Route, tile (C, N, rows), splits and rows of a weight-gradient
    launch (a WgradPlan)."""
    r = route(C, N, dtype)
    if r == "simple":
        tm, tn = _SIMPLE_WGRAD_TILE[dtype]
        M = B * T
        blocks = _cdiv(C, tm) * _cdiv(N, tn) * kw
        splits = max(1, min(_cdiv(_SIMPLE_TARGET_BLOCKS, blocks),
                            M // _MIN_ROWS_PER_SPLIT, 65535 // kw))
        rows = _cdiv(M, splits)
        return WgradPlan(r, (tm, tn, rows), _cdiv(M, rows), rows)
    tc, tn, rt = _WGRAD_TILE[dtype]
    blocks = _cdiv(C, tc) * _cdiv(N, tn) * kw
    splits, per = _fast_splits(blocks, B * _cdiv(T, rt), kw)
    return WgradPlan(r, (tc, tn, rt), splits, per)


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
    if dt not in _FAST:
        raise TypeError("%s: the kernel takes float32 or bfloat16, got %s"
                        % (name, dt))
    for t in tensors:
        if t.dtype != dt or t.device != tensors[0].device or t.dim() != 3:
            raise ValueError("%s: operands must be 3-D %s tensors on %s"
                             % (name, dt, tensors[0].device))
        if t.numel() == 0 or t.numel() >= 2 ** 31:
            raise ValueError("%s: operand of %d elements is outside 32-bit "
                             "indexing" % (name, t.numel()))


def _dense(t):
    """t contiguous and 16-byte aligned (a view at an odd offset is
    copied): what the fast route's loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# weight layouts of the fast forward (csrc/conv_taps.cu w_layout)
_OUT_IN, _TAPS_REVERSED, _IN_OUT = 0, 1, 2


def _launch_fwd(x, w, b, pl, dil, dgrad=False, tile_n=None):
    """y (B, T, N) from x (B, T, C) and the layer's weight w (kw, C, N)
    (forward), or the input gradient from dy = x (B, T, N) and the same w
    (dgrad: the taps flipped and transposed, returning (B, T, C)). Each
    route reads w as it needs it: the ragged route and the f32 forward copy
    it to (kw, out, in); the f32 dgrad reads its taps in reverse; bf16 reads
    w in place either way. tile_n: the fast route's tile columns
    (fwd_plan's by default)."""
    _check_cuda("conv1d_taps", x, w)
    B, T, C = x.shape
    kw = w.shape[0]
    N = w.shape[1] if dgrad else w.shape[2]
    if w.shape[2 if dgrad else 1] != C:
        raise ValueError("conv1d_taps: weight of %s for input channels %d"
                         % (tuple(w.shape), C))
    bias = None if b is None else b.float().contiguous()
    if bias is not None and bias.shape != (N,):
        raise ValueError("conv1d_taps: bias of shape (%d,) expected" % N)
    r, (_, tn) = fwd_plan(B, T, C, N, x.dtype)
    tn = tn if tile_n is None else tile_n
    is_bf16 = int(x.dtype == torch.bfloat16)
    if r == "simple" or not (dgrad or is_bf16):
        wt, layout = (w.flip(0) if dgrad else w.transpose(1, 2)), _OUT_IN
    else:
        wt, layout = w, _TAPS_REVERSED if dgrad else _IN_OUT
    x, wt = _dense(x), _dense(wt)
    y = torch.empty(B, T, N, dtype=x.dtype, device=x.device)
    dev = x.device
    args = (x.data_ptr(), wt.data_ptr(),
            0 if bias is None else bias.data_ptr(), y.data_ptr(),
            B, T, C, N, kw, dil, pl, is_bf16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if r == "simple":
        rc = KERNEL.lib.dv3_conv_taps_fwd(
            *args, int(C % 8 == 0), stream, dev.index or 0)
    else:
        rc = KERNEL.lib.dv3_conv_taps_fwd_fast(*args, tn, layout, stream,
                                               dev.index or 0)
    KERNEL.check(rc, "conv_taps forward launch (%s route)" % r)
    KERNEL.launched("fwd_" + r)
    return y


def _launch_wgrad(x, dy, pad, dil, kw, kblock=None):
    """dw (kw, C, N) f32. kblock: row tiles a wgmma partial sum (bf16 fast
    route; WGRAD_KBLOCK by default)."""
    _check_cuda("conv1d_taps wgrad", x, dy)
    B, T, C = x.shape
    N = dy.shape[2]
    if dy.shape[:2] != x.shape[:2]:
        raise ValueError("conv1d_taps wgrad: dy %s does not match x %s"
                         % (tuple(dy.shape), tuple(x.shape)))
    plan = wgrad_plan(B, T, C, N, kw, x.dtype)
    r, splits = plan.route, plan.splits
    x, dy = _dense(x), _dense(dy)
    dev = x.device
    dw = torch.empty(kw, C, N, dtype=torch.float32, device=dev)
    part = (torch.empty(splits, kw, C, N, dtype=torch.float32, device=dev)
            if splits > 1 else None)
    is_bf16 = int(x.dtype == torch.bfloat16)
    args = (x.data_ptr(), dy.data_ptr(),
            0 if part is None else part.data_ptr(), dw.data_ptr(),
            B, T, C, N, kw, dil, pad[0], splits, plan.per_split, is_bf16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if r == "simple":
        rc = KERNEL.lib.dv3_conv_taps_wgrad(
            *args, int(C % 8 == 0), int(N % 8 == 0), stream, dev.index or 0)
    else:
        rc = KERNEL.lib.dv3_conv_taps_wgrad_fast(
            *args, WGRAD_KBLOCK if kblock is None else kblock, stream,
            dev.index or 0)
    KERNEL.check(rc, "conv_taps wgrad launch (%s route)" % r)
    KERNEL.launched("wgrad_" + r)
    return dw


def encode_ms(x, reps=200):
    """Host ms of one TMA descriptor encode (mean over `reps`), on the
    device buffer of x, after one untimed encode; a bf16 launch encodes
    two."""
    KERNEL.lib.dv3_conv_taps_encode_ns(x.data_ptr(), 1)
    ns = KERNEL.lib.dv3_conv_taps_encode_ns(x.data_ptr(), reps)
    KERNEL.check(-ns if ns < 0 else 0, "tensor map encode")
    return ns / reps / 1e6


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
    return _launch_fwd(x, w, b, pad[0], dil)


def conv_dgrad(dy, w, pad, dil):
    """Input gradient: the forward on dy with taps flipped and transposed,
    padding mirrored. In (kw, out, in) form, as the kernel reads taps, the
    flipped-transposed weight is flip(w, 0): w's taps read in reverse."""
    mirrored = (pad[1], pad[0])
    if _device_kind(dy) == "cpu":
        return conv1d_taps_plain(dy, w.flip(0).transpose(1, 2), None,
                                 mirrored, dil)
    check_contract(w.shape[0], pad, dil)
    return _launch_fwd(dy, w, None, mirrored[0], dil, dgrad=True)


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
            db = dy.sum((0, 1), dtype=torch.float32).to(ctx.b_dtype)
        return dx, dw, db, None, None


def conv1d_taps(x, w, b, pad, dil):
    """Differentiable tap-accumulated conv1d.

    x: (B, T, C)   w: (kw, C, N)   b: (N,) or None   pad: (pl, pr) with
    pl + pr == (kw - 1) * dil. Returns (B, T, N) in x's type."""
    return _ConvTaps.apply(x, w, b, tuple(pad), int(dil))
