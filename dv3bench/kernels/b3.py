# coding: utf-8
"""Kernel B3, the tap-accumulating convolution (csrc/conv_taps.cu): the
device names of its forward, input-gradient and weight-gradient routes,
and the operations and bytes of a train step's kw > 1 convolutions."""

import re

PATTERN = re.compile(r"\b(fwd_f32_pipe|wgrad_f32_pipe|fwd_bf16_wgmma|"
                     r"wgrad_bf16_wgmma|fwd_f32_simple|wgrad_f32_simple|"
                     r"fwd_bf16_simple|wgrad_bf16_simple|sum_splits)\b")
PRECISION = "float32"




def kw_convs(cfg, B, Tk, T_dec):
    """(B T, in, out, kw, dilation) of every kw > 1 conv of the forward."""
    out = []

    def walk(specs, T):
        for s in specs:
            n_out = s.out_channels * (2 if s.kind in ("glu", "highway")
                                      else 1)
            if s.kind != "convT" and s.kernel_size > 1:
                out.append((B * T, s.in_channels, n_out, s.kernel_size))
            if s.kind == "convT":
                T = T * s.stride
        return T

    walk(cfg.encoder.specs, Tk)
    walk(cfg.decoder.prenet_specs, T_dec)
    walk(cfg.decoder.conv_specs, T_dec)
    walk(cfg.converter.specs, T_dec * cfg.r)
    return out


def work(cfg, B, Tk, T_dec):
    """(operations, bytes) of the forward, input-gradient and weight-
    gradient passes of every kw > 1 conv at f32: each 2 (B T) kw in out;
    bytes: each pass's two inputs read once and its output written once."""
    flops = nbytes = 0
    for rows, cin, cout, kw in kw_convs(cfg, B, Tk, T_dec):
        flops += 3 * 2.0 * rows * kw * cin * cout
        x, w, y = rows * cin, kw * cin * cout, rows * cout
        nbytes += 4 * ((x + w + y) + (y + w + x) + (x + y + w))
    return flops, nbytes
