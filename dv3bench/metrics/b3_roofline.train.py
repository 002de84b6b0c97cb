# coding: utf-8
"""b3_roofline.train (%): kernel B3's least time for the traced steps'
kw > 1 convolutions, forward, input and weight gradients
(kernels/b3.py), over its device time in the trace."""

from dv3bench import peaks
from dv3bench.kernels import b3


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    t, n = ctx["trace"].device_seconds(lambda name: bool(b3.PATTERN.search(name)))
    if n == 0 or t <= 0:
        return None
    least = sum(peaks.bound_s(*b3.work(ctx["cfg"], B, tk, t_dec),
                              b3.PRECISION)
                for B, tk, t_dec in ctx["steps"])
    return 100.0 * least / t
