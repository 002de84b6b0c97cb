# coding: utf-8
"""b1_roofline.batch (%): kernel B1's least time for the traced calls'
decodes (kernels/b1.py) over its device time in the trace."""

from dv3bench import peaks
from dv3bench.kernels import b1


def read(ctx):
    if ctx.get("kind") != "batch":
        return None
    t, n = ctx["trace"].device_seconds(lambda name: bool(b1.PATTERN.search(name)))
    if n == 0 or t <= 0:
        return None
    least = sum(peaks.bound_s(*b1.work(ctx["cfg"], B, tk, steps, lengths),
                              b1.PRECISION)
                for B, tk, steps, lengths in ctx["calls"])
    return 100.0 * least / t
