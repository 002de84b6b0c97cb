# coding: utf-8
"""b2_roofline.batch (%): kernel B2's least time for the traced calls'
Griffin-Lim retrievals on its batch route (kernels/b2.py) over its device
time in the trace."""

from dv3bench import peaks
from dv3bench.kernels import b2


def read(ctx):
    if ctx.get("kind") != "batch":
        return None
    t, n = ctx["trace"].device_seconds(lambda name: bool(b2.PATTERN.search(name)))
    if n == 0 or t <= 0:
        return None
    cfg, hp = ctx["cfg"], ctx["hp"]
    up = cfg.r * cfg.converter.time_upsampling
    least = sum(peaks.bound_s(*b2.work(hp, B, steps * up), b2.PRECISION)
                for B, tk, steps, lengths in ctx["calls"])
    return 100.0 * least / t
