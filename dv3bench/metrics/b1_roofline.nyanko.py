# coding: utf-8
"""b1_roofline.nyanko (%): kernel B1's least time for the traced calls'
nyanko decodes (kernels/b1_nyanko.py) over its device time in the trace."""

from dv3bench import peaks
from dv3bench.kernels import b1_nyanko


def read(ctx):
    if ctx.get("kind") != "batch" or \
            getattr(ctx.get("cfg"), "builder", None) != "nyanko":
        return None
    t, n = ctx["trace"].device_seconds(
        lambda name: bool(b1_nyanko.PATTERN.search(name)))
    if n == 0 or t <= 0:
        return None
    least = sum(peaks.bound_s(*b1_nyanko.work(ctx["cfg"], B, tk, steps,
                                              lengths), b1_nyanko.PRECISION)
                for B, tk, steps, lengths in ctx["calls"])
    return 100.0 * least / t
