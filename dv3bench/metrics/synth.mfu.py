# coding: utf-8
"""synth.mfu (%): the traced window's synthesis operations, each part at
its own precision's published peak (encoder, key/value projections,
converter and the decode in f32; Griffin-Lim in bf16), summed, over the
window's seconds."""

from dv3bench import counts, peaks


def read(ctx):
    if ctx.get("kind") != "batch" or not ctx["calls"]:
        return None
    at_peak = 0.0
    for B, tk, steps, lengths in ctx["calls"]:
        for prec, f in counts.synthesis_flops(ctx["cfg"], ctx["hp"], B, tk,
                                              steps, lengths).items():
            at_peak += f / peaks.FLOPS[prec]
    return 100.0 * at_peak / ctx["trace"].window_s
