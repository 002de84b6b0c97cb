# coding: utf-8
"""synth.mfu.nyanko (%): the traced window's nyanko synthesis operations
(counts_nyanko.py), each part at its own precision's published peak (the
encoder's highway stack, the converter with both transposed convs and the
decode in f32; Griffin-Lim in bf16), summed, over the window's seconds."""

from dv3bench import counts_nyanko, peaks


def read(ctx):
    if ctx.get("kind") != "batch" or not ctx["calls"] or \
            getattr(ctx.get("cfg"), "builder", None) != "nyanko":
        return None
    at_peak = 0.0
    for B, tk, steps, lengths in ctx["calls"]:
        for prec, f in counts_nyanko.synthesis_flops(
                ctx["cfg"], ctx["hp"], B, tk, steps, lengths).items():
            at_peak += f / peaks.FLOPS[prec]
    return 100.0 * at_peak / ctx["trace"].window_s
