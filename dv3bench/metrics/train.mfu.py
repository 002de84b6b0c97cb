# coding: utf-8
"""train.mfu (%): the traced steps' operations (forward, backward as twice
the forward's products, Adam; counts.train_step_flops) at the f32 peak,
over the traced window's seconds."""

from dv3bench import counts, peaks


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    flops = sum(counts.train_step_flops(ctx["cfg"], B, tk, t_dec,
                                        ctx["trained"])
                for B, tk, t_dec in ctx["steps"])
    return 100.0 * flops / peaks.FLOPS["float32"] / ctx["trace"].window_s
