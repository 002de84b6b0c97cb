# coding: utf-8
"""train.launches_per_step (launches): device kernels in the traced window
over the steps it ran (copies and sets not counted)."""


def read(ctx):
    if ctx.get("kind") != "train" or not ctx["steps"]:
        return None
    return len(ctx["trace"].kernels()) / len(ctx["steps"])
