# coding: utf-8
"""device.idle.train (%): the share of the traced window in which no
kernel ran on the device (copies count as idle: they are listed apart
in the breakdown's device_ops), in the training cells."""


def read(ctx):
    if ctx.get("kind") != "train":
        return None
    tr = ctx["trace"]
    return 100.0 * max(0.0, tr.window_s - tr.kernel_busy_s) / tr.window_s
