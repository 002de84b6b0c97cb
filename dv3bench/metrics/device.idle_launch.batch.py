# coding: utf-8
"""device.idle_launch.batch (%): the share of the traced window with no
kernel running inside tts_batch's spans that the program opens as device
stages (encoder, decode, converter, Griffin-Lim, denormalize), where the
device waits for the host to launch its next operation."""

from dv3bench import spans


def read(ctx):
    return spans.idle_share(ctx, "device")
