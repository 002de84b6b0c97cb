# coding: utf-8
"""device.idle_host_stages.batch (%): the share of the traced window with no
kernel running (as device.idle.batch counts it) inside tts_batch's spans
that the program opens as host stages (the frontend, the copy to the
device, the read of the decoded steps, the copies to the host, the per-row
results)."""

from dv3bench import spans


def read(ctx):
    return spans.idle_share(ctx, "host")
