# coding: utf-8
"""synth.to_host.batch (%): the share of the traced window that tts_batch's
copies of its results to the host take: the time with no kernel running
(as device.idle.batch counts it: the copies are not kernels) inside the
program's `dv3.tts.to_host` spans, the six `.cpu().numpy()`. The first
`.cpu()` waits for the converter and Griffin-Lim still queued on the
stream; that wait has kernels running and is left out."""

from dv3bench import spans


def read(ctx):
    return spans.span_idle_share(ctx, "dv3.tts.to_host")
