# coding: utf-8
"""synth.copy_pinned.batch (%): of the bytes tts_batch copied to the host
in the traced window (counter `tts.bytes_to_host`), the share that landed
in page-locked memory (`tts.bytes_pinned`): how often the copies into
pinned host memory engage. None where the program keeps no such counter."""

from dv3bench import spans


def read(ctx):
    r = spans.reading(ctx)
    if r is None:
        return None
    c = r["counters"]
    if not c.get("tts.bytes_to_host") or "tts.bytes_pinned" not in c:
        return None
    return 100.0 * c["tts.bytes_pinned"] / c["tts.bytes_to_host"]
