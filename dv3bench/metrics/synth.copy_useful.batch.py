# coding: utf-8
"""synth.copy_useful.batch (%): of the bytes tts_batch copied to the host
in the traced window (counter `tts.bytes_to_host`), the share its callers
get back in the trimmed results (`tts.bytes_kept`)."""

from dv3bench import spans


def read(ctx):
    r = spans.reading(ctx)
    if r is None:
        return None
    c = r["counters"]
    if not c.get("tts.bytes_to_host"):
        return None
    return 100.0 * c.get("tts.bytes_kept", 0) / c["tts.bytes_to_host"]
