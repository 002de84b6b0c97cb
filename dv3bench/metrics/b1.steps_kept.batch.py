# coding: utf-8
"""b1.steps_kept.batch (%): of the decode steps kernel B1's launches ran in
the traced window (counter `b1.steps_run`), the share that the decodes
returned (`b1.steps_kept`): the rest are steps past a decode's max_steps
that a whole last chunk ran and the decode dropped. None where the
program keeps no such counters."""

from dv3bench import spans


def read(ctx):
    r = spans.reading(ctx)
    if r is None:
        return None
    c = r["counters"]
    if not c.get("b1.steps_run") or "b1.steps_kept" not in c:
        return None
    return 100.0 * c["b1.steps_kept"] / c["b1.steps_run"]
