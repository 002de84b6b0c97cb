# coding: utf-8
"""b1.highway.nyanko (%): of kernel B1's launch time in the traced window
(block 0's stamps), the share spent in its HIGHWAY stages: each one's
work and the grid barrier wait after it. Reads the window's split by
stage kind (`Window.b1_split()["kinds"]`), which the program keeps while
the profiler records; None where it keeps none."""

from dv3bench import spans


def read(ctx):
    r = spans.reading(ctx)
    if r is None:
        return None
    split = r["window"].b1_split()
    if not split or split["launch_ns"] <= 0 or "kinds" not in split:
        return None
    hw = split["kinds"].get("HIGHWAY")
    if hw is None:
        return None
    return 100.0 * (hw["work_ns"] + hw["barrier_ns"]) / split["launch_ns"]
