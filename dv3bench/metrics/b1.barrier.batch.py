# coding: utf-8
"""b1.barrier.batch (%): of kernel B1's launch time in the traced window,
the share block 0 spent waiting at the grid barriers after its stages
(from its work done to the barrier passed), from the kernel's own stamps,
which the program has B1 write while the profiler records."""

from dv3bench import spans


def read(ctx):
    r = spans.reading(ctx)
    if r is None:
        return None
    split = r["window"].b1_split()
    if not split or split["launch_ns"] <= 0:
        return None
    return 100.0 * split["barrier_ns"] / split["launch_ns"]
