# coding: utf-8
"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
at the full 700 W power limit). Every roofline and mfu share is stated
against these, with the card's power limit beside it."""

FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
         "float16": 989e12, "fp8": 1979e12}
BYTES_PER_S = 3.35e12
MEMORY_BYTES = 80e9


def bound_s(flops, nbytes, dtype):
    """Least time for the work: the larger of its operations at the peak of
    `dtype` and its bytes at the memory's peak."""
    return max(flops / FLOPS[dtype], nbytes / BYTES_PER_S)
