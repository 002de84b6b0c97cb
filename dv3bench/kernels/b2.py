# coding: utf-8
"""Kernel B2, Griffin-Lim (csrc/griffin_lim.cu): the device names of its
batch route (a launch a step: TMA + wgmma GEMMs, and its start, spectrum
and overlap-add kernels), and the operations and bytes of a retrieval."""

import re

PATTERN = re.compile(r"\b(gemm_batch|init_kernel|ola_kernel|spec_kernel)\b")
PRECISION = "bfloat16"




def work(hp, B, n):
    """(operations, bytes) of a Griffin-Lim retrieval of B rows of n frames:
    two DFT products per iteration and a last synthesis, (B n) x 2F x fft
    each; bytes: the magnitudes read once, the waveform written once."""
    fft, hop = hp["fft_size"], hp["hop_size"]
    F = fft // 2 + 1
    flops = (2 * hp["griffin_lim_iters"] + 1) * 2.0 * B * n * 2 * F * fft
    nbytes = 4 * (B * n * F + B * (n + fft // hop - 1) * hop)
    return flops, nbytes
