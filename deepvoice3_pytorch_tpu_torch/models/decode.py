# coding: utf-8
"""The done rule of the autoregressive decode, counterpart of
deepvoice3_pytorch_tpu/models/decode.py (`decode_scan` / `decode_while`).
The loop itself is ops/fused_decode's host loop, over the kernel on the card
and over `PlainDecoder` (the eager step) on the CPU.

Done rule (reference deepvoice3.py:469-473): frame t is always emitted; a
sample is finished once done > 0.5 with t+1 > min_decoder_steps. With
early_exit the loop checks the latch every `chunk` frames and stops after
the first chunk in which every sample has finished, leaving the later frames
zero (the JAX while loop is chunk=1). Without early_exit it runs every
chunk, as the scan does.
"""

from typing import Any, NamedTuple

import torch


class DecodeLoopOut(NamedTuple):
    outputs: Any          # (B, T, out_dim)
    alignments: Any       # (B, T, T_k) averaged over attention layers
    done: Any             # (B, T) raw done probabilities
    decoder_states: Any   # (B, T, C)
    lengths: Any          # (B,) int32 frames up to and including the done frame
    num_steps: int        # frames actually computed


def _length_from_done(done_seq, min_steps, num_steps):
    """Per-sample decoded length: first frame where done > 0.5 and
    t+1 > min_steps (inclusive), else num_steps."""
    T = done_seq.shape[1]
    t = torch.arange(T, device=done_seq.device)[None, :]
    flag = (done_seq > 0.5) & ((t + 1) > min_steps)
    first = torch.argmax(flag.to(torch.int32), dim=1) + 1
    return torch.where(flag.any(dim=1), first,
                       torch.full_like(first, num_steps)).to(torch.int32)


def chunk_latch(done_chunk, t0, min_steps):
    """(B,) True where a sample's done flag fired inside this chunk of
    frames t0 .. t0 + chunk - 1."""
    gstep = t0 + torch.arange(1, done_chunk.shape[1] + 1,
                              device=done_chunk.device)
    return ((done_chunk > 0.5) & (gstep[None, :] > min_steps)).any(dim=1)
