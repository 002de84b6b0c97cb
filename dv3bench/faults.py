# coding: utf-8
"""Faults planted under a cell's timed path, to show that `correct` comes
out false: the tests plant each at tiny sizes on the CPU, and control.py
(`--fault`) reads them at a cell's own size on the card. Each wraps the
port's entry: tts_batch for the batch_synthesis kind, the train step for
train_step."""

import numpy as np
import torch


def batch_altered_frame(tts_batch):
    """An answer altered where it is produced: one frame of one row."""
    def call(*a, **kw):
        res = tts_batch(*a, **kw)
        res[1]["mel"] = res[1]["mel"].copy()
        res[1]["mel"][3] += 5.0       # dB
        return res
    return call


def batch_half_rows(tts_batch):
    """Half of the batch left out, the other half standing in for it."""
    def call(params, cfg, ap, fe, texts, *, speaker_ids=None, **kw):
        h = len(texts) // 2
        res = tts_batch(params, cfg, ap, fe, texts[:h], speaker_ids=None
                        if speaker_ids is None else speaker_ids[:h], **kw)
        return res + res[:len(texts) - h]
    return call


def batch_stuck_state(tts_batch):
    """The decoder's state never advances: every frame is the first."""
    def call(*a, **kw):
        res = tts_batch(*a, **kw)
        for r in res:
            r["mel"] = np.repeat(r["mel"][:1], len(r["mel"]), axis=0)
        return res
    return call


def train_unchanged(step):
    """A step that returns its state unchanged."""
    def run(state, batch, gen):
        one = torch.ones((), device=batch["x"].device)
        return state, {"loss": one, "grad_norm": one}
    return run


def train_half_rows(step):
    """Half of the batch left out, the mean taken over the rest."""
    def run(state, batch, gen):
        h = batch["x"].shape[0] // 2
        return step(state, {k: v[:h] for k, v in batch.items()}, gen)
    return run


def train_altered_loss(step):
    """The step's loss altered where it is produced."""
    def run(state, batch, gen):
        state, metrics = step(state, batch, gen)
        metrics = dict(metrics, loss=metrics["loss"] * 1.01)
        return state, metrics
    return run


BY_KIND = {
    "batch_synthesis": ("call_fault", {
        "altered_frame": batch_altered_frame, "half_rows": batch_half_rows,
        "stuck_state": batch_stuck_state}),
    "train_step": ("step_fault", {
        "unchanged": train_unchanged, "half_rows": train_half_rows,
        "altered_loss": train_altered_loss}),
}
