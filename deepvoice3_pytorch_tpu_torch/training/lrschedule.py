# coding: utf-8
"""Learning-rate schedules, counterpart of
deepvoice3_pytorch_tpu/training/lrschedule.py. Each takes the step as an int
and returns a 0-d f32 tensor, computed in f32 in the JAX package's order."""

import math

import torch


def _f32(v):
    return torch.as_tensor(v, dtype=torch.float32)


def noam_learning_rate_decay(init_lr, global_step, warmup_steps=4000):
    warmup_steps = float(warmup_steps)
    step = _f32(global_step) + 1.0
    return init_lr * warmup_steps ** 0.5 * torch.minimum(
        step * warmup_steps ** -1.5, step ** -0.5)


def step_learning_rate_decay(init_lr, global_step, anneal_rate=0.98,
                             anneal_interval=30000):
    return init_lr * _f32(anneal_rate) ** _f32(global_step // anneal_interval)


def cyclic_cosine_annealing(init_lr, global_step, T, M):
    """Cyclic cosine annealing (arXiv:1704.00109)."""
    TdivM = T // M
    return init_lr / 2.0 * (
        torch.cos(math.pi * _f32((global_step - 1) % TdivM) / TdivM) + 1.0)


def constant_learning_rate(init_lr, global_step):
    return init_lr * torch.ones((), dtype=torch.float32)


def get_schedule(name, init_lr, **kwargs):
    fn = globals()[name]
    return lambda step: fn(init_lr, step, **kwargs)
