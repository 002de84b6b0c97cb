# coding: utf-8
"""Traffic kind `train_step`: the port's train step
(`training.trainer.make_train_step`) on a cycled pool of padded batches.

Set-up builds one train state from the seeded weights and drives it, through
the window's own call, over every batch of the pool once (every shape the
window will use): the first `reference_steps` of those steps are the ones
the reference follows, on rows that all differ. The window then runs step
after step, cycling the pool, until `seconds` have passed, and ends in a
synchronise; `train_step_ms` is its wall ms over the steps it completed.
The window ends on a whole pass over the pool.
The traced run profiles `trace_steps` steps instead.

The batches are made as the training collate makes them (text padded to
length_bucket_step, frames to frame_bucket_step decoder groups after r
leading pad groups, the mel downsampled), with random normalised mel and
linear targets drawn on the device and done flags from the lengths."""

import gc
import math
import os
import time

import numpy as np
import torch

from .. import generate
from ..reference import synthesis as ref_synthesis
from ..reference import text as ref_text
from ..reference import train as ref_train
from . import common


def _round_up(n, k):
    return -(-n // k) * k


def make_batches(traffic, seed, hp, device):
    """The pool: `pool_batches` batches of `batch` rows each, every batch a
    dict of tensors on `device`. Batch j holds the utterances j, j + P, ...
    of the ascending pool, so every batch spans the distribution."""
    P, B = traffic["pool_batches"], traffic["batch"]
    utts = generate.utterances(traffic, seed, P * B)
    r, ds = hp["outputs_per_step"], hp["downsample_step"]
    fps = hp["sample_rate"] / hp["hop_size"]
    gen = torch.Generator(device=device)
    gen.manual_seed(common.weight_seed(seed) ^ 0x5EED)
    out = []
    for j in range(P):
        rows = [utts[j + P * i] for i in range(B)]
        order = generate.rng(seed, 100 + j).permutation(B)
        rows = [rows[i] for i in order]
        ids = [ref_text.text_to_ids(t) for _, t, _ in rows]
        t_len = [_round_up(int(math.ceil(d * fps)), r * ds)
                 for d, _, _ in rows]
        max_in = _round_up(max(len(s) for s in ids),
                           hp["length_bucket_step"])
        max_t = _round_up(_round_up(max(t_len), r), ds) + r * ds
        max_t = _round_up(max_t, hp["frame_bucket_step"] * ds * r)
        x = np.zeros((B, max_in), np.int64)
        tpos = np.zeros((B, max_in), np.int64)
        for i, s in enumerate(ids):
            x[i, :len(s)] = s
            tpos[i, :len(s)] = np.arange(1, len(s) + 1)
        off = r * ds
        frame = torch.arange(max_t, device=device)[None, :]
        valid = ((frame >= off) & (frame < off + torch.tensor(
            t_len, device=device)[:, None])).float()[..., None]
        mel = torch.rand(B, max_t, hp["num_mels"], generator=gen,
                         device=device) * valid
        lin = torch.rand(B, max_t, hp["fft_size"] // 2 + 1, generator=gen,
                         device=device) * valid
        n_dec = max_t // r // ds
        done = np.ones((B, n_dec, 1), np.float32)
        for i, t in enumerate(t_len):
            done[i, :t // r // ds - 1] = 0.0
        batch = {
            "x": torch.from_numpy(x).to(device),
            "input_lengths": torch.tensor([len(s) for s in ids],
                                          device=device),
            "mel": mel[:, ::ds].contiguous(),
            "y": lin,
            "text_positions": torch.from_numpy(tpos).to(device),
            "frame_positions": torch.arange(1, n_dec + 1, device=device)
            .repeat(B, 1),
            "done": torch.from_numpy(done).to(device),
            "target_lengths": torch.tensor(t_len, device=device),
        }
        if rows[0][2] is not None:
            batch["speaker_ids"] = torch.tensor([s for _, _, s in rows],
                                                device=device)
        out.append(batch)
    return out


def dropout_seed(seed):
    return common.weight_seed(seed) ^ 0xD809


def run(hp, traffic, seed, seconds, trace, device, window_started,
        control=False, step_fault=None):
    """control: also read the control (control.py); step_fault: wraps the
    port's step (the tests plant faults there)."""
    from deepvoice3_pytorch_tpu_torch.training import trainer

    php, cfg_p, cfg_r = common.configs(hp)
    params = common.port_params(common.weights(cfg_r, seed, device))
    lc = trainer.loss_config_from_hparams(php)
    opt = trainer.make_optimizer(php, trainer.make_lr_fn(php))
    step = trainer.make_train_step(
        cfg_p, lc, opt, trainer.trainable_mask(params, cfg_p),
        compute_dtype=getattr(torch, hp["compute_dtype"]))
    if step_fault is not None:
        step = step_fault(step)
    state = trainer.init_train_state(params, opt)
    batches = make_batches(traffic, seed, hp, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(dropout_seed(seed))
    n_ref = traffic["reference_steps"]

    losses, first_mu, after = [], None, None
    n_steps = 0

    def run_step():
        nonlocal state, n_steps
        state, metrics = step(state, batches[n_steps % len(batches)], gen)
        n_steps += 1
        return metrics

    for i in range(len(batches)):           # every shape, once
        m = run_step()
        if i < n_ref:
            losses.append(m["loss"].detach().clone())
        if i == 0:
            first_mu = {k: v.clone() for k, v in state.opt_state.mu.items()}
            first_norm = float(m["grad_norm"])
        if i == n_ref - 1:
            after = {k: v.detach().clone()
                     for k, v in state.params.named_parameters()}
    common.synchronize(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    window_started()

    passes = []

    def window(n_max=None):
        t0 = time.perf_counter()
        n0 = n_steps
        while True:
            run_step()
            if n_steps % len(batches) == 0:
                passes.append(time.perf_counter() - t0)
            if n_max is not None:
                if n_steps - n0 >= n_max:
                    break
            elif (time.perf_counter() - t0 >= seconds
                  and n_steps % len(batches) == 0):
                break               # whole passes over the pool
        common.synchronize(device)
        return time.perf_counter() - t0, n_steps - n0

    out = {}
    if trace:
        from .. import trace as trace_lib
        first = n_steps
        (_, n), tr = trace_lib.profiled(
            torch, lambda: window(
            traffic["trace_steps"]),
            cuda=torch.device(device).type == "cuda")
        shapes = [_step_shape(batches[i % len(batches)])
                  for i in range(first, first + n)]
        out["trace"] = {"kind": "train", "trace": tr, "cfg": cfg_r, "hp": hp,
                        "steps": shapes,
                        "trained": lambda k: ref_train.trained(k, cfg_r)}
    else:
        cpu0 = os.times()
        window_s, n = window()
        cpu1 = os.times()
        out["metrics"] = {"train_step_ms": window_s * 1e3 / n}
        # the host's CPU seconds over the window's: near 1 where the step
        # is bound by the host's launches
        out["host_cpu_share"] = ((cpu1.user - cpu0.user)
                                 + (cpu1.system - cpu0.system)) / window_s
    out["memory_peak"] = common.memory_peak(device)
    out["attempted"] = n
    # the gradient the optimizer (the clip, then Adam) was given: Adam's
    # first moment after one step is (1 - b1) times the clipped gradient,
    # and the clip scaled it by clip / grad_norm where grad_norm >= clip
    unclip = max(1.0, first_norm / hp["clip_thresh"]) \
        if hp["clip_thresh"] > 0 else 1.0
    program = {"losses": [float(v) for v in losses],
               "first_grad": {k: v * (unclip / (1.0 - hp["adam_beta1"]))
                              for k, v in first_mu.items()},
               "after": after}
    del state, params, step, batches
    common.free(device)
    out["numbers"], out["notes"] = judge(hp, cfg_r, traffic, seed, device,
                                         program)
    out["notes"]["pass_s"] = [b - a for a, b in zip([0.0] + passes, passes)]
    out["notes"]["host_cpu_share"] = out.pop("host_cpu_share", None)
    if control:
        out["control_numbers"] = control_numbers(hp, cfg_r, traffic, seed,
                                                 device)
    return out


def reference_program(hp, cfg_r, traffic, seed, device, precision):
    """The reference's first steps at `precision`, shaped as the program's
    readings (the control puts them in the program's place)."""
    from ..reference import params as ref_params
    flat = ref_params.flatten(common.weights(cfg_r, seed, device))
    batches = make_batches(traffic, seed, hp, device)[
        :traffic["reference_steps"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(dropout_seed(seed))
    with ref_synthesis.precision(precision):
        losses, grad, after = ref_train.run_steps(
            flat, cfg_r, hp, batches, gen, traffic["reference_steps"])
    return {"losses": losses, "first_grad": grad, "after": after}


def control_numbers(hp, cfg_r, traffic, seed, device):
    """The control: the reference in TF32, one precision below the
    configuration's f32, judged as the program is."""
    low = reference_program(hp, cfg_r, traffic, seed, device, "tf32")
    return judge(hp, cfg_r, traffic, seed, device, low)[0]


def _step_shape(batch):
    """(rows, padded text length, decoder frames) of a step."""
    B, tk = batch["x"].shape
    return B, tk, batch["done"].shape[1]


def judge(hp, cfg_r, traffic, seed, device, program, precision="f32"):
    """The reference's first steps from the same weights, batches and
    dropout generator, and the numbers compared:
      loss_gap    the widest relative gap of the steps' losses;
      grad_gap    the median over leaves of the gap between the norms of
                  the first step's gradient as the optimizer was given it
                  (before the clip), each against the reference leaf's
                  norm or the median leaf's, whichever is larger (the
                  worst leaf's is in the notes);
      change_gap  the same for the parameters' change over the steps,
                  over the leaves whose first reference gradient is at
                  least a thousandth of the median leaf's (the rest move
                  under Adam by round-off alone);
      frozen_moved  leaves the reference leaves alone that moved."""
    n_ref = traffic["reference_steps"]
    tree = common.weights(cfg_r, seed, device)
    from ..reference import params as ref_params
    flat = ref_params.flatten(tree)
    start = {k: v.clone() for k, v in flat.items()}
    batches = make_batches(traffic, seed, hp, device)[:n_ref]
    gen = torch.Generator(device=device)
    gen.manual_seed(dropout_seed(seed))
    with ref_synthesis.precision(precision):
        losses, grad, after = ref_train.run_steps(flat, cfg_r, hp, batches,
                                                  gen, n_ref)
    return compare(program, losses, grad, after, start)


def compare(program, losses, grad, after, start):
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(program["losses"], losses))
    gn_ref = {k: float(torch.linalg.vector_norm(v)) for k, v in grad.items()}
    gn_prog = {k: float(torch.linalg.vector_norm(program["first_grad"][k]))
               if k in program["first_grad"] else 0.0 for k in grad}
    med_g = float(np.median(list(gn_ref.values())))
    leaf_gap = {k: abs(gn_prog[k] - gn_ref[k]) / max(gn_ref[k], med_g)
                for k in grad}
    # the worst leaf is nearly always one of the decoder's 16 -> 1
    # position-rate projections (speaker_proj1 / 2), whose gradient sums
    # cancelling terms over every frame and key: its rounding swings from
    # seed to seed, so the median leaf's gap is compared and the worst
    # reported
    grad_gap = float(np.median(list(leaf_gap.values())))
    moved = [k for k in grad if gn_ref[k] >= 1e-3 * med_g]
    dn_ref = {k: float(torch.linalg.vector_norm(after[k] - start[k]))
              for k in moved}
    dn_prog = {k: float(torch.linalg.vector_norm(
        program["after"][k] - start[k])) for k in moved}
    med_d = float(np.median(list(dn_ref.values())))
    change_gap = max(abs(dn_prog[k] - dn_ref[k]) / max(dn_ref[k], med_d)
                     for k in moved)
    frozen = [k for k in start if k not in grad]
    frozen_moved = sum(int(not torch.equal(program["after"][k], start[k]))
                       for k in frozen)
    numbers = {"loss_gap": loss_gap, "grad_gap": grad_gap,
               "change_gap": change_gap, "frozen_moved": frozen_moved}
    worst_g = sorted(grad, key=lambda k: -leaf_gap[k])[:3]
    notes = {"grad_gap_worst_leaf": leaf_gap[worst_g[0]],
             "worst_grad_leaves": [(k, gn_ref[k], gn_prog[k] - gn_ref[k])
                                   for k in worst_g],
             "leaves_compared": len(moved),
             "leaves_left_out": sorted(set(grad) - set(moved)),
             "ref_losses": losses, "losses": program["losses"]}
    return numbers, notes
