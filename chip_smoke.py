# coding: utf-8
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Phases, one line each; any failure exits non-zero before the result lines:
  1. require a CUDA device; print its name and power limit (nvidia-smi);
  2. build the hand-written kernels from deepvoice3_pytorch_tpu_torch/csrc,
     one nvcc per source, all started together;
  3. kernel B3 (tap-accumulating conv: forward, dgrad, wgrad) against its
     plain version at the train step's five conv shape classes (LJSpeech
     preset, bench shapes T_text = T_dec = 128, T_lin = 512), in f32 at
     B = 16 with TF32 off and in bf16 at B = 64. f32 bar: the kernel's error
     against a float64 run of the plain version is at most 4x the plain f32
     version's own error (or 1e-6 of the output's scale). bf16 bar: one bf16
     ulp of the largest value (2^-7 relative) for the bf16 outputs, which
     both round once from an f32 sum, and the f32 bar for the f32 weight
     gradient. Times kernel, plain and the cuDNN call (F.conv1d forward,
     convolution_backward for dgrad and wgrad) as the yardstick;
  4. a tiny model's train step, three steps on the GPU (B3) against the same
     steps on the CPU (plain versions): loss 1e-5 relative at step 1 and 1e-4
     after, grad_norm 1e-4, every parameter 5e-5 after three steps;
  5. kernel B1 (fused decode) against its plain version at LJSpeech widths:
     B=32, Tk=96, one 32-step chunk, seeded random weights, TF32 off. The
     autoregressive loop amplifies f32 rounding (a random decoder's states
     reach |x| ~ 18 and drift ~1e-2 from a float64 run within 32 frames),
     so the bar is relative to that floor: |kernel - plain| <= 3x
     |plain - plain in float64| per output, and last_attended exact;
  6. kernel B2 (Griffin-Lim) against its plain version at (32, 400, 513),
     16 iterations, SPSI start, momentum 0.9;
  7. a small input through tts_batch on the GPU against the same input on
     the CPU (plain versions), as the reference;
  8. the synthesis main path: tts_batch with the LJSpeech preset at full
     width, seeded random weights, 32 sentences and then 8,
     max_decoder_steps=200; checks the waveforms and that B1's and B2's
     launch counts went up; prints wall time per call and the real-time
     factor;
  9. the training main path: the LJSpeech preset at full width, seeded
     random weights, make_train_step at bench.py's shapes (B = 16 f32 with
     TF32 off, B = 64 bf16) in conv_mode "kernel" and, as the yardstick,
     "library" (cuDNN), taken in turns; ms/step, steps/s and MFU against the
     H100's peak for the step's type (FLOPs counted by FlopCounterMode on
     the library step; the hand kernel is invisible to it); device time by
     kernel (torch.profiler) over three steps of each mode; then twenty
     steps on a synthetic-corpus batch, whose loss must be finite and fall.
     Fails unless B3 was launched in the kernel-mode steps.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. `--json-out PATH` also writes the B3 and
training numbers, in full, to PATH.
"""

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np

SENTENCES = [
    "The printing press changed how people shared ideas across Europe.",
    "He walked slowly along the river, listening to the water.",
    "A small committee was appointed to examine the evidence in detail.",
    "The weather turned cold before the first snow fell on the hills.",
    "She opened the letter and read it twice before she spoke.",
    "Every morning the baker lit the ovens long before the town awoke.",
    "The report was delivered to the commission on the following Tuesday.",
    "Bright lanterns hung from the bridge as the boats drifted past.",
    "Our train was delayed for nearly an hour outside the station.",
    "The museum keeps a collection of maps drawn by early sailors, "
    "some of them still remarkably accurate today.",
    "Nobody could explain why the old clock had stopped at midnight.",
    "The garden was full of roses, lilies, and tall green ferns.",
    "In the evening the family gathered around the fire to tell stories.",
    "The witness described the car, the driver, and the direction it took.",
    "Scientists measured the temperature of the lake every week for a year, "
    "and the records show a slow but steady rise.",
    "He kept a journal of every journey he made across the country.",
    "The doors of the library were closed for repairs during the summer.",
    "A gentle wind carried the smell of bread through the narrow streets.",
    "They built the cabin with timber cut from the nearby forest.",
    "The orchestra tuned their instruments while the audience found seats.",
    "When the storm had passed, the village counted the fallen trees, "
    "repaired the roofs, and cleared the roads before nightfall.",
    "The teacher asked each student to write a short poem about the sea.",
    "A long queue formed outside the theatre an hour before the show.",
    "The farmer sold apples, pears, and honey at the Saturday market.",
    "Her voice was calm and clear as she answered every question.",
    "The expedition reached the summit just as the clouds began to lift.",
    "He repaired the bicycle with a borrowed wrench and a bit of wire.",
    "The city council voted to plant a thousand trees along the avenues.",
    "The children laughed as the puppy chased its own tail in circles.",
    "Old photographs show the harbour crowded with ships and cargo.",
    "The clerk recorded the names of all the passengers in a heavy ledger.",
    "At dawn the fishermen pushed their boats into the quiet water.",
]


def phase(name, msg):
    print("[%s] %s" % (name, msg), flush=True)


def fail(msg):
    print("FAILED: %s" % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, torch, reps=3):
    """Mean device time of fn() over `reps` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def maxabs(a, b):
    return float((a.float() - b.float()).abs().max())


def build_kernels(kernels):
    """One nvcc per source, all started together; then load each library.
    Returns {source: compiler output}."""
    from concurrent.futures import ThreadPoolExecutor

    from deepvoice3_pytorch_tpu_torch import _build

    sources = sorted({k.source for k in kernels})
    with ThreadPoolExecutor(len(sources)) as ex:
        logs = {s: log for s, (_, log) in zip(
            sources, ex.map(_build.build, sources))}
    for k in kernels:
        k.lib
    return logs


# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def bound(flops, nbytes, dtype):
    """(least ms, what bounds it) for `flops` operations of `dtype` and
    `nbytes` moved to or from device memory."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


# ---------------------------------------------------------------------------
# B3: the tap-accumulating conv at the train step's shapes
# ---------------------------------------------------------------------------

# (name, convs per forward, C, N (GLU doubles), T in units of T_dec or
# T_text, dilation, causal) at the LJSpeech preset, kw = 3
CONV_CLASSES = [
    ("encoder", 10, 512, 1024, 1, 9, False),
    ("decoder", 7, 256, 512, 1, 27, True),
    ("converter_2T", 2, 256, 512, 2, 3, False),
    ("converter_4T", 4, 256, 512, 4, 3, False),
    ("converter_4T_wide", 2, 512, 1024, 4, 3, False),
]
T_TEXT, T_DEC, T_LIN = 128, 128, 512
KW = 3


def _ref64(x, w, b, pad, dil):
    """Tap sum in float64 (the exact reference for f32 bars)."""
    import torch.nn.functional as F

    T = x.shape[1]
    xp = F.pad(x.double(), (0, 0, pad[0], pad[1]))
    y = sum(xp[:, j * dil:j * dil + T] @ w[j].double()
            for j in range(w.shape[0]))
    return y if b is None else y + b.double()


def _wgrad64(x, dy, pad, dil, kw):
    import torch
    import torch.nn.functional as F

    T, C, N = x.shape[1], x.shape[2], dy.shape[2]
    xp = F.pad(x.double(), (0, 0, pad[0], pad[1]))
    g = dy.double().reshape(-1, N)
    return torch.stack([xp[:, j * dil:j * dil + T].reshape(-1, C).t() @ g
                        for j in range(kw)])


def check_b3_class(torch, cls, B, dtype, dev, seed):
    """Kernel vs plain (and float64) for one shape class: errors, bars and
    times of forward, dgrad, wgrad for kernel, plain and cuDNN."""
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda as cc

    name, count, C, N, tmul, dil, causal = cls
    T = tmul * T_DEC
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g).to(dev, dt)
    w = (torch.randn(KW, C, N, generator=g) / (KW * C) ** 0.5).to(dev, dt)
    b = (torch.randn(N, generator=g) * 0.1).to(dev, dt)
    dy = torch.randn(B, T, N, generator=g).to(dev, dt)
    pad = ((KW - 1) * dil, 0) if causal else (dil, dil)
    mirrored = (pad[1], pad[0])
    wd = w.flip(0).transpose(1, 2)
    runs = {
        "fwd": (lambda: cc.conv_fwd(x, w, b, pad, dil),
                lambda: cc.conv1d_taps_plain(x, w, b, pad, dil),
                lambda: _ref64(x, w, b, pad, dil)),
        "dgrad": (lambda: cc.conv_dgrad(dy, w, pad, dil),
                  lambda: cc.conv1d_taps_plain(dy, wd, None, mirrored, dil),
                  lambda: _ref64(dy, wd, None, mirrored, dil)),
        "wgrad": (lambda: cc.conv_wgrad(x, dy, pad, dil, KW),
                  lambda: cc.conv1d_taps_wgrad_plain(x, dy, pad, dil, KW),
                  lambda: _wgrad64(x, dy, pad, dil, KW)),
    }
    # cuDNN yardstick on (B, C, T) layouts; symmetric padding dil gives the
    # same output length and work as the causal (2 dil, 0)
    xl = x.transpose(1, 2).contiguous()
    wl = w.permute(2, 1, 0).contiguous()               # (N, C, kw)
    dyl = dy.transpose(1, 2).contiguous()
    aten = torch.ops.aten.convolution_backward
    library = {
        "fwd": lambda: torch.nn.functional.conv1d(xl, wl, b, padding=dil,
                                                  dilation=dil),
        "dgrad": lambda: aten(dyl, xl, wl, None, [1], [dil], [dil], False,
                              [0], 1, [True, False, False]),
        "wgrad": lambda: aten(dyl, xl, wl, None, [1], [dil], [dil], False,
                              [0], 1, [False, True, False]),
    }
    out = {}
    for op, (kern, plain, exact) in runs.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        scale = max(1.0, float(want.float().abs().max()))
        if got.dtype == torch.bfloat16:
            err = maxabs(got, want)
            ok = err <= 2.0 ** -7 * scale
            floor = None
        else:
            ref = exact()
            err = float((got.double() - ref).abs().max())
            floor = float((want.double() - ref).abs().max())
            ok = err <= max(4 * floor, 1e-6 * scale)
        out[op] = {"err": err, "plain_vs_f64": floor, "scale": scale,
                   "ok": ok, "ms": cuda_ms(kern, torch, reps=5),
                   "plain_ms": cuda_ms(plain, torch, reps=5),
                   "library_ms": cuda_ms(library[op], torch, reps=5)}
    isz = x.element_size()
    flops = 2.0 * B * T * N * KW * C
    out["flops"] = flops
    out["bytes"] = {
        "fwd": (B * T * C + KW * C * N + B * T * N) * isz + 4 * N,
        "dgrad": (B * T * N + KW * C * N + B * T * C) * isz,
        "wgrad": (B * T * C + B * T * N) * isz + 4 * KW * C * N}
    return out


def check_b3(torch, dev, seed):
    """Every class in f32 at B = 16 and bf16 at B = 64; per-step sums."""
    res = {}
    for B, dtype in ((16, "float32"), (64, "bfloat16")):
        classes = {c[0]: check_b3_class(torch, c, B, dtype, dev, seed)
                   for c in CONV_CLASSES}
        step = {}
        for entry, ops in (("conv_taps_fwd", ("fwd", "dgrad")),
                           ("conv_taps_wgrad", ("wgrad",))):
            tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                   "flops": 0.0, "bytes": 0.0, "err": 0.0}
            for c in CONV_CLASSES:
                r = classes[c[0]]
                for op in ops:
                    for k in ("ms", "plain_ms", "library_ms"):
                        tot[k] += c[1] * r[op][k]
                    tot["flops"] += c[1] * r["flops"]
                    tot["bytes"] += c[1] * r["bytes"][op]
                    tot["err"] = max(tot["err"], r[op]["err"])
            tot["bound_ms"], tot["bound_by"] = bound(tot["flops"],
                                                     tot["bytes"], dtype)
            step[entry] = tot
        res[(B, dtype)] = (classes, step)
    return res


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def bench_batch(torch, hp, n_vocab, B, dev):
    """bench.py's training shapes: T_text = 128, T_lin = 512 (5.9 s of
    audio), downsample_step 4, r = 1; random data from a seed."""
    from deepvoice3_pytorch_tpu_torch.training import trainer

    r, ds = hp.outputs_per_step, hp.downsample_step
    T_mel = T_LIN // ds
    T_dec = T_mel // r
    rs = np.random.RandomState(0)
    batch = {
        "x": rs.randint(1, n_vocab, (B, T_TEXT)),
        "input_lengths": np.full((B,), T_TEXT),
        "mel": rs.rand(B, T_mel, hp.num_mels).astype(np.float32),
        "y": rs.rand(B, T_LIN, hp.fft_size // 2 + 1).astype(np.float32),
        "text_positions": np.tile(np.arange(1, T_TEXT + 1), (B, 1)),
        "frame_positions": np.tile(np.arange(1, T_dec + 1), (B, 1)),
        "done": np.zeros((B, T_dec, 1), np.float32),
        "target_lengths": np.full((B,), T_LIN),
    }
    return trainer.batch_to(batch, dev)


def check_train_reference(torch, pkg, dev):
    """Tiny model: three train steps on the GPU (B3 kernels) and on the CPU
    (plain versions) from the same parameters and batch, dropout 0."""
    from deepvoice3_pytorch_tpu_torch import builder
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.training import trainer

    cfg = builder.deepvoice3(
        n_vocab=pkg["en"].n_vocab, embed_dim=32, mel_dim=16, linear_dim=65,
        r=1, downsample_step=4, dropout=0.0, kernel_size=3,
        encoder_channels=32, decoder_channels=32, converter_channels=32,
        use_memory_mask=True, key_projection=True, value_projection=True,
        max_positions=64)
    hp = pkg["hparams"].default_hparams()
    hp.fft_size, hp.num_mels = 128, 16
    lc = trainer.loss_config_from_hparams(hp)
    opt = trainer.make_optimizer(hp, trainer.make_lr_fn(hp))
    rs = np.random.RandomState(3)
    B, T_text, T_lin = 4, 12, 64
    batch = {
        "x": rs.randint(1, 149, (B, T_text)),
        "input_lengths": np.asarray([12, 10, 7, 12]),
        "mel": rs.rand(B, T_lin // 4, 16).astype(np.float32),
        "y": rs.rand(B, T_lin, 65).astype(np.float32),
        "text_positions": np.tile(np.arange(1, T_text + 1), (B, 1)),
        "frame_positions": np.tile(np.arange(1, T_lin // 4 + 1), (B, 1)),
        "done": (np.arange(T_lin // 4)[None, :, None]
                 >= np.asarray([16, 12, 9, 14])[:, None, None] - 1
                 ).astype(np.float32),
        "target_lengths": np.asarray([64, 48, 36, 56]),
    }
    runs = {}
    for d in ("cpu", dev):
        params = builder.model_init(cfg, torch.Generator().manual_seed(11),
                                    device=d)
        mask = trainer.trainable_mask(params, cfg)
        step = trainer.make_train_step(cfg, lc, opt, mask)
        state = trainer.init_train_state(params, opt)
        b = trainer.batch_to(batch, d)
        gen = torch.Generator(device=d).manual_seed(0)
        conv_cuda.KERNEL.reset_counts()
        metrics = []
        for _ in range(3):
            state, m = step(state, b, gen)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[str(d)] = (metrics, {k: v.detach().cpu() for k, v in
                                  state.params.state_dict().items()},
                        conv_cuda.KERNEL.launches)
    (mc, pc, _), (mg, pg, launches) = runs["cpu"], runs[str(dev)]
    rel = [abs(a["loss"] - b["loss"]) / abs(a["loss"]) for a, b in
           zip(mg, mc)]
    gn = max(abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
             for a, b in zip(mg, mc))
    perr = max(maxabs(pg[k], pc[k]) for k in pc)
    ok = (rel[0] <= 1e-5 and max(rel) <= 1e-4 and gn <= 1e-4
          and perr <= 5e-5 and launches > 0)
    return ok, {"loss_rel": rel, "grad_norm_rel": gn, "param_max_abs": perr,
                "b3_launches_gpu": launches,
                "loss_gpu": [m["loss"] for m in mg]}


def time_steps(torch, step, state, batch, gen, n):
    """Host-clock ms per step over n steps after two warm-up steps, ended by
    a synchronise."""
    for _ in range(2):
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    t = time.time()
    for _ in range(n):
        state, m = step(state, batch, gen)
    torch.cuda.synchronize()
    return state, m, (time.time() - t) * 1e3 / n


def profile_steps(torch, step, state, batch, gen, n, ms_per_step):
    """Device time by kernel name over n steps (torch.profiler), per step,
    and the device's busy share against the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # device events only: a CPU op's self device time repeats the
        # kernels it launched (a ctypes launch has no aten child)
        if str(e.device_type).split(".")[-1] != "CUDA":
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.count / n, e.key[:70]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return state, {"device_ms_per_step": round(busy, 3),
                   "busy_share": round(busy / ms_per_step, 4),
                   "top": [[round(a, 3), round(c, 1), k]
                           for a, c, k in rows[:12]]}


def train_main_path(torch, pkg, hp, dev, seed, card):
    """The LJSpeech train step at bench.py's shapes in both conv modes,
    taken in turns, plus steps on a synthetic-corpus batch. Returns
    (B3 launches in the kernel-mode steps, rows of numbers)."""
    from torch.utils.flop_counter import FlopCounterMode

    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.ops import core
    from deepvoice3_pytorch_tpu_torch.training import trainer
    from deepvoice3_pytorch_tpu_torch.utils import synthcorpus as sc

    en = pkg["en"]
    cfg, params0 = pkg["model_builder"].build_model(hp, en.n_vocab,
                                                    seed=seed, device=dev)
    lc = trainer.loss_config_from_hparams(hp)
    opt = trainer.make_optimizer(hp, trainer.make_lr_fn(hp))
    mask = trainer.trainable_mask(params0, cfg)
    rows = {}
    n_kernel_steps = 0
    conv_cuda.KERNEL.reset_counts()
    for B, dtype in ((16, "float32"), (64, "bfloat16")):
        batch = bench_batch(torch, hp, en.n_vocab, B, dev)
        ms = {"kernel": [], "library": []}
        losses, profiles = {}, {}
        for turn, mode in enumerate(("kernel", "library", "library",
                                     "kernel")):
            step = trainer.make_train_step(cfg, lc, opt, mask,
                                           compute_dtype=dtype,
                                           conv_mode=mode)
            state = trainer.init_train_state(copy.deepcopy(params0), opt)
            gen = torch.Generator(device=dev).manual_seed(0)
            state, m, t = time_steps(torch, step, state, batch, gen, 10)
            if mode == "kernel":
                n_kernel_steps += 12
            ms[mode].append(t)
            losses[mode] = float(m["loss"])
            if not np.isfinite(losses[mode]):
                fail("train step B=%d %s %s: loss %r"
                     % (B, dtype, mode, losses[mode]))
            if turn >= 2:
                state, profiles[mode] = profile_steps(
                    torch, step, state, batch, gen, 3, t)
                n_kernel_steps += 3 if mode == "kernel" else 0
        step = trainer.make_train_step(cfg, lc, opt, mask,
                                       compute_dtype=dtype,
                                       conv_mode="library")
        state = trainer.init_train_state(copy.deepcopy(params0), opt)
        gen = torch.Generator(device=dev).manual_seed(0)
        with FlopCounterMode(display=False) as fc:
            step(state, batch, gen)
        flops = float(fc.get_total_flops())
        row = {"flops_per_step": flops, "losses_after_12": losses,
               "profile": profiles}
        for mode in ms:
            per = sum(ms[mode]) / len(ms[mode])
            row[mode] = {"ms_per_step": [round(v, 3) for v in ms[mode]],
                         "mean_ms": round(per, 3),
                         "steps_per_s": round(1e3 / per, 3),
                         "mfu": round(flops / (per * 1e-3)
                                      / PEAK_FLOPS[dtype], 5)}
        rows["B%d_%s" % (B, dtype)] = row
        phase("train", "B=%d %s (%s): kernel %.2f ms/step (%.2f steps/s, "
              "MFU %.4f of %g TFLOP/s), library %.2f ms/step (%.2f steps/s,"
              " MFU %.4f); %.1f GFLOP/step counted on the library step; "
              "turns %s" % (
                  B, dtype, card, row["kernel"]["mean_ms"],
                  row["kernel"]["steps_per_s"], row["kernel"]["mfu"],
                  PEAK_FLOPS[dtype] / 1e12, row["library"]["mean_ms"],
                  row["library"]["steps_per_s"], row["library"]["mfu"],
                  flops / 1e9, json.dumps({k: ms[k] for k in ms})))
        for mode, prof in profiles.items():
            phase("train_profile", "B=%d %s %s: device %.2f ms/step, busy "
                  "%.3f of the unprofiled step; top kernels [ms/step, "
                  "launches/step, name]: %s" % (
                      B, dtype, mode, prof["device_ms_per_step"],
                      prof["busy_share"], json.dumps(prof["top"][:8])))

    # a real batch: the synthetic corpus at the preset's audio settings,
    # a constant learning rate, twenty kernel-mode f32 steps
    ap = pkg["AudioProcessor"](hp)
    items = sc.build_items(sc.make_sentences(16, seed=3), hp, ap, en,
                           device=dev)
    batch = trainer.batch_to(sc.make_batches(items, hp, 16, seed=3)[0], dev)
    hp_c = copy.deepcopy(hp)
    hp_c.lr_schedule = ""
    hp_c.initial_learning_rate = 2e-4
    opt_c = trainer.make_optimizer(hp_c, trainer.make_lr_fn(hp_c))
    step = trainer.make_train_step(cfg, lc, opt_c, mask)
    state = trainer.init_train_state(copy.deepcopy(params0), opt_c)
    gen = torch.Generator(device=dev).manual_seed(0)
    curve = []
    for _ in range(20):
        state, m = step(state, batch, gen)
        curve.append(float(m["loss"]))
    n_kernel_steps += 20
    launches = dict(conv_cuda.KERNEL.by_entry)
    launches["total"] = conv_cuda.KERNEL.launches
    launches["per_step"] = launches["total"] / n_kernel_steps
    if not all(np.isfinite(curve)) or \
            np.mean(curve[-5:]) >= np.mean(curve[:5]):
        fail("synthetic-corpus loss did not fall: %s" % curve)
    rows["synthcorpus"] = {"shape": {k: list(v.shape) for k, v in
                                     batch.items()}, "loss": curve}
    phase("train", "synthetic corpus batch %s, lr 2e-4 constant: loss %s"
          % (json.dumps(rows["synthcorpus"]["shape"]),
             [round(v, 4) for v in curve]))
    return launches, rows


def ljspeech_hparams(hparams_mod, repo):
    hp = hparams_mod.default_hparams()
    with open(os.path.join(repo, "presets", "deepvoice3_ljspeech.json")) as f:
        hp.parse_json(f.read())
    return hp


def check_b1(torch, pkg, hp, dev, seed):
    """B1 kernel vs plain at LJSpeech widths."""
    from deepvoice3_pytorch_tpu_torch.models import deepvoice3 as dv3
    from deepvoice3_pytorch_tpu_torch.ops import core
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device=dev)
    B, Tk, steps = 32, 96, 32
    g = torch.Generator().manual_seed(seed + 1)
    E = cfg.decoder.embed_dim
    keys = (torch.randn(B, Tk, E, generator=g) * 0.5).to(dev)
    values = (torch.randn(B, Tk, E, generator=g) * 0.5).to(dev)
    lengths = torch.randint(40, Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None, :].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    pd = params["decoder"]
    fi = dv3.fused_decode_inputs(pd, cfg.decoder, (keys, values), pos)
    mask = core.get_mask_from_lengths(lengths, Tk)
    init = torch.zeros(B, cfg.decoder.in_dim * cfg.decoder.r, device=dev)
    min_steps = cfg.decoder.min_decoder_steps

    def kernel():
        return fd.fused_decode(pd, cfg.decoder, fi, mask, init, steps,
                               min_steps, early_exit=False)

    def plain():
        return fd.fused_decode_plain(pd, cfg.decoder, fi, mask, init, steps,
                                     min_steps, early_exit=False)

    got, want = kernel(), plain()
    pd64 = copy.deepcopy(pd).double()
    fi64 = dv3.fused_decode_inputs(pd64, cfg.decoder,
                                   (keys.double(), values.double()), pos)
    exact = fd.fused_decode_plain(pd64, cfg.decoder, fi64, mask,
                                  init.double(), steps, min_steps,
                                  early_exit=False)
    torch.cuda.synchronize()
    flips = (got.last_attended != want.last_attended).nonzero().tolist()
    names = ("outputs", "alignments", "done", "decoder_states")
    errs = {n: maxabs(getattr(got, n), getattr(want, n)) for n in names}
    floor = {n: float((getattr(want, n).double()
                       - getattr(exact, n)).abs().max()) for n in names}
    ms = cuda_ms(kernel, torch)
    plain_ms = cuda_ms(plain, torch)
    return errs, floor, flips, ms, plain_ms


def b1_bound_ms(torch, pkg, hp, dev, seed, B=32, Tk=96, steps=32):
    """Least time for check_b1's decode: per row and step, one MAC per
    folded decoder weight (the key/value projections run outside the
    kernel) plus scores and context over Tk keys per attention layer, in f32
    outside the tensor cores; bytes: the weights, K/V and mask read once,
    the four outputs written once."""
    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device="cpu")
    sd = {k: v for k, v in params["decoder"].state_dict().items()
          if "positions" not in k and "key_proj" not in k
          and "value_proj" not in k}
    dc = cfg.decoder
    E, C = dc.embed_dim, dc.convolutions[0][0]
    n_att = dc.num_attention_layers
    macs = sum(v.numel() for k, v in sd.items() if k.endswith(".v")) \
        + n_att * 2 * Tk * E
    flops = 2.0 * macs * B * steps
    nbytes = 4 * (sum(v.numel() for v in sd.values())
                  + n_att * 2 * B * Tk * E + B * Tk
                  + B * steps * (dc.in_dim * dc.r + Tk + 1 + C))
    return bound(flops, nbytes, "float32")


def b2_bound_ms(B=32, n=400, fft=1024, hop=256, n_iters=16):
    """Least time for check_b2's retrieval: two DFT GEMMs per iteration and
    a last synthesis, (B n) x 2F x fft each, at the bf16 tensor-core rate;
    bytes: the magnitudes read once and the waveform written once."""
    F = fft // 2 + 1
    flops = (2 * n_iters + 1) * 2.0 * B * n * 2 * F * fft
    nbytes = 4 * (B * n * F + B * (n + fft // hop - 1) * hop)
    return bound(flops, nbytes, "bfloat16")


def check_b2(torch, pkg, dev, seed):
    """B2 kernel vs plain at (32, 400, 513)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    B, n, fft, hop = 32, 400, 1024, 256
    win = dsp.lws_hann_window(fft, hop)
    g = torch.Generator().manual_seed(seed + 2)
    # magnitudes of real signals: harmonic tones with vibrato plus noise
    t = torch.arange(n * hop, dtype=torch.float64) / 22050.0
    f0 = 100.0 + 150.0 * torch.rand(B, 1, generator=g, dtype=torch.float64)
    vib = 1.0 + 0.02 * torch.sin(2 * np.pi * 5.0 * t)[None, :]
    phase = 2 * np.pi * torch.cumsum(f0 * vib, dim=1) / 22050.0
    x = sum(torch.sin(h * phase) / h for h in range(1, 8))
    x = x + 0.01 * torch.randn(B, n * hop, generator=g, dtype=torch.float64)
    x = x.float().to(dev)
    S = torch.abs(dsp.stft(dsp.lws_pad(x, fft, hop), fft, hop,
                           torch.from_numpy(win).to(dev)))[:, :n].contiguous()
    mats = gl_cuda.gl_mats(fft, win, dev)

    def kernel():
        return gl_cuda.griffin_lim(S, fft, hop, win, n_iters=16,
                                   momentum=0.9, phase_init="spsi",
                                   mats=mats)

    def plain():
        return gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=16,
                                         momentum=0.9, phase_init="spsi",
                                         mats=mats)[:, :n * hop]

    def sc(wav):
        M = torch.abs(dsp.stft(dsp.lws_pad(wav, fft, hop), fft, hop,
                               torch.from_numpy(win).to(dev)))[:, :n]
        return float(torch.linalg.norm(M - S) / torch.linalg.norm(S))

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = maxabs(got, want)
    rel = err / float(want.abs().max())
    ms = cuda_ms(kernel, torch)
    plain_ms = cuda_ms(plain, torch)
    return err, rel, sc(got), sc(want), ms, plain_ms


def check_small_reference(torch, pkg, dev):
    """A tiny model through tts_batch on the GPU (kernels) and on the CPU
    (plain versions)."""
    from deepvoice3_pytorch_tpu_torch import builder

    cfg = builder.deepvoice3(
        n_vocab=pkg["en"].n_vocab, embed_dim=32, mel_dim=16, linear_dim=65,
        r=1, downsample_step=4, kernel_size=3, encoder_channels=32,
        decoder_channels=32, converter_channels=32, use_memory_mask=True,
        key_projection=True, value_projection=True, max_positions=64)
    params = builder.model_init(cfg, torch.Generator().manual_seed(7),
                                device="cpu")
    hp = pkg["hparams"].default_hparams()
    hp.fft_size, hp.hop_size = 128, 32
    ap = pkg["AudioProcessor"](hp)
    texts = SENTENCES[:3]
    ref = pkg["synthesis"].tts_batch(params, cfg, ap, pkg["en"], texts,
                                     max_decoder_steps=40)
    got = pkg["synthesis"].tts_batch(params.to(dev), cfg, ap, pkg["en"],
                                     texts, max_decoder_steps=40)
    worst = {"steps": 0, "mel": 0.0, "linear": 0.0, "alignment": 0.0,
             "wave_rel": 0.0}
    for r, o in zip(ref, got):
        if r["num_decoder_steps"] != o["num_decoder_steps"]:
            worst["steps"] += 1
            continue
        for k in ("mel", "linear", "alignment"):
            unit = 100.0 if k != "alignment" else 1.0   # dB -> model scale
            worst[k] = max(worst[k],
                           float(np.abs(r[k] - o[k]).max()) / unit)
        worst["wave_rel"] = max(worst["wave_rel"], float(
            np.abs(r["waveform"] - o["waveform"]).max()
            / max(np.abs(r["waveform"]).max(), 1e-9)))
    return worst


def stage_times(torch, synthesis, params, cfg, ap, frontend, texts):
    """Host-clock milliseconds of the stages of one tts_batch call, each
    ended by a device synchronise."""
    from deepvoice3_pytorch_tpu_torch.builder import model_decode, \
        model_postnet

    out = {}
    t = [time.time()]

    def mark(name):
        torch.cuda.synchronize()
        t.append(time.time())
        out[name] = round((t[-1] - t[-2]) * 1e3, 3)

    dev = next(iter(params.parameters())).device
    with torch.inference_mode():
        x, pos, lengths = (torch.from_numpy(a).to(dev) for a in
                           synthesis._prepare_batch(frontend, texts, 0.0, 8))
        mark("frontend")
        _, pin, _, _, dec_len = model_decode(params, cfg, x, pos,
                                             input_lengths=lengths,
                                             max_decoder_steps=200)
        n_bucket = min(200, synthesis._round_up(
            int(dec_len.max()) + synthesis.SLACK_DEC_STEPS,
            synthesis.BUCKET_DEC_STEPS))
        mark("encoder+decode")
        linear = model_postnet(params, cfg, pin[:, :n_bucket])
        mark("converter")
        ap.inv_spectrogram_device(linear)
        mark("griffin_lim+inv_preemphasis")
    out["decoded_steps_max"] = int(dec_len.max())
    return out


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "GPU.")
    ap.add_argument("--json-out", default=None,
                    help="also write the B3 and training numbers, in full, "
                         "to this JSON file")
    json_out = ap.parse_args().json_out
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        import deepvoice3_pytorch_tpu_torch  # noqa: F401
    except ImportError as e:
        fail("the port package is not next to this script: %s" % e)
    from deepvoice3_pytorch_tpu_torch import hparams, model_builder, synthesis
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.ops import core
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd
    from deepvoice3_pytorch_tpu_torch.training import trainer  # noqa: F401
    from deepvoice3_pytorch_tpu_torch.utils import synthcorpus  # noqa: F401

    if any(m == "jax" or m.startswith("deepvoice3_pytorch_tpu.")
           for m in sys.modules):
        fail("jax or the JAX package was imported")
    pkg = dict(hparams=hparams, model_builder=model_builder,
               synthesis=synthesis, AudioProcessor=AudioProcessor, en=en)
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi unavailable"
    print(card, flush=True)
    phase("device", "%s, torch %s, CUDA %s, %d device(s)" % (
        name, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))

    t0 = time.time()
    logs = build_kernels((fd.KERNEL, gl_cuda.KERNEL, conv_cuda.KERNEL))
    for source, log in logs.items():
        usage = [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        phase("build", "%s: %s" % (source, "; ".join(usage[:6])))
    phase("build", "kernels built and loaded in %.1f s" % (time.time() - t0))

    hp = ljspeech_hparams(hparams, repo)
    seed = 1234
    ok = True
    with core.strict_numerics():
        b3 = check_b3(torch, dev, seed)
        for (B, dtype), (classes, step) in b3.items():
            for cname, r in classes.items():
                ops = {op: {k: (round(v, 4) if isinstance(v, float) and
                                k.endswith("ms") else v)
                            for k, v in r[op].items()}
                       for op in ("fwd", "dgrad", "wgrad")}
                phase("B3", "%s B=%d %s: %s" % (cname, B, dtype,
                                                json.dumps(ops)))
                ok &= all(ops[op]["ok"] for op in ops)
            phase("B3", "per train step (25 convs) B=%d %s (%s): %s" % (
                B, dtype, card, json.dumps(step)))
        if not ok:
            fail("kernel B3 disagreed with its plain version")

        ref_ok, ref = check_train_reference(torch, pkg, dev)
        phase("train_reference", "tiny model, 3 steps GPU (B3) vs CPU "
              "(plain): %s (bars: loss 1e-5 at step 1, 1e-4 after; "
              "grad_norm 1e-4; params 5e-5)" % json.dumps(ref))
        if not ref_ok:
            fail("the GPU train step disagreed with the CPU one")

        errs, floor, flips, b1_ms, b1_plain_ms = check_b1(torch, pkg, hp,
                                                         dev, seed)
        b1_err = max(errs.values())
        b1_ok = not flips and all(errs[n] <= 3 * floor[n] + 1e-6
                                  for n in errs)
        phase("B1", "fused decode kernel vs plain, B=32 Tk=96 32 steps: "
              "max abs err %s, plain-vs-float64 floor %s (bar 3x floor), "
              "last_attended flips %s; kernel %.3f ms, plain %.3f ms" % (
                  json.dumps(errs), json.dumps(floor), flips[:8], b1_ms,
                  b1_plain_ms))
        ok &= b1_ok

        b2_err, b2_rel, sc_k, sc_p, b2_ms, b2_plain_ms = check_b2(
            torch, pkg, dev, seed)
        b2_ok = b2_rel < 0.12 and sc_k <= 1.05 * sc_p
        phase("B2", "griffin-lim kernel vs plain, (32, 400, 513) x 16: max "
              "abs err %.3g (%.4f of peak, bar 0.12), spectral convergence "
              "kernel %.4f plain %.4f (bar 1.05x); kernel %.3f ms, plain "
              "%.3f ms" % (b2_err, b2_rel, sc_k, sc_p, b2_ms, b2_plain_ms))
        ok &= b2_ok

        worst = check_small_reference(torch, pkg, dev)
        ref_ok = (worst["steps"] == 0 and max(worst["mel"], worst["linear"],
                                              worst["alignment"]) <= 1e-4
                  and worst["wave_rel"] < 0.12)
        phase("reference", "tiny model, GPU kernels vs CPU plain: %s "
              "(bars: steps exact, features 1e-4, waveform 0.12 of peak)"
              % json.dumps(worst))
        ok &= ref_ok
        if not ok:
            fail("a kernel or the reference comparison disagreed")

        cfg, params = model_builder.build_model(hp, en.n_vocab, seed=seed,
                                                device=dev)
        ap = AudioProcessor(hp)
        batches = [SENTENCES, SENTENCES[:8]]
        if not all(40 <= len(s) <= 160 for s in SENTENCES):
            fail("a sentence is outside 40-160 characters")

        def run(texts):
            torch.cuda.synchronize()
            t = time.time()
            res = synthesis.tts_batch(params, cfg, ap, en, texts,
                                      max_decoder_steps=200)
            torch.cuda.synchronize()
            return res, time.time() - t

        run(SENTENCES)                              # warm-up
        for k in (fd.KERNEL, gl_cuda.KERNEL, conv_cuda.KERNEL):
            k.reset_counts()
        for texts in batches:
            res, wall = run(texts)
            audio_s = sum(len(r["waveform"]) for r in res) / hp.sample_rate
            for r in res:
                n = r["num_decoder_steps"]
                if r["waveform"].shape != (n * 4 * hp.hop_size,) or \
                        not np.isfinite(r["waveform"]).all():
                    fail("bad waveform: shape %s for %d steps"
                         % (r["waveform"].shape, n))
            steps = [r["num_decoder_steps"] for r in res]
            phase("tts_batch", "B=%d: %.1f ms wall, %.2f s of audio, RTF "
                  "%.1fx, decoded steps min/max %d/%d (%s)" % (
                      len(texts), wall * 1e3, audio_s, audio_s / wall,
                      min(steps), max(steps), card))
        launches = {"fused_decode": fd.KERNEL.launches,
                    "griffin_lim": gl_cuda.KERNEL.launches}
        phase("tts_batch", "kernel launches on the main path: %s"
              % json.dumps(launches))
        if min(launches.values()) <= 0 or conv_cuda.KERNEL.launches:
            fail("a kernel of the main path was not launched, or B3 was")
        phase("stages", "B=32 wall time by stage: %s" % json.dumps(
            stage_times(torch, synthesis, params, cfg, ap, en, SENTENCES)))

        b3_launches, train_rows = train_main_path(torch, pkg, hp, dev, seed,
                                                  card)
        phase("train", "B3 launches in the kernel-mode steps: %s"
              % json.dumps(b3_launches))
        if b3_launches["total"] <= 0 or not b3_launches.get("wgrad"):
            fail("kernel B3 was not launched on the training main path")
        if json_out:
            os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                        exist_ok=True)
            with open(json_out, "w") as f:
                json.dump({"card": card, "train": train_rows,
                           "b3": {"%d_%s" % k: v for k, v in b3.items()}},
                          f, indent=1, default=str)

    b1_bound = b1_bound_ms(torch, pkg, hp, dev, seed)
    b2_bound = b2_bound_ms()
    b3_step = b3[(16, "float32")][1]

    print(json.dumps({"kernels": [
        {"name": "fused_decode", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/fused_decode.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/fused_decode.py:198",
         "launches": launches["fused_decode"], "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bound[0],
         "bound_by": b1_bound[1], "library_ms": None},
        {"name": "griffin_lim", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "deepvoice3_pytorch_tpu/dsp/gl_pallas.py:146",
         "launches": launches["griffin_lim"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound[0],
         "bound_by": b2_bound[1], "library_ms": None},
    ] + [
        {"name": entry, "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/conv_taps.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/conv_pallas.py:%d" % line,
         "launches": b3_launches.get(key, 0),
         "max_abs_err": b3_step[entry]["err"], "ms": b3_step[entry]["ms"],
         "plain_ms": b3_step[entry]["plain_ms"],
         "bound_ms": b3_step[entry]["bound_ms"],
         "bound_by": b3_step[entry]["bound_by"],
         "library_ms": b3_step[entry]["library_ms"]}
        for entry, key, line in (("conv_taps_fwd", "fwd", 157),
                                 ("conv_taps_wgrad", "wgrad", 212))
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
