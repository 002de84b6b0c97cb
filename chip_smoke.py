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
     gradient. Device times (launches queued behind a device sleep, so
     the host's costs stay out) of kernel, plain and the cuDNN call
     (F.conv1d forward, convolution_backward for dgrad and wgrad) as the
     yardstick, kernel / cuDNN, TFLOP/s and share of the bound; also the
     kernel's and cuDNN's host-paced times (events around the calls as the
     host issues them); the route each launch took (fails if a class took
     the ragged `*_simple` route), the kernels' registers from the build
     log, the bf16 wgrad's drift against float64 for each k-block length
     (rows summed in the tensor cores before an f32 add), the forward's
     time at each tile width of its type, and the host ms of a TMA
     descriptor encode;
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
  7. B2's streaming modes (phase `B2_stream`) against the plain version at
     a stream window's shape, (8, 152, 513) x 32 iterations, with a given
     start, 16 pinned frames and the spectrum returned: the B2 bars, and
     the pinned frames of the returned spectrum equal to the start
     exactly; kernel ms, plain ms and the bound;
  8. the probe kernel P (phase `P`: B2 with the windows applied in f32
     outside the bf16 DFT matrices) against its plain version at the
     probe's shape, (32, 600, 513) x 16; then what the probe measured:
     spectral convergence on tests/data/dsp_golden_linear.npy (kernel and
     plain, bar 1.05x), microseconds per item-iteration from the 4- and
     16-iteration times, and the folded B2's time at the same shape;
  9. a small input through tts_batch, and a small stream through
     tts_stream, on the GPU against the same input on the CPU (plain
     versions), as the reference;
 10. the synthesis main path: tts_batch with the LJSpeech preset at full
     width, seeded random weights, 32 sentences and then 8,
     max_decoder_steps=200; checks the waveforms and that B1's and B2's
     launch counts went up; prints wall time per call and the real-time
     factor;
 11. the streaming main path (phase `stream`): tts_stream at the same
     preset and weights, first chunk 16 frames then 32, up to 200 steps:
     measured as bench.py measures it at B = 1 and B = 8: after a warm-up,
     five streams, and of the one with the least time to the first next()
     of the generator, ttfa_ms and the stream RTF (decoded-length audio
     over the whole stream's wall time); the first chunk's stages (decode,
     converter window, Griffin-Lim window, fetches), a torch.profiler
     breakdown of one B = 1 stream; fails unless B1 and B2's pinned mode
     were launched and B3 was not, and unless the stream's decoded steps
     equal tts_batch's;
 12. the HTTP engine (phase `serve`): TTSEngine + make_handler on a
     ThreadingHTTPServer at 127.0.0.1:0, /healthz, three /tts requests
     (client-side time to the first PCM bytes), a 400, /stats; checks the
     WAV header, the sample rate and that each PCM length equals
     decoded_samples of the stream's final chunk;
 13. the other two builders (phases `B1_nyanko`, `B1_vctk`, `nyanko`,
     `vctk`): B1 against its plain version at the nyanko and VCTK presets'
     full widths (B = 32, Tk = 96, 32 steps, the B1 bar; nyanko's ring
     buffers partly in device memory), the placement of their ring
     buffers, a tiny model of each builder through tts_batch and tts_stream
     GPU vs CPU (steps exact, features 1e-4, spectral convergence of the
     audio within 1.05x of the CPU's), then each preset's main path:
     tts_batch on the 32 sentences and the first 8 (VCTK speakers
     (7 i) % 108), wall ms, RTF, decoded steps, launch counts, and one
     B = 1 and one B = 8 stream (ttfa_ms, stream RTF); fails unless B1 and
     B2 launched and B3 did not; for VCTK one HTTP request with a
     speaker_id;
 14. continuous batching (phases `B1_serve`, `serve_reference`, `cb`,
     `serve_slots`, `cb_nyanko`, `cb_vctk`): B1's serving modes (per-row
     positions advanced in the kernel, per-row context scales) against the
     plain per-row decode at LJSpeech's full width, S = 8, Tk = 128, two
     16-step launches (the B1 bar, last_attended and positions exact; ms
     per launch, bound); a tiny model's ContinuousBatcher GPU vs CPU
     (decoded steps exact, spectral convergence 1.05x); then bench.py's
     continuous-batching schedules at full width, ContinuousBatcher(8
     slots, chunk 16, text_pad 64, 200 steps) on its worker thread after a
     warm-up request: LJSpeech 8 and then 24 requests 50 ms apart
     (per-request ttfa, aggregate RTF, step phases, one B1 launch a step,
     B2 launches a step, a torch.profiler breakdown of 8 requests at once),
     nyanko 8, VCTK 8 with speakers 0, 8, ..., 56 and min_decoder_steps =
     200; each request's length must equal decoded_samples of its steps and
     at least two mid-stream admissions must decode the steps of a fresh
     tts_stream; TTSEngine(slots=8) over HTTP with 8 concurrent requests,
     /stats, and a 503 from an engine with max_backlog=0;
 15. the training main path: the LJSpeech preset at full width, seeded
     random weights, make_train_step at bench.py's shapes (B = 16 f32 with
     TF32 off, B = 64 bf16) in conv_mode "kernel" and, as the yardstick,
     "library" (cuDNN), taken in turns; ms/step, steps/s and MFU against the
     H100's peak for the step's type (FLOPs counted by FlopCounterMode on
     the library step; the hand kernel is invisible to it); device time by
     kernel (torch.profiler) over three steps of each mode; then twenty
     steps on a synthetic-corpus batch, whose loss must be finite and fall.
     Fails unless B3's four fast entries (fwd/wgrad, pipe/wgmma) were
     launched in the kernel-mode steps, and if its ragged route was.
The line before the last is the kernels' JSON record (B1's launches
summed over the three builders' main paths and the serving paths, its
worst error over the four B1 phases; its times are the LJSpeech phase's;
`fused_decode_slots` is the serving mode alone: its launches on the
serving paths, B1_serve's error and times; `griffin_lim_stream` counts
its launches on the stream and serving paths); the last line is
{"ok": true, "device": {...}}. Each record's "timing" names how its "ms"
and "plain_ms" were taken: "host-paced" (cuda_ms: events around calls as
the host issues them) or "device" (device_ms: the calls queued behind a
device sleep, met back to back). `--json-out PATH` also writes the B3 and
training numbers, in full, to PATH.

    python3 chip_smoke.py --b1-turns PARENT_DIR

times B1's LJSpeech chunk (phase 5's kernel call) in this checkout and in
another one (a copy of an earlier commit), in turns parent, this, this,
parent, each in a fresh process, and prints one JSON line; nothing else
runs.

    python3 chip_smoke.py --b3-turns PARENT_DIR

times phase 3's per-step sums of B3 (device and host-paced, kernel and
cuDNN) on another checkout's conv kernels and on this one's, in the same
turns, with this script's timers; nothing else runs.

    python3 chip_smoke.py --b3-only

builds the kernels and runs phase 3 alone.
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


def device_ms(fn, torch, reps=5, host_lead_ms=30.0):
    """Mean device time of fn() over `reps` runs after one warm-up, with the
    host's launch costs out of the measurement: the runs are queued behind
    a `host_lead_ms` device sleep, so the card meets them back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(host_lead_ms * 2e6))   # cycles at ~2 GHz
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


def ptxas_usage(log):
    """'kernel<template args>: N registers, S bytes smem[, spills]' for each
    entry function in nvcc's -Xptxas -v output."""
    import re

    out, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"entry function '\w*?_cu_[0-9a-f]{8}(\d+)(\w*)'", ln)
        if m:
            n, rest = int(m.group(1)), m.group(2)
            args = re.match(r"I(\w*?)EE", rest[n:])
            name = rest[:n] + ("<%s>" % ",".join(re.findall(
                r"L[a-z](\d+)", args.group(1))) if args else "")
        elif "spill" in ln and " 0 bytes spill stores" not in ln:
            spill = ", " + ln.strip()
        elif "Used" in ln and name:
            used = ln.split("Used", 1)[1].replace(", used 0 barriers", "")
            out.append("%s: %s%s" % (name, used.strip(), spill))
            name, spill = None, ""
    return out


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


def _b3_inputs(torch, cls, B, dtype, dev, seed):
    name, count, C, N, tmul, dil, causal = cls
    T = tmul * T_DEC
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, T, C, generator=g).to(dev, dt)
    w = (torch.randn(KW, C, N, generator=g) / (KW * C) ** 0.5).to(dev, dt)
    b = (torch.randn(N, generator=g) * 0.1).to(dev, dt)
    dy = torch.randn(B, T, N, generator=g).to(dev, dt)
    pad = ((KW - 1) * dil, 0) if causal else (dil, dil)
    return x, w, b, dy, pad, dil


def check_b3_class(torch, cls, B, dtype, dev, seed):
    """Kernel vs plain (and float64) for one shape class: errors, bars,
    the route each launch took, and times of forward, dgrad, wgrad for
    kernel, plain and cuDNN, with the bound of each. Times are device_ms;
    the kernel's and cuDNN's also cuda_ms ("*_host_paced": the calls as the
    host issues them)."""
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda as cc

    x, w, b, dy, pad, dil = _b3_inputs(torch, cls, B, dtype, dev, seed)
    B, T, C = x.shape
    N = w.shape[2]
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
    isz = x.element_size()
    flops = 2.0 * B * T * N * KW * C
    nbytes = {
        "fwd": (B * T * C + KW * C * N + B * T * N) * isz + 4 * N,
        "dgrad": (B * T * N + KW * C * N + B * T * C) * isz,
        "wgrad": (B * T * C + B * T * N) * isz + 4 * KW * C * N}
    out = {"flops": flops, "bytes": nbytes}
    for op, (kern, plain, exact) in runs.items():
        cc.KERNEL.reset_counts()
        got = kern()
        route = sorted(cc.KERNEL.by_entry)
        want = plain()
        torch.cuda.synchronize()
        scale = max(1.0, float(want.float().abs().max()))
        drift = None
        if got.dtype == torch.bfloat16:
            err = maxabs(got, want)
            ok = err <= 2.0 ** -7 * scale
            floor = None
        else:
            ref = exact()
            err = float((got.double() - ref).abs().max())
            floor = float((want.double() - ref).abs().max())
            ok = err <= max(4 * floor, 1e-6 * scale)
            drift = err / scale
        ms = device_ms(kern, torch)
        lib_ms = device_ms(library[op], torch)
        hp_ms = cuda_ms(kern, torch, reps=5)
        hp_lib_ms = cuda_ms(library[op], torch, reps=5)
        bms, by = bound(flops, nbytes[op], dtype)
        out[op] = {"err": err, "plain_vs_f64": floor, "scale": scale,
                   "drift_of_scale": drift, "ok": ok, "route": route,
                   "ms": ms, "plain_ms": device_ms(plain, torch),
                   "library_ms": lib_ms, "vs_cudnn": ms / lib_ms,
                   "ms_host_paced": hp_ms,
                   "library_ms_host_paced": hp_lib_ms,
                   "vs_cudnn_host_paced": hp_ms / hp_lib_ms,
                   "tflops": flops / ms / 1e9, "bound_ms": bms,
                   "bound_by": by, "share_of_bound": bms / ms}
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
            times = ("ms", "plain_ms", "library_ms", "ms_host_paced",
                     "library_ms_host_paced")
            tot = dict.fromkeys(times + ("flops", "bytes", "err"), 0.0)
            routes = set()
            for c in CONV_CLASSES:
                r = classes[c[0]]
                for op in ops:
                    for k in times:
                        tot[k] += c[1] * r[op][k]
                    tot["flops"] += c[1] * r["flops"]
                    tot["bytes"] += c[1] * r["bytes"][op]
                    tot["err"] = max(tot["err"], r[op]["err"])
                    routes.update(r[op]["route"])
            tot["bound_ms"], tot["bound_by"] = bound(tot["flops"],
                                                     tot["bytes"], dtype)
            tot["vs_cudnn"] = tot["ms"] / tot["library_ms"]
            tot["vs_cudnn_host_paced"] = (tot["ms_host_paced"] /
                                          tot["library_ms_host_paced"])
            tot["tflops"] = tot["flops"] / tot["ms"] / 1e9
            tot["share_of_bound"] = tot["bound_ms"] / tot["ms"]
            tot["routes"] = sorted(routes)
            step[entry] = tot
        res[(B, dtype)] = (classes, step)
    return res


# bf16 wgrad: row tiles (64 rows) summed by wgmma before each f32 add
KBLOCKS = (1, 2, 4, 8, 16, 32)


def check_kblocks(torch, dev, seed):
    """The bf16 wgrad's drift against float64 and its time for each k-block
    length, at the class with the most rows (converter_4T_wide, B = 64:
    32768 rows), with the f32 bar max(4x plain's drift, 1e-6 of scale)."""
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda as cc

    x, w, b, dy, pad, dil = _b3_inputs(torch, CONV_CLASSES[-1], 64,
                                       "bfloat16", dev, seed)
    want = cc.conv1d_taps_wgrad_plain(x, dy, pad, dil, KW)
    ref = _wgrad64(x, dy, pad, dil, KW)
    scale = max(1.0, float(want.abs().max()))
    floor = float((want.double() - ref).abs().max())
    bar = max(4 * floor, 1e-6 * scale)
    rows = {"plain_drift_of_scale": floor / scale, "bar_of_scale":
            bar / scale, "chosen": cc.WGRAD_KBLOCK}
    for kb in KBLOCKS:
        got = cc._launch_wgrad(x, dy, pad, dil, KW, kblock=kb)
        torch.cuda.synchronize()
        err = float((got.double() - ref).abs().max())
        rows["kblock_%d" % kb] = {
            "rows": 64 * kb, "drift_of_scale": err / scale,
            "ok": err <= bar, "ms": device_ms(
                lambda: cc._launch_wgrad(x, dy, pad, dil, KW, kblock=kb),
                torch, reps=5)}
    return rows


# the fast forward's tile widths (columns) by type, and the batch it runs at
FWD_TILES = {"float32": (16, (64, 128)), "bfloat16": (64, (128, 256))}


def check_fwd_tiles(torch, dev, seed):
    """The fast forward and dgrad at either tile width, every class, f32 at
    B = 16 and bf16 at B = 64: device ms of each, and the width fwd_plan
    picks."""
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda as cc

    rows = {}
    for dtype, (B, widths) in FWD_TILES.items():
        for cls in CONV_CLASSES:
            x, w, b, dy, pad, dil = _b3_inputs(torch, cls, B, dtype, dev,
                                               seed)
            calls = {"fwd": (x, b, pad[0], False),
                     "dgrad": (dy, None, pad[1], True)}
            for op, (inp, bias, pl, dgrad) in calls.items():
                _, T, C = inp.shape
                N = w.shape[1] if dgrad else w.shape[2]
                rows["%s_%s_%s" % (dtype, cls[0], op)] = dict(
                    {"tile_%d_ms" % tn: device_ms(
                        lambda: cc._launch_fwd(inp, w, bias, pl, dil, dgrad,
                                               tn),
                        torch) for tn in widths},
                    picked=cc.fwd_plan(B, T, C, N, inp.dtype)[1][1])
    return rows


def b3_phase(torch, dev, seed, card, usage):
    """Phase B3: check_b3 printed per class and per step, the k-block sweep
    and the descriptor encode; fails on a bar or a ragged route. Returns
    check_b3's result and {"encode_ms", "kblocks"}."""
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda as cc

    b3 = check_b3(torch, dev, seed)
    ok, simple = True, []
    for (B, dtype), (classes, step) in b3.items():
        for cname, r in classes.items():
            ops = {op: {k: (round(v, 4) if isinstance(v, float) and
                            k.endswith("ms") else v)
                        for k, v in r[op].items()}
                   for op in ("fwd", "dgrad", "wgrad")}
            phase("B3", "%s B=%d %s: %s" % (cname, B, dtype,
                                            json.dumps(ops)))
            ok &= all(ops[op]["ok"] for op in ops)
            simple += ["%s %s %s" % (cname, dtype, op) for op in ops
                       if any(e.endswith("_simple") for e in
                              ops[op]["route"])]
        for entry, tot in step.items():
            kind = "fwd" if entry.endswith("fwd") else "wgrad"
            tot["ptxas"] = [u for u in usage if u.startswith(
                "%s_%s_" % (kind, "bf16" if dtype == "bfloat16" else "f32"))
                and "simple" not in u]
        phase("B3", "per train step (25 convs) B=%d %s (%s): %s" % (
            B, dtype, card, json.dumps(step)))
    kb = check_kblocks(torch, dev, seed)
    phase("B3", "bf16 wgrad k-block sweep, converter_4T_wide B=64 (32768 "
          "rows), drift of scale against float64 (%s): %s"
          % (card, json.dumps(kb)))
    tiles = check_fwd_tiles(torch, dev, seed)
    phase("B3", "forward/dgrad tile width sweep, f32 B=16, bf16 B=64 (%s): %s"
          % (card, json.dumps(tiles)))
    x = torch.empty(64 * 128 * 512, dtype=torch.bfloat16, device=dev)
    enc = cc.encode_ms(x)
    phase("B3", "TMA descriptor encode: %.5f host ms each; 2 a bf16 launch, "
          "75 bf16 launches a train step: %.4f host ms a step"
          % (enc, 150 * enc))
    if not ok or not kb["kblock_%d" % cc.WGRAD_KBLOCK]["ok"]:
        fail("kernel B3 disagreed with its plain version")
    if simple:
        fail("bench classes took the ragged route: %s" % simple)
    return b3, {"encode_ms": enc, "kblocks": kb, "fwd_tiles": tiles}


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
    box = [state]

    def run():
        box[0], _ = step(box[0], batch, gen)

    return box[0], profile_device(torch, run, n, ms_per_step)


def profile_device(torch, fn, n, ms_per_call):
    """Device time by kernel or copy name over n calls of fn
    (torch.profiler), per call, and the device's busy share against the
    unprofiled call time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows, host = [], []
    for e in prof.key_averages():
        # device events only: a CPU op's self device time repeats the
        # kernels it launched (a ctypes launch has no aten child)
        if str(e.device_type).split(".")[-1] != "CUDA":
            if e.self_cpu_time_total > 0:
                host.append((e.self_cpu_time_total / 1e3 / n, e.count / n,
                             e.key[:50]))
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = e.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.count / n, e.key[:70]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    copies = [r for r in rows if r[2].startswith("Memcpy")]
    return {"device_ms_per_step": round(busy, 3),
            "busy_share": round(busy / ms_per_call, 4),
            "launches": round(sum(r[1] for r in rows), 1),
            "copies": [[round(a, 3), round(c, 1), k] for a, c, k in copies],
            "top": [[round(a, 3), round(c, 1), k] for a, c, k in rows[:12]],
            "host_top": [[round(a, 3), round(c, 1), k] for a, c, k in
                         sorted(host, reverse=True)[:10]]}


def conv_host_us(torch, dev, n=200):
    """Host microseconds of one weight-normalised conv layer, forward and
    backward through autograd, in each conv mode and type, at a shape whose
    device work is a few microseconds (B = 2, T = 32, 64 -> 128 channels,
    dilation 3): what the step's host pays for each of its 25 convs."""
    from deepvoice3_pytorch_tpu_torch.ops import core

    g = torch.Generator().manual_seed(0)
    out = {}
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        p = {"v": torch.randn(KW, 64, 128, generator=g),
             "g": torch.rand(128, generator=g) + 0.5,
             "b": torch.randn(128, generator=g) * 0.1}
        p = {k: v.to(dev, dt).requires_grad_(True) for k, v in p.items()}
        x = torch.randn(2, 32, 64, generator=g).to(dev, dt)
        dy = torch.randn(2, 32, 128, generator=g).to(dev, dt)
        for mode in ("kernel", "library"):
            def one():
                with core.conv_mode(mode):
                    y = core.conv1d_apply(p, x, dilation=3)
                y.backward(dy)
            for _ in range(5):
                one()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                one()
            torch.cuda.synchronize()
            out["%s_%s" % (mode, dtype)] = round(
                (time.perf_counter() - t) / n * 1e6, 1)
    return out


def train_main_path(torch, pkg, hp, dev, seed, card):
    """The LJSpeech train step at bench.py's shapes in both conv modes,
    taken in turns, plus steps on a synthetic-corpus batch. Returns
    (B3 launches in the kernel-mode steps, rows of numbers)."""
    from torch.utils.flop_counter import FlopCounterMode

    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.ops import core
    from deepvoice3_pytorch_tpu_torch.training import trainer
    from deepvoice3_pytorch_tpu_torch.utils import synthcorpus as sc

    host_us = conv_host_us(torch, dev)
    phase("train", "host us per conv layer, forward + backward (device "
          "work ~us): %s" % json.dumps(host_us))
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
        row["conv_host_us"] = host_us
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
                  "launches/step, name]: %s; host self time (profiled) "
                  "[ms/step, calls/step, op]: %s" % (
                      B, dtype, mode, prof["device_ms_per_step"],
                      prof["busy_share"], json.dumps(prof["top"][:8]),
                      json.dumps(prof["host_top"][:8])))

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


def preset_hparams(hparams_mod, repo, name):
    hp = hparams_mod.default_hparams()
    with open(os.path.join(repo, "presets", name + ".json")) as f:
        hp.parse_json(f.read())
    return hp


def ljspeech_hparams(hparams_mod, repo):
    return preset_hparams(hparams_mod, repo, "deepvoice3_ljspeech")


def batch_speakers(cfg, B):
    """Speaker ids of a B-sentence batch: (7 i) % n_speakers for a
    multi-speaker model, else None."""
    if cfg.n_speakers <= 1:
        return None
    return [(7 * i) % cfg.n_speakers for i in range(B)]


def key_width(cfg):
    """Width of the encoder's keys and values."""
    return (cfg.decoder.channels if cfg.builder == "nyanko"
            else cfg.decoder.embed_dim)


def check_b1(torch, pkg, hp, dev, seed):
    """B1 kernel vs plain at a preset's widths: B = 32, Tk = 96, one 32-step
    chunk, random keys and values; a multi-speaker preset decodes speakers
    (7 i) % n_speakers. Returns (errors, plain-vs-float64 floor,
    last_attended flips, kernel ms, plain ms, ring placement). Kernel ms is
    the whole fused_decode call (plan and weight folding included, as
    earlier PRs measured it); the placement row adds the time of the launch
    alone, with the host's ring placement and with every ring buffer in
    device memory."""
    from deepvoice3_pytorch_tpu_torch import builder
    from deepvoice3_pytorch_tpu_torch.ops import core
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device=dev)
    B, Tk, steps = 32, 96, 32
    g = torch.Generator().manual_seed(seed + 1)
    E = key_width(cfg)
    keys = (torch.randn(B, Tk, E, generator=g) * 0.5).to(dev)
    values = (torch.randn(B, Tk, E, generator=g) * 0.5).to(dev)
    lengths = torch.randint(40, Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None, :].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    pd = params["decoder"]
    fam = cfg.family
    spk = batch_speakers(cfg, B)
    se = (None if spk is None else builder.embed_speakers(
        params, cfg, torch.tensor(spk, device=dev)))
    fi = fam.fused_decode_inputs(pd, cfg.decoder, (keys, values), pos, steps,
                                 speaker_embed=se)
    mask = core.get_mask_from_lengths(lengths, Tk)
    init = torch.zeros(B, cfg.decoder.in_dim * cfg.decoder.r, device=dev)
    min_steps = cfg.decoder.min_decoder_steps
    dec = fd.FusedDecoder(pd, cfg.decoder, fi, mask, steps)
    p = dec.plan
    fixed = fd.smem_floats(p.act_dim, p.cat_dim, dec.C, dec.E, dec.tk,
                           len(p.buffers), dec.n_la)
    off_chip = fd.FusedDecoder(pd, cfg.decoder, fi, mask, steps,
                               smem_budget=4 * fixed)

    def launch(d):
        carry, outs = d.zero_carry(init), d.new_outputs(steps)
        return lambda: d.launch(carry, outs, 0, steps)

    placement = {"ring_bytes_per_row": 4 * dec.ring_floats,
                 "shared_bytes_per_row": 4 * dec.ring_smem,
                 "device_bytes_per_row": 4 * dec.scratch_floats,
                 "buffers_in_device_memory": int(
                     (dec.bufs[:, 4] == 0).sum()) if p.buffers else 0,
                 "launch_ms": cuda_ms(launch(dec), torch, reps=10),
                 "launch_ms_all_rings_in_device_memory": cuda_ms(
                     launch(off_chip), torch, reps=10)}

    def kernel():
        return fd.fused_decode(pd, cfg.decoder, fi, mask, init, steps,
                               min_steps, early_exit=False)

    def plain():
        return fd.fused_decode_plain(pd, cfg.decoder, fi, mask, init, steps,
                                     min_steps, early_exit=False)

    got, want = kernel(), plain()
    pd64 = copy.deepcopy(pd).double()
    fi64 = fam.fused_decode_inputs(
        pd64, cfg.decoder, (keys.double(), values.double()), pos, steps,
        speaker_embed=None if se is None else se.double())
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
    return errs, floor, flips, ms, plain_ms, placement


def b1_bound_ms(torch, pkg, hp, dev, seed, B=32, Tk=96, steps=32):
    """Least time for check_b1's decode: per row and step, one MAC per
    folded decoder weight (the key/value and speaker projections run
    outside the kernel) plus scores and context over Tk keys per attention
    layer, in f32 outside the tensor cores; bytes: the weights, K/V, mask,
    speaker biases and position rows read once, the four outputs written
    once."""
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device="cpu")
    sd = {k: v for k, v in params["decoder"].state_dict().items()
          if "positions" not in k and "key_proj" not in k
          and "value_proj" not in k and "speaker_proj" not in k}
    dc = cfg.decoder
    E, C = key_width(cfg), fd.state_dim(dc)
    n_att = dc.num_attention_layers
    n_sp = sum(fd.build_plan(params["decoder"], dc).sp_widths)
    macs = sum(v.numel() for k, v in sd.items() if k.endswith(".v")) \
        + n_att * 2 * Tk * E
    flops = 2.0 * macs * B * steps
    nbytes = 4 * (sum(v.numel() for v in sd.values())
                  + n_att * 2 * B * Tk * E + B * Tk + B * n_sp + steps * C
                  + B * steps * (dc.in_dim * dc.r + Tk + 1 + C))
    return bound(flops, nbytes, "float32")


def b2_bound_ms(B=32, n=400, fft=1024, hop=256, n_iters=16, planes=0):
    """Least time for a Griffin-Lim retrieval: two DFT GEMMs per iteration
    and a last synthesis, (B n) x 2F x fft each, at the bf16 tensor-core
    rate; bytes: the magnitudes read once, the waveform written once, and
    `planes` more (B, n, F) f32 arrays (a given start, a returned
    spectrum) read or written once."""
    F = fft // 2 + 1
    flops = (2 * n_iters + 1) * 2.0 * B * n * 2 * F * fft
    nbytes = 4 * ((1 + planes) * B * n * F + B * (n + fft // hop - 1) * hop)
    return bound(flops, nbytes, "bfloat16")


FFT, HOP = 1024, 256


def tone_mags(torch, dev, seed, B, n):
    """Magnitudes of real signals: harmonic tones with vibrato plus noise,
    (B, n, 513) at fft 1024, hop 256 (lws framing)."""
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    win = dsp.lws_hann_window(FFT, HOP)
    g = torch.Generator().manual_seed(seed)
    t = torch.arange(n * HOP, dtype=torch.float64) / 22050.0
    f0 = 100.0 + 150.0 * torch.rand(B, 1, generator=g, dtype=torch.float64)
    vib = 1.0 + 0.02 * torch.sin(2 * np.pi * 5.0 * t)[None, :]
    phase = 2 * np.pi * torch.cumsum(f0 * vib, dim=1) / 22050.0
    x = sum(torch.sin(h * phase) / h for h in range(1, 8))
    x = x + 0.01 * torch.randn(B, n * HOP, generator=g, dtype=torch.float64)
    x = x.float().to(dev)
    return torch.abs(dsp.stft(dsp.lws_pad(x, FFT, HOP), FFT, HOP,
                              torch.from_numpy(win).to(dev)))[:, :n] \
        .contiguous()


def spectral_convergence(torch, wav, S, fft=FFT, hop=HOP):
    """||  |STFT(wav)| - S || / || S || over S's frames (lws framing): the
    phase-retrieval quality of a Griffin-Lim output against the magnitudes
    it was given."""
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    win = torch.from_numpy(dsp.lws_hann_window(fft, hop)).to(wav.device)
    n = S.shape[-2]
    M = torch.abs(dsp.stft(dsp.lws_pad(wav, fft, hop), fft, hop, win))
    return float(torch.linalg.norm(M[..., :n, :] - S)
                 / torch.linalg.norm(S))


def check_b2(torch, pkg, dev, seed):
    """B2 kernel vs plain at (32, 400, 513)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    B, n, fft, hop = 32, 400, FFT, HOP
    win = dsp.lws_hann_window(fft, hop)
    S = tone_mags(torch, dev, seed + 2, B, n)
    mats = gl_cuda.gl_mats(fft, win, dev)

    def kernel():
        return gl_cuda.griffin_lim(S, fft, hop, win, n_iters=16,
                                   momentum=0.9, phase_init="spsi",
                                   mats=mats)

    def plain():
        return gl_cuda.griffin_lim_plain(S, fft, hop, win, n_iters=16,
                                         momentum=0.9, phase_init="spsi",
                                         mats=mats)[:, :n * hop]

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = maxabs(got, want)
    rel = err / float(want.abs().max())
    ms = cuda_ms(kernel, torch)
    plain_ms = cuda_ms(plain, torch)
    return (err, rel, spectral_convergence(torch, got, S),
            spectral_convergence(torch, want, S), ms, plain_ms)


def check_b2_stream(torch, dev, seed, B=8, n=152, n_pinned=16, n_iters=32):
    """B2's streaming modes, kernel vs plain, at a stream window's shape
    (16 context + 128 emitted + 8 lookahead frames): a given start (the
    magnitudes on their SPSI phase), 16 pinned frames, the retrieved
    spectrum returned. Also whether the pinned frames of the returned
    spectrum equal the start's exactly, for the kernel and for the plain
    version (each against its own spectrum after 0 iterations)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    win = dsp.lws_hann_window(FFT, HOP)
    S = tone_mags(torch, dev, seed + 3, B, n)
    phi = dsp.spsi_phase(S, FFT, HOP)
    kw = dict(momentum=0.9, mats=gl_cuda.gl_mats(FFT, win, dev),
              init_spec=(S * torch.cos(phi), S * torch.sin(phi)),
              n_pinned=n_pinned, return_spec=True)

    def kernel(iters=n_iters):
        return gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=iters, **kw)

    def plain(iters=n_iters):
        wav, spec = gl_cuda.griffin_lim_plain(S, FFT, HOP, win,
                                              n_iters=iters, **kw)
        return wav[:, :n * HOP], spec

    (got, spec), (want, want_spec) = kernel(), plain()
    starts = (kernel(0)[1], plain(0)[1])
    torch.cuda.synchronize()
    pinned_exact = [all(torch.equal(a[:, :n_pinned], b[:, :n_pinned])
                        for a, b in zip(sp, st))
                    for sp, st in zip((spec, want_spec), starts)]
    err = maxabs(got, want)
    return {"err": err, "rel": err / float(want.abs().max()),
            "sc": spectral_convergence(torch, got, S),
            "sc_plain": spectral_convergence(torch, want, S),
            "pinned_exact": pinned_exact,
            "ms": cuda_ms(kernel, torch), "plain_ms": cuda_ms(plain, torch),
            "bound": b2_bound_ms(B, n, FFT, HOP, n_iters, planes=4)}


def check_p(torch, pkg, dev, seed, repo, B=32, n=600, n_iters=16):
    """The probe kernel P (B2 with the windows applied in f32 outside the
    bf16 DFT matrices) at the probe's shape, kernel vs plain; then its own
    path, what the probe measured: spectral convergence on the golden
    fixture (kernel and plain), the per-iteration slope from the 4- and
    16-iteration times, and the time of the folded B2 at the same shape.
    Returns (row of numbers, P launches on its own path)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    win = dsp.lws_hann_window(FFT, HOP)
    S = tone_mags(torch, dev, seed + 4, B, n)
    unfolded = gl_cuda.gl_mats(FFT, win, dev, fold=False)
    folded_mats = gl_cuda.gl_mats(FFT, win, dev)

    def kernel(iters=n_iters, S=S):
        return gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=iters,
                                   momentum=0.9, mats=unfolded,
                                   fold_windows=False)

    def plain(S=S):
        return gl_cuda.griffin_lim_plain(
            S, FFT, HOP, win, n_iters=n_iters, momentum=0.9, mats=unfolded,
            fold_windows=False)[:, :S.shape[1] * HOP]

    def folded():
        return gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=n_iters,
                                   momentum=0.9, mats=folded_mats)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = maxabs(got, want)
    row = {"err": err, "rel": err / float(want.abs().max()),
           "sc": spectral_convergence(torch, got, S),
           "sc_plain": spectral_convergence(torch, want, S),
           "plain_ms": cuda_ms(plain, torch),
           "bound": b2_bound_ms(B, n, FFT, HOP, n_iters)}

    gl_cuda.KERNEL.reset_counts()
    lin = np.load(os.path.join(repo, "tests", "data",
                               "dsp_golden_linear.npy"))       # (F, n)
    ap = pkg["AudioProcessor"](ljspeech_hparams(pkg["hparams"], repo))
    Sg = ap._denorm_pow(torch.from_numpy(lin.T.copy())[None].to(dev))
    row["sc_golden"] = spectral_convergence(torch, kernel(S=Sg), Sg)
    row["ms_4"] = cuda_ms(lambda: kernel(4), torch)
    row["ms"] = cuda_ms(kernel, torch)
    launches = gl_cuda.KERNEL.by_entry.get("unfolded", 0)
    row["sc_golden_plain"] = spectral_convergence(torch, plain(S=Sg), Sg)
    row["us_per_item_iter"] = ((row["ms"] - row["ms_4"]) * 1e3
                               / (n_iters - 4) / B)
    row["folded_ms"] = cuda_ms(folded, torch)
    return row, launches


def tiny_model(pkg, seed=7, name="deepvoice3"):
    """A tiny model of builder `name` (the LJSpeech structure; nyanko; five
    speakers) on the CPU, an audio configuration at fft 128, hop 32, and
    the speaker ids of three sentences (None for one speaker)."""
    from deepvoice3_pytorch_tpu_torch import builder
    import torch

    kw = dict(n_vocab=pkg["en"].n_vocab, embed_dim=32, mel_dim=16,
              linear_dim=65, r=1, downsample_step=4, kernel_size=3,
              encoder_channels=32, decoder_channels=32,
              converter_channels=32, use_memory_mask=True, max_positions=64)
    if name != "nyanko":
        kw.update(key_projection=True, value_projection=True)
    if name == "deepvoice3_multispeaker":
        kw.update(n_speakers=5, speaker_embed_dim=8)
    cfg = getattr(builder, name)(**kw)
    params = builder.model_init(cfg, torch.Generator().manual_seed(seed),
                                device="cpu")
    hp = pkg["hparams"].default_hparams()
    hp.fft_size, hp.hop_size = 128, 32
    spk = [3, 0, 2] if cfg.n_speakers > 1 else None
    return cfg, params, pkg["AudioProcessor"](hp), spk


def preemphasis(torch, x, coef):
    x = torch.from_numpy(np.asarray(x, np.float32))
    return torch.cat([x[..., :1], x[..., 1:] - coef * x[..., :-1]], -1)


def sc_ratio(torch, ap, wav, wav_ref, lin_ref):
    """Spectral convergence of `wav` over that of `wav_ref`, both against
    the magnitudes Griffin-Lim was given for the normalized linear frames
    `lin_ref` (the waveforms pre-emphasised back first)."""
    S = ap._denorm_pow(torch.from_numpy(np.asarray(lin_ref, np.float32)))
    sc = [spectral_convergence(torch, preemphasis(torch, w,
                                                  ap.preemphasis_coef), S,
                               ap.fft_size, ap.hop_size)
          for w in (wav, wav_ref)]
    return sc[0] / sc[1]


def check_small_reference(torch, pkg, dev, name="deepvoice3"):
    """A tiny model through tts_batch on the GPU (kernels) and on the CPU
    (plain versions)."""
    cfg, params, ap, spk = tiny_model(pkg, name=name)
    texts = SENTENCES[:3]
    ref = pkg["synthesis"].tts_batch(params, cfg, ap, pkg["en"], texts,
                                     speaker_ids=spk, max_decoder_steps=40)
    got = pkg["synthesis"].tts_batch(params.to(dev), cfg, ap, pkg["en"],
                                     texts, speaker_ids=spk,
                                     max_decoder_steps=40)
    worst = {"steps": 0, "mel": 0.0, "linear": 0.0, "alignment": 0.0,
             "wave_rel": 0.0, "sc_ratio": 0.0}
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
        lin = (r["linear"] - ap.min_level_db) / -ap.min_level_db
        worst["sc_ratio"] = max(worst["sc_ratio"], sc_ratio(
            torch, ap, o["waveform"], r["waveform"], lin))
    return worst


def stage_times(torch, synthesis, params, cfg, ap, frontend, texts,
                speaker_ids=None):
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
        spk = synthesis.speaker_id_tensor(cfg, speaker_ids, dev)
        mark("frontend")
        _, pin, _, _, dec_len = model_decode(params, cfg, x, pos,
                                             speaker_ids=spk,
                                             input_lengths=lengths,
                                             max_decoder_steps=200)
        n_bucket = min(200, synthesis._round_up(
            int(dec_len.max()) + synthesis.SLACK_DEC_STEPS,
            synthesis.BUCKET_DEC_STEPS))
        mark("encoder+decode")
        linear = model_postnet(params, cfg, pin[:, :n_bucket * cfg.r],
                               speaker_ids=spk)
        mark("converter")
        ap.inv_spectrogram_device(linear)
        mark("griffin_lim+inv_preemphasis")
    out["decoded_steps_max"] = int(dec_len.max())
    return out


# ---------------------------------------------------------------------------
# streaming synthesis and the HTTP engine
# ---------------------------------------------------------------------------


def check_small_stream(torch, pkg, dev, name="deepvoice3"):
    """The tiny model's tts_stream on the GPU (kernels) and on the CPU
    (plain versions), emit_linear on."""
    cfg, params, ap, spk = tiny_model(pkg, name=name)
    kw = dict(max_decoder_steps=40, emit_linear=True, speaker_ids=spk)
    texts = SENTENCES[:3]
    stream = pkg["streaming"].tts_stream
    ref = list(stream(params, cfg, ap, pkg["en"], texts, **kw))
    got = list(stream(params.to(dev), cfg, ap, pkg["en"], texts, **kw))
    worst = {"steps": int((got[-1]["decoded_steps"]
                           != ref[-1]["decoded_steps"]).sum()),
             "chunks": [c["audio"].shape[1] for c in got]
             != [c["audio"].shape[1] for c in ref],
             "linear": 0.0, "wave_rel": 0.0, "sc_ratio": 0.0}
    if not worst["chunks"]:
        for g, r in zip(got, ref):
            worst["linear"] = max(worst["linear"], float(
                np.abs(g["linear"] - r["linear"]).max()))
            worst["wave_rel"] = max(worst["wave_rel"], float(
                np.abs(g["audio"] - r["audio"]).max()
                / max(np.abs(r["audio"]).max(), 1e-9)))
        lin = np.concatenate([c["linear"] for c in ref], axis=1)
        audio = [np.concatenate([c["audio"] for c in run], axis=1)
                 for run in (got, ref)]
        worst["sc_ratio"] = max(sc_ratio(torch, ap, a, b, lin[i])
                                for i, (a, b) in enumerate(zip(*audio)))
    return worst


def run_stream(torch, streaming, params, cfg, ap, en, texts,
               speaker_ids=None):
    """One whole tts_stream (LJSpeech schedule: first chunk 16, then 32 per
    launch, up to 200 steps). Returns (chunks, host seconds to the first
    chunk, host seconds to the end)."""
    torch.cuda.synchronize()
    t = time.time()
    gen = streaming.tts_stream(params, cfg, ap, en, texts,
                               speaker_ids=speaker_ids,
                               max_decoder_steps=200, first_chunk=16)
    chunks = [next(gen)]
    t_first = time.time() - t
    chunks += list(gen)
    return chunks, t_first, time.time() - t


def stream_stages(torch, streaming, synthesis, params, cfg, ap, en, text,
                  speaker_id=None):
    """Host-clock milliseconds of the stages of a stream's first chunk at
    B = 1, each ended by a device synchronise: what tts_stream does up to
    its first yield, one stage at a time."""
    out = {}
    t = [time.time()]

    def mark(name):
        torch.cuda.synchronize()
        t.append(time.time())
        out[name] = round((t[-1] - t[-2]) * 1e3, 3)

    dev = next(iter(params.parameters())).device
    with torch.inference_mode():
        x, pos, lengths = (torch.from_numpy(a).to(dev) for a in
                           synthesis._prepare_batch(en, [text], 0.0, 8))
        spk = synthesis.speaker_id_tensor(
            cfg, None if speaker_id is None else [speaker_id], dev)
        mark("frontend")
        dec, carry, outputs = streaming.prepare_decode(
            params, cfg, x, pos, lengths, 200, speaker_ids=spk)
        mark("encoder+decoder_plan")
        o, _, d, s = streaming.launch_chunk(dec, carry, outputs, 0, 16)
        mark("decode_16_steps")
        pin = s if cfg.use_decoder_state_for_postnet_input else o
        em = streaming.StreamEmitter(params, cfg, ap, spk)
        em.mel_hist, em.M = pin, pin.shape[1]
        lin = em.conv_emit(em.M - em.ctx_r)
        mark("converter_window")
        token = em.vocoder.push_async(lin)
        mark("griffin_lim_window")
        d.cpu()
        mark("fetch_done_flags")
        audio = em.vocoder.finish(token)
        mark("fetch_audio+crossfade+iir")
        # the same first window once more under the profiler: its device
        # time against the host time of the stage above
        prof = profile_device(
            torch, lambda: streaming.StreamingVocoder(ap).push_async(lin), 3,
            out["griffin_lim_window"])
    out["griffin_lim_window_device_ms"] = prof["device_ms_per_step"]
    out["griffin_lim_window_launches"] = prof["launches"]
    out["first_chunk_samples"] = int(audio.shape[1])
    out["gl_window_frames"] = int(lin.shape[1])
    return out


def stream_main_path(torch, pkg, params, cfg, ap):
    """The streaming main path at the LJSpeech preset, measured as bench.py
    measures it, at B = 1 and B = 8 (the first B sentences): after a
    warm-up, five streams; of the one with the least time to first audio
    (the first next() of the generator), ttfa_ms, the whole stream's wall
    time and its RTF (decoded-length audio over that wall time). Returns
    (rows, launches of B1, B2's stream modes and B3 in those runs)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    streaming, en = pkg["streaming"], pkg["en"]
    args = (torch, streaming, params, cfg, ap, en)
    for k in (fd.KERNEL, gl_cuda.KERNEL, conv_cuda.KERNEL):
        k.reset_counts()
    rows = {}
    for B in (1, 8):
        run_stream(*args, SENTENCES[:B])               # warm-up
        runs = [run_stream(*args, SENTENCES[:B]) for _ in range(5)]
        chunks, t_first, wall = min(runs, key=lambda r: r[1])
        dec = chunks[-1]["decoded_steps"]
        audio = np.concatenate([c["audio"] for c in chunks], axis=1)
        if not chunks[-1]["final"] or not np.isfinite(audio).all() or \
                audio.shape[1] < streaming.decoded_samples(cfg, ap,
                                                           dec.max()):
            fail("stream B=%d: bad audio %s for decoded steps %s"
                 % (B, audio.shape, dec.tolist()))
        audio_s = streaming.decoded_samples(cfg, ap, dec.sum()) \
            / ap.sample_rate
        rows["B%d" % B] = {
            "ttfa_ms": t_first * 1e3,
            "ttfa_ms_all": [round(r[1] * 1e3, 3) for r in runs],
            "stream_total_ms": wall * 1e3,
            "first_chunk_audio_ms": chunks[0]["audio"].shape[1]
            / ap.sample_rate * 1e3,
            "audio_s": audio_s, "rtf": audio_s / wall,
            "chunks": len(chunks), "decoded_steps": dec.tolist()}
    launches = {"fused_decode": fd.KERNEL.launches,
                "griffin_lim_stream": sum(
                    gl_cuda.KERNEL.by_entry.get(m, 0)
                    for m in ("init", "pinned")),
                "griffin_lim_by_mode": dict(gl_cuda.KERNEL.by_entry),
                "conv_taps": conv_cuda.KERNEL.launches}
    res = pkg["synthesis"].tts_batch(params, cfg, ap, en, SENTENCES[:8],
                                     max_decoder_steps=200)
    rows["batch_decoded_steps"] = [r["num_decoder_steps"] for r in res]
    rows["stages"] = stream_stages(torch, streaming, pkg["synthesis"],
                                   params, cfg, ap, en, SENTENCES[0])
    rows["profile_B1"] = profile_device(
        torch, lambda: run_stream(*args, SENTENCES[:1]), 3,
        rows["B1"]["stream_total_ms"])
    return rows, launches


def serve_main_path(torch, pkg, params, cfg, ap):
    """TTSEngine + make_handler on a ThreadingHTTPServer at 127.0.0.1:0:
    /healthz, three /tts requests (client-side time to the first PCM
    bytes), one 400, /stats. Returns (rows, launches of B1, B2's stream
    modes and B3 in the requests, problems found)."""
    import struct
    import threading
    import urllib.error
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    serve, streaming, en = pkg["serve"], pkg["streaming"], pkg["en"]
    engine = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=200)
    engine.warmup()
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    problems, rows = [], {"requests": []}
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            if r.read() != b"ok":
                problems.append("/healthz")
        for k in (fd.KERNEL, gl_cuda.KERNEL, conv_cuda.KERNEL):
            k.reset_counts()
        texts = SENTENCES[:3]
        for text in texts:
            url = base + "/tts?" + urllib.parse.urlencode({"text": text})
            t = time.time()
            with urllib.request.urlopen(url, timeout=300) as r:
                head = r.read(46)          # WAV header + the first sample
                t_first = time.time() - t
                body = head + r.read()
            pcm = np.frombuffer(body[44:], "<i2")
            rows["requests"].append({"ttfa_ms": t_first * 1e3,
                                     "wall_ms": (time.time() - t) * 1e3,
                                     "samples": int(len(pcm))})
            if body[:4] != b"RIFF" or body[8:12] != b"WAVE" or \
                    struct.unpack("<I", body[24:28])[0] != ap.sample_rate:
                problems.append("bad WAV header for %r" % text)
        launches = {"fused_decode": fd.KERNEL.launches,
                    "griffin_lim_stream": sum(
                        gl_cuda.KERNEL.by_entry.get(m, 0)
                        for m in ("init", "pinned")),
                    "conv_taps": conv_cuda.KERNEL.launches}
        for text, req in zip(texts, rows["requests"]):
            final = list(streaming.tts_stream(params, cfg, ap, en, [text],
                                              max_decoder_steps=200))[-1]
            want = streaming.decoded_samples(cfg, ap,
                                             final["decoded_steps"][0])
            req["decoded_samples"] = want
            if req["samples"] != want:
                problems.append("PCM length %d != decoded_samples %d"
                                % (req["samples"], want))
        try:
            urllib.request.urlopen(base + "/tts", timeout=60)
            problems.append("no 400 for /tts without text")
        except urllib.error.HTTPError as e:
            if e.code != 400:
                problems.append("/tts without text gave %d" % e.code)
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            rows["stats"] = json.loads(r.read())
        # why the engine keeps one producer thread: the same stream's time
        # to first audio in fresh threads, beside the calling thread's
        rows["thread_ttfa_ms"] = []
        for _ in range(3):
            box = []
            th = threading.Thread(target=lambda: box.append(run_stream(
                torch, streaming, params, cfg, ap, en, texts[:1])[1]))
            th.start()
            th.join()
            rows["thread_ttfa_ms"].append(box[0] * 1e3)
        rows["caller_ttfa_ms"] = [
            run_stream(torch, streaming, params, cfg, ap, en,
                       texts[:1])[1] * 1e3 for _ in range(3)]
        if rows["stats"]["requests_total"] != 3 or \
                rows["stats"]["requests_failed"]:
            problems.append("/stats: %s" % rows["stats"])
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    return rows, launches, problems


# ---------------------------------------------------------------------------
# the nyanko and multi-speaker presets
# ---------------------------------------------------------------------------


def serve_speaker_request(torch, pkg, params, cfg, ap, speaker_id):
    """One /tts request with a speaker_id to a TTSEngine on 127.0.0.1:0;
    returns the problems found (PCM length against the decoded samples of
    the same speaker's stream)."""
    import threading
    import urllib.parse
    import urllib.request
    from http.server import ThreadingHTTPServer

    serve, streaming, en = pkg["serve"], pkg["streaming"], pkg["en"]
    engine = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=200)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    text = SENTENCES[1]
    url = "http://127.0.0.1:%d/tts?%s" % (
        server.server_address[1],
        urllib.parse.urlencode({"text": text, "speaker_id": speaker_id}))
    try:
        with urllib.request.urlopen(url, timeout=300) as r:
            body = r.read()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    final = list(streaming.tts_stream(params, cfg, ap, en, [text],
                                      speaker_ids=[speaker_id],
                                      max_decoder_steps=200))[-1]
    want = streaming.decoded_samples(cfg, ap, final["decoded_steps"][0])
    got = (len(body) - 44) // 2
    return [] if got == want and body[:4] == b"RIFF" else [
        "speaker %d: PCM length %d != decoded_samples %d"
        % (speaker_id, got, want)]


def preset_main_path(torch, pkg, hp, dev, seed, card, label):
    """A preset's main path: tts_batch on the 32 sentences and the first 8
    (after a warm-up), then one B = 1 and one B = 8 stream (after a
    warm-up), speakers (7 i) % n_speakers for a multi-speaker preset.
    Returns (rows, B1 launches on the path)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    synthesis, streaming, en = pkg["synthesis"], pkg["streaming"], pkg["en"]
    cfg, params = pkg["model_builder"].build_model(hp, en.n_vocab, seed=seed,
                                                   device=dev)
    ap = pkg["AudioProcessor"](hp)
    kernels = (fd.KERNEL, gl_cuda.KERNEL, conv_cuda.KERNEL)

    def run(texts):
        torch.cuda.synchronize()
        t = time.time()
        res = synthesis.tts_batch(params, cfg, ap, en, texts,
                                  speaker_ids=batch_speakers(cfg, len(texts)),
                                  max_decoder_steps=200)
        torch.cuda.synchronize()
        return res, time.time() - t

    run(SENTENCES)                                  # warm-up
    for k in kernels:
        k.reset_counts()
    rows = {}
    for texts in (SENTENCES, SENTENCES[:8]):
        res, wall = run(texts)
        for r in res:
            n = r["num_decoder_steps"]
            if r["waveform"].shape != (streaming.decoded_samples(
                    cfg, ap, n),) or not np.isfinite(r["waveform"]).all():
                fail("%s: bad waveform: shape %s for %d steps"
                     % (label, r["waveform"].shape, n))
        steps = [r["num_decoder_steps"] for r in res]
        audio_s = sum(len(r["waveform"]) for r in res) / hp.sample_rate
        rows["batch_B%d" % len(texts)] = {
            "wall_ms": wall * 1e3, "audio_s": audio_s, "rtf": audio_s / wall,
            "decoded_steps_min_max": [min(steps), max(steps)]}
        phase(label, "tts_batch B=%d: %.1f ms wall, %.2f s of audio, RTF "
              "%.1fx, decoded steps min/max %d/%d (%s)" % (
                  len(texts), wall * 1e3, audio_s, audio_s / wall,
                  min(steps), max(steps), card))
    batch = {"fused_decode": fd.KERNEL.launches,
             "griffin_lim": gl_cuda.KERNEL.by_entry.get("batch", 0),
             "conv_taps": conv_cuda.KERNEL.launches}
    if batch["fused_decode"] <= 0 or batch["griffin_lim"] <= 0 or \
            batch["conv_taps"]:
        fail("%s: tts_batch launches %s: B1 and B2 must launch, B3 not"
             % (label, batch))

    args = (torch, streaming, params, cfg, ap, en)
    for k in kernels:
        k.reset_counts()
    for B in (1, 8):
        spk = batch_speakers(cfg, B)
        run_stream(*args, SENTENCES[:B], speaker_ids=spk)      # warm-up
        chunks, t_first, wall = run_stream(*args, SENTENCES[:B],
                                           speaker_ids=spk)
        dec = chunks[-1]["decoded_steps"]
        audio = np.concatenate([c["audio"] for c in chunks], axis=1)
        if not chunks[-1]["final"] or not np.isfinite(audio).all():
            fail("%s: stream B=%d: bad audio" % (label, B))
        audio_s = streaming.decoded_samples(cfg, ap, dec.sum()) \
            / ap.sample_rate
        rows["stream_B%d" % B] = {"ttfa_ms": t_first * 1e3,
                                  "stream_total_ms": wall * 1e3,
                                  "audio_s": audio_s, "rtf": audio_s / wall,
                                  "decoded_steps": dec.tolist()}
        phase(label, "stream B=%d: ttfa_ms %.3f, stream %.3f ms for %.3f s "
              "of decoded audio, RTF %.2fx, %d chunks (%s)" % (
                  B, t_first * 1e3, wall * 1e3, audio_s, audio_s / wall,
                  len(chunks), card))
    stream = {"fused_decode": fd.KERNEL.launches,
              "griffin_lim_stream": sum(gl_cuda.KERNEL.by_entry.get(m, 0)
                                        for m in ("init", "pinned")),
              "conv_taps": conv_cuda.KERNEL.launches}
    if stream["fused_decode"] <= 0 or stream["griffin_lim_stream"] <= 0 \
            or stream["conv_taps"]:
        fail("%s: stream launches %s: B1 and B2 must launch, B3 not"
             % (label, stream))
    rows["launches"] = {"tts_batch": batch, "stream": stream}
    phase(label, "kernel launches: %s" % json.dumps(rows["launches"]))
    rows["stages"] = stage_times(torch, synthesis, params, cfg, ap, en,
                                 SENTENCES,
                                 batch_speakers(cfg, len(SENTENCES)))
    phase(label, "B=32 wall time by stage: %s" % json.dumps(rows["stages"]))
    rows["stream_stages"] = stream_stages(
        torch, streaming, synthesis, params, cfg, ap, en, SENTENCES[0],
        (batch_speakers(cfg, 1) or [None])[0])
    phase(label, "first stream chunk at B=1 by stage (host ms, synchronised "
          "after each): %s" % json.dumps(rows["stream_stages"]))
    if cfg.n_speakers > 1:
        problems = serve_speaker_request(torch, pkg, params, cfg, ap, 7)
        if problems:
            fail("%s: serve: %s" % (label, problems))
        phase(label, "serve: one /tts request with speaker_id=7, PCM length "
              "= decoded_samples")
    return rows, batch["fused_decode"] + stream["fused_decode"]


# ---------------------------------------------------------------------------
# continuous batching: B1's serving modes, the batcher, the slots engine
# ---------------------------------------------------------------------------


def slot_inputs(torch, fd, fi, lengths, Tk, scales):
    """fused_decode.SlotInputs whose row b holds row b of the batched
    fused-decode inputs fi, written the way an admission writes it."""
    from deepvoice3_pytorch_tpu_torch.ops import core

    mask = core.get_mask_from_lengths(lengths, Tk)

    def row(b):
        one = slice(b, b + 1)
        return dict(fi, projected_kv=[
            None if p is None else (p[0][one], p[1][one])
            for p in fi["projected_kv"]],
            w_query=None if fi["w_query"] is None else fi["w_query"][one],
            speaker_bias=[x[one] for x in fi["speaker_bias"] or []],
            speaker_embed=(None if fi.get("speaker_embed") is None
                           else fi["speaker_embed"][one]))

    si = fd.slot_inputs(row(0), mask.shape[0], Tk)
    for b in range(mask.shape[0]):
        fd.write_slot_row(si, b, row(b), mask[b:b + 1], scales[b])
    return si


def check_b1_serve(torch, pkg, hp, dev, seed, S=8, Tk=128, steps=16):
    """B1's serving modes against the plain per-row decoder at a preset's
    full width: S = 8 slots, Tk = 128, random keys and values; rows at
    local positions 0, 16, ..., 96 and the last at the position table's
    end less 4 (its launch runs past the table and clamps); rows 0-3 were
    admitted at bucket 64 (lengths <= 64, its context scale), rows 4-7 at
    128. A 16-step launch, then a second one from the carry. Returns (row
    of numbers, ok)."""
    from deepvoice3_pytorch_tpu_torch import builder
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device=dev)
    pd, dc = params["decoder"], cfg.decoder
    g = torch.Generator().manual_seed(seed + 2)
    E = key_width(cfg)
    keys = (torch.randn(S, Tk, E, generator=g) * 0.5).to(dev)
    values = (torch.randn(S, Tk, E, generator=g) * 0.5).to(dev)
    half = S // 2
    lengths = torch.cat([torch.randint(20, 65, (half,), generator=g),
                         torch.randint(65, Tk + 1, (S - half,), generator=g)
                         ]).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None, :].repeat(S, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    spk = batch_speakers(cfg, S)
    se = (None if spk is None else builder.embed_speakers(
        params, cfg, torch.tensor(spk, device=dev)))
    fi = cfg.family.fused_decode_inputs(pd, dc, (keys, values), pos, 1,
                                        speaker_embed=se)
    scales = [n * np.sqrt(1.0 / n) for n in [64] * half + [Tk] * (S - half)]
    si = slot_inputs(torch, fd, fi, lengths, Tk, scales)
    # the float64 run starts from the same random keys and values, as
    # check_b1's does: B1's bar
    pd64 = copy.deepcopy(pd).double()
    fi64 = cfg.family.fused_decode_inputs(
        pd64, dc, (keys.double(), values.double()), pos, 1,
        speaker_embed=None if se is None else se.double())
    si64 = slot_inputs(torch, fd, fi64, lengths, Tk, scales)
    n_table = pd["embed_query_positions"]["w"].shape[0]
    local = torch.tensor([16 * i for i in range(S - 1)] + [n_table - 4],
                         device=dev)
    kern = fd.SlotDecoder(pd, dc, S, dev)
    plain = fd.PlainSlotDecoder(pd, dc, S, dev)
    plain64 = fd.PlainSlotDecoder(pd64, dc, S, dev, dtype=torch.float64)

    def run(dec, inputs):
        carry = dec.zero_carry()
        dec.positions(carry)[:] = local
        outs = []
        for _ in range(2):
            o = dec.new_outputs(steps, Tk)
            dec.launch(inputs, carry, o, steps)
            outs.append(o)
        return [torch.cat(x, dim=1) for x in zip(*outs)], carry

    got, c_k = run(kern, si)
    want, c_p = run(plain, si)
    exact, _ = run(plain64, si64)
    torch.cuda.synchronize()
    names = ("outputs", "alignments", "done", "decoder_states")
    errs = {n: maxabs(a, b) for n, a, b in zip(names, got, want)}
    floor = {n: float((b.double() - e).abs().max())
             for n, b, e in zip(names, want, exact)}
    la_p = c_p["state"]["last_attended"][:, plain.att].to(torch.int32)
    flips = (c_k.last_attended[:, :len(plain.att)] != la_p).nonzero() \
        .tolist()
    want_pos = torch.clamp(local + 2 * steps, max=1 << 30)
    pos_exact = (torch.equal(c_k.pos.long(), want_pos)
                 and torch.equal(c_p["state"]["pos"], want_pos))

    carry = kern.zero_carry()
    outs = kern.new_outputs(steps, Tk)
    ms = cuda_ms(lambda: kern.launch(si, carry, outs, steps), torch,
                 reps=10)
    p_carry = plain.zero_carry()
    p_outs = plain.new_outputs(steps, Tk)
    plain_ms = cuda_ms(lambda: plain.launch(si, p_carry, p_outs, steps),
                       torch, reps=1)
    bound_ = b1_bound_ms(torch, pkg, hp, dev, seed, B=S, Tk=Tk, steps=steps)
    ok = (not flips and pos_exact
          and all(errs[n] <= 3 * floor[n] + 1e-6 for n in errs))
    return {"errs": errs, "floor": floor, "flips": flips[:8],
            "positions_exact": pos_exact, "err": max(errs.values()),
            "ms": ms, "plain_ms": plain_ms, "bound": bound_,
            "placement": {"shared_ring_floats": kern.ring_smem,
                          "device_ring_floats": kern.scratch_floats}}, ok


def drain_queue(q, timeout=600):
    """(audio, decoded steps) of a batcher request's queue; raises the
    engine's error."""
    audio = []
    while True:
        kind, payload = q.get(timeout=timeout)
        if kind == "error":
            raise payload
        if kind == "end":
            return (np.concatenate(audio) if audio
                    else np.zeros(0, np.float32)), payload
        audio.append(payload)


def check_serve_reference(torch, pkg, dev):
    """A tiny model's ContinuousBatcher on the GPU (B1's serving modes, B2)
    against the same schedule on the CPU (plain versions): three requests,
    each admitted one step after the previous. Decoded steps exact; the
    GPU's audio held to spectral convergence within 1.05x of the CPU's,
    against the magnitudes of the CPU stream's linear frames."""
    from deepvoice3_pytorch_tpu_torch import serving
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    cfg, params, ap, _ = tiny_model(pkg)
    # within the tiny model's 63-token cap
    texts = ["Hello streaming world.", "A second, longer sentence here.",
             "And a third one to end."]
    kw = dict(n_slots=3, text_pad=16, chunk=8, max_decoder_steps=40,
              gl_context=8)
    runs = []
    for p in (params, params.to(dev)):
        b = serving.ContinuousBatcher(p, cfg, ap, pkg["en"], **kw)
        fd.KERNEL.reset_counts()
        gl_cuda.KERNEL.reset_counts()
        qs = []
        for text in texts:
            qs.append(b.submit(text))
            b.step()
        while b.step():
            pass
        runs.append([drain_queue(q, 60) for q in qs])
    launches = {"fused_decode_slots": fd.KERNEL.by_entry.get("slots", 0),
                "steps": b._steps_run,
                "griffin_lim": gl_cuda.KERNEL.launches}
    worst = {"steps": 0, "lengths": 0, "sc_ratio": 0.0,
             "launches": launches}
    for text, (a_c, n_c), (a_g, n_g) in zip(texts, *runs):
        worst["steps"] += n_c != n_g
        worst["lengths"] += len(a_c) != len(a_g)
        if n_c != n_g or len(a_c) != len(a_g):
            continue
        lin = list(pkg["streaming"].tts_stream(
            params, cfg, ap, pkg["en"], [text], max_decoder_steps=40,
            first_chunk=8, chunk=8, gl_context=8, pad_to=16,
            emit_linear=True))
        lin = np.concatenate([c["linear"] for c in lin], axis=1)[0]
        lin = lin[:len(a_c) // ap.hop_size]
        worst["sc_ratio"] = max(worst["sc_ratio"], sc_ratio(
            torch, ap, a_g[None], a_c[None], lin[None]))
    ok = (worst["steps"] == 0 and worst["lengths"] == 0
          and worst["sc_ratio"] <= 1.05
          and launches["fused_decode_slots"] == launches["steps"] > 0)
    return worst, ok


def cb_requests(b, texts, speakers, stagger_s):
    """Requests i = 0, 1, ... submitted stagger_s * i seconds after the
    start from threads of their own, as bench.py's continuous-batching row
    does. Returns ([(ttfa s, wall s, samples, decoded steps)], wall s)."""
    import threading

    results = {}

    def one(i):
        time.sleep(stagger_s * i)
        t0 = time.perf_counter()
        q = b.submit(texts[i], speaker_id=speakers[i])
        first, n, audio = None, 0, []
        while True:
            kind, payload = q.get(timeout=600)
            if kind == "error":
                results[i] = payload
                return
            if kind == "end":
                results[i] = (first, time.perf_counter() - t0, n, payload)
                return
            if first is None:
                first = time.perf_counter() - t0
            n += len(payload)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(texts))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    for i in range(len(texts)):
        if isinstance(results.get(i), BaseException):
            raise results[i]
    return [results[i] for i in range(len(texts))], wall


def cb_main_path(torch, pkg, hp, dev, seed, card, label, speakers=None,
                 min_steps=None, n_reqs=(8, 24), profile=False):
    """Continuous batching at a preset's full width, bench.py's schedules
    (`bench_continuous_batching`): ContinuousBatcher(n_slots=8, chunk=16,
    text_pad=64, max_decoder_steps=200) on its worker thread, one warm-up
    request, then n_req requests 50 ms apart for each n_req (sentence i %
    32, speaker speakers[i % 8]). Checks each request's length against
    decoded_samples of its steps, and the mid-stream admissions of the
    first run against a fresh tts_stream of their text. Returns (rows,
    launches of B1's serving mode and of B2 in the timed runs)."""
    import dataclasses
    import threading

    from deepvoice3_pytorch_tpu_torch import serving
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    streaming, en = pkg["streaming"], pkg["en"]
    cfg, params = pkg["model_builder"].build_model(hp, en.n_vocab, seed=seed,
                                                   device=dev)
    if min_steps is not None:
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
            cfg.decoder, min_decoder_steps=min_steps))
    ap = pkg["AudioProcessor"](hp)
    kw = dict(n_slots=8, text_pad=64, chunk=16, max_decoder_steps=200)
    b = serving.ContinuousBatcher(params, cfg, ap, en, **kw)
    stop = threading.Event()
    worker = threading.Thread(target=b.run_loop, args=(stop,), daemon=True)
    worker.start()
    spk = [None] * 8 if speakers is None else list(speakers)
    rows, path_launches = {}, {"fused_decode_slots": 0, "griffin_lim": 0}
    try:
        cb_requests(b, SENTENCES[:1], spk[:1], 0.0)            # warm-up
        for n_req in n_reqs:
            texts = [SENTENCES[i % len(SENTENCES)] for i in range(n_req)]
            sp = [spk[i % 8] for i in range(n_req)]
            for k in (fd.KERNEL, gl_cuda.KERNEL, conv_cuda.KERNEL):
                k.reset_counts()
            before = b.timing()
            res, wall = cb_requests(b, texts, sp, 0.05)
            after = b.timing()
            steps = after["n_steps"] - before["n_steps"]
            launches = {"fused_decode_slots": fd.KERNEL.by_entry.get(
                            "slots", 0),
                        "fused_decode_other": fd.KERNEL.launches
                        - fd.KERNEL.by_entry.get("slots", 0),
                        "griffin_lim": gl_cuda.KERNEL.launches,
                        "conv_taps": conv_cuda.KERNEL.launches}
            for k in path_launches:
                path_launches[k] += launches[k]
            if launches["fused_decode_slots"] != steps or \
                    launches["fused_decode_other"] or \
                    launches["griffin_lim"] <= 0 or launches["conv_taps"]:
                fail("%s: launches %s over %d steps: one serving-mode B1 "
                     "launch a step, B2 launched, nothing else"
                     % (label, launches, steps))
            bad = [i for i, r in enumerate(res)
                   if r[2] != streaming.decoded_samples(cfg, ap, r[3])]
            if bad:
                fail("%s: requests %s: samples != decoded_samples of their "
                     "steps" % (label, bad))
            audio_s = sum(r[2] for r in res) / ap.sample_rate
            row = {"ttfa_ms": [round(r[0] * 1e3, 3) for r in res],
                   "wall_ms": wall * 1e3, "audio_s": audio_s,
                   "aggregate_rtf": audio_s / wall,
                   "decoded_steps": [r[3] for r in res], "steps": steps,
                   "step_phase_ms": {k: round(after[k] - before[k], 1)
                                     for k in after if k != "n_steps"},
                   "launches": launches,
                   "b2_per_step": launches["griffin_lim"] / max(steps, 1)}
            rows["requests_%d" % n_req] = row
            phase(label, "%d requests 50 ms apart on 8 slots: wall %.1f ms "
                  "for %.2f s of audio, aggregate RTF %.1fx, %d steps, ttfa "
                  "ms %s, step phases ms %s, launches %s (B2 %.2f a step) "
                  "(%s)" % (n_req, wall * 1e3, audio_s, audio_s / wall,
                            steps, row["ttfa_ms"],
                            json.dumps(row["step_phase_ms"]),
                            json.dumps(launches), row["b2_per_step"], card))
    finally:
        stop.set()
        worker.join(timeout=60)
    # mid-stream admissions of the first run against fresh streams
    first = rows["requests_%d" % n_reqs[0]]["decoded_steps"]
    same = []
    for i in range(1, min(8, len(first))):
        chunks = list(streaming.tts_stream(
            params, cfg, ap, en, [SENTENCES[i]],
            speaker_ids=None if spk[i] is None else [spk[i]],
            max_decoder_steps=200, first_chunk=16, chunk=16, pad_to=64))
        same.append(int(chunks[-1]["decoded_steps"][0]) == first[i])
    rows["mid_stream_equal_fresh"] = same
    if sum(same) < 2:
        fail("%s: mid-stream admissions equal to a fresh stream: %s"
             % (label, same))
    phase(label, "decoded steps of requests 1-7 equal to a fresh tts_stream "
          "of their text: %s" % same)
    if profile:
        # the same 8 sentences, all at once, driven from this thread:
        # device time by kernel against the host's wall
        pb = serving.ContinuousBatcher(params, cfg, ap, en, **kw)

        def drive():
            qs = [pb.submit(x, speaker_id=s)
                  for x, s in zip(SENTENCES[:8], spk)]
            while pb.step():
                pass
            for q in qs:
                drain_queue(q)

        drive()
        torch.cuda.synchronize()
        t = time.time()
        drive()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
        n0 = pb._steps_run
        rows["profile"] = profile_device(torch, drive, 1, wall_ms)
        rows["profile"]["wall_ms"] = wall_ms
        rows["profile"]["steps"] = pb._steps_run - n0
        phase(label, "8 requests at once, one thread: %.1f ms wall, device "
              "%.2f ms (busy %.3f) over %d steps; top device time [ms, "
              "launches, name]: %s" % (
                  wall_ms, rows["profile"]["device_ms_per_step"],
                  rows["profile"]["busy_share"], rows["profile"]["steps"],
                  json.dumps(rows["profile"]["top"][:10])))
    return rows, path_launches


SLOT_CLIENTS = r"""
import json, sys, threading, time, urllib.parse, urllib.request
base, texts = sys.argv[1], json.loads(sys.argv[2])
out = {}

def fetch(i):
    url = base + "/tts?" + urllib.parse.urlencode({"text": texts[i]})
    t = time.time()
    with urllib.request.urlopen(url, timeout=300) as r:
        head = r.read(46)
        t_first = time.time() - t
        body = head + r.read()
    out[i] = (t_first, time.time() - t, body.hex())

threads = [threading.Thread(target=fetch, args=(i,))
           for i in range(len(texts))]
t0 = time.time()
for th in threads:
    th.start()
for th in threads:
    th.join()
print(json.dumps({"wall": time.time() - t0, "out": out}))
"""


def serve_slots_main_path(torch, pkg, params, cfg, ap, card):
    """TTSEngine(slots=8) + make_handler on a ThreadingHTTPServer at
    127.0.0.1:0: after the warm-up, 8 concurrent /tts requests from a
    client process of their own (its time to the first PCM bytes: clients
    in this process would wait for the interpreter lock behind the
    batcher's worker thread), /stats; then one request to an engine with
    max_backlog=0, which must answer 503 with Retry-After: 1 and count it
    as rejected. Returns (rows, serving launches of B1, problems)."""
    import struct
    import threading
    import urllib.error
    import urllib.request
    from http.server import ThreadingHTTPServer

    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    serve, streaming, en = pkg["serve"], pkg["streaming"], pkg["en"]
    per_step = streaming.decoded_samples(cfg, ap, 1)
    problems, rows = [], {"requests": []}
    class Server(ThreadingHTTPServer):
        # a listen backlog for 8 clients that connect at once (the default
        # 5 drops SYNs, and their retransmits would time TCP, not TTS)
        request_queue_size = 64

    engine = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=200,
                             slots=8)
    engine.warmup()
    server = Server(("127.0.0.1", 0), serve.make_handler(engine))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        for k in (fd.KERNEL, gl_cuda.KERNEL):
            k.reset_counts()
        res = subprocess.run(
            [sys.executable, "-c", SLOT_CLIENTS, base,
             json.dumps(SENTENCES[:8])], capture_output=True, text=True,
            timeout=600)
        launches = {"fused_decode_slots": fd.KERNEL.by_entry.get("slots", 0),
                    "griffin_lim": gl_cuda.KERNEL.launches}
        if res.returncode != 0:
            fail("serve_slots clients: %s" % res.stderr[-2000:])
        got = json.loads(res.stdout.strip().splitlines()[-1])
        rows["wall_ms"] = got["wall"] * 1e3
        for i in range(8):
            if str(i) not in got["out"]:
                problems.append("request %d failed" % i)
                continue
            t_first, wall, body = got["out"][str(i)]
            body = bytes.fromhex(body)
            n = (len(body) - 44) // 2
            rows["requests"].append({"ttfa_ms": t_first * 1e3,
                                     "wall_ms": wall * 1e3, "samples": n})
            if body[:4] != b"RIFF" or \
                    struct.unpack("<I", body[24:28])[0] != ap.sample_rate \
                    or n <= 0 or n % per_step or n > 200 * per_step:
                problems.append("request %d: bad WAV (%d samples)" % (i, n))
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            rows["stats"] = json.loads(r.read())
        st = rows["stats"]
        if st["requests_total"] != 8 or st["requests_failed"] or \
                st["slots"] != 8 or st["active_slots"] or st["backlog"]:
            problems.append("/stats: %s" % st)
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    shed = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=200,
                           slots=1, max_backlog=0)
    server = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(shed))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        try:
            urllib.request.urlopen(base + "/tts?text=shed", timeout=60)
            problems.append("no 503 from an engine with max_backlog=0")
        except urllib.error.HTTPError as e:
            if e.code != 503 or e.headers["Retry-After"] != "1":
                problems.append("max_backlog=0 gave %d, Retry-After %s"
                                % (e.code, e.headers["Retry-After"]))
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            st = json.loads(r.read())
        if st["requests_rejected"] != 1 or st["requests_failed"]:
            problems.append("shed /stats: %s" % st)
    finally:
        server.shutdown()
        server.server_close()
        shed.shutdown()
    return rows, launches, problems


B1_TURNS = r"""
import json, sys, torch
sys.path.insert(0, '.')
import chip_smoke as cs
from deepvoice3_pytorch_tpu_torch import hparams, model_builder
from deepvoice3_pytorch_tpu_torch.frontend import en
from deepvoice3_pytorch_tpu_torch.ops import core, fused_decode as fd
cs.build_kernels((fd.KERNEL,))
pkg = dict(hparams=hparams, model_builder=model_builder, en=en)
with core.strict_numerics():
    r = cs.check_b1(torch, pkg, cs.ljspeech_hparams(hparams, '.'),
                    torch.device('cuda', 0), 1234)
print(json.dumps({'ms': r[3], 'plain_ms': r[4]}))
"""


def b1_turns(parent, card):
    """B1's LJSpeech chunk time (check_b1's kernel call) in `parent` and in
    this checkout, in turns parent, this, this, parent, each a fresh
    process."""
    here = os.path.dirname(os.path.abspath(__file__))
    turns = []
    for name, tree in (("parent", parent), ("this", here), ("this", here),
                       ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", B1_TURNS], cwd=tree,
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            fail("b1 turn in %s: %s" % (tree, res.stderr[-2000:]))
        turns.append([name, json.loads(res.stdout.strip().splitlines()[-1])])
    print(json.dumps({"b1_ljspeech_chunk_turns": turns, "card": card}),
          flush=True)


# Run in a checkout's root with this script's path as its one argument:
# phase B3's per-step sums, timed by this script's functions on the
# checkout's own conv kernels (an earlier commit's included).
B3_TURNS = r"""
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location('smoke', sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, '.')
from deepvoice3_pytorch_tpu_torch.ops import conv_cuda, core
cs.build_kernels((conv_cuda.KERNEL,))
with core.strict_numerics():
    res = cs.check_b3(torch, torch.device('cuda', 0), 1234)
print(json.dumps({'%d_%s' % k: step for k, (_, step) in res.items()}))
"""

B3_TURN_KEYS = ("ms", "library_ms", "vs_cudnn", "ms_host_paced",
                "library_ms_host_paced", "vs_cudnn_host_paced", "routes")


def b3_turns(parent, card, json_out):
    """Phase B3's per-step sums (device and host-paced, kernel and cuDNN)
    of `parent`'s conv kernels and this checkout's, timed by this script in
    turns parent, this, this, parent, each a fresh process."""
    here = os.path.abspath(__file__)
    turns = []
    for name, tree in (("parent", parent), ("this", os.path.dirname(here)),
                       ("this", os.path.dirname(here)), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", B3_TURNS, here],
                             cwd=tree, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            fail("b3 turn in %s: %s" % (tree, res.stderr[-2000:]))
        steps = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append([name, steps])
        for cell, entries in steps.items():
            for entry, tot in entries.items():
                phase("b3_turns", "%s %s %s: %s" % (name, cell, entry,
                      json.dumps({k: tot[k] for k in B3_TURN_KEYS})))
    if json_out:
        os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                    exist_ok=True)
        with open(json_out, "w") as f:
            json.dump({"card": card, "b3_turns": turns}, f, indent=1)


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "GPU.")
    ap.add_argument("--json-out", default=None,
                    help="also write the B3 and training numbers, in full, "
                         "to this JSON file")
    ap.add_argument("--b1-turns", default=None, metavar="PARENT_DIR",
                    help="only time B1's LJSpeech chunk here and in "
                         "PARENT_DIR, in turns")
    ap.add_argument("--b3-turns", default=None, metavar="PARENT_DIR",
                    help="only time phase B3's per-step sums here and in "
                         "PARENT_DIR, in turns")
    ap.add_argument("--b3-only", action="store_true",
                    help="only build the kernels and run phase B3")
    args = ap.parse_args()
    json_out = args.json_out
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        import deepvoice3_pytorch_tpu_torch  # noqa: F401
    except ImportError as e:
        fail("the port package is not next to this script: %s" % e)
    from deepvoice3_pytorch_tpu_torch import hparams, model_builder, serve
    from deepvoice3_pytorch_tpu_torch import streaming, synthesis
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
               synthesis=synthesis, streaming=streaming, serve=serve,
               AudioProcessor=AudioProcessor, en=en)
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
    if args.b1_turns:
        b1_turns(os.path.abspath(args.b1_turns), card)
        return
    if args.b3_turns:
        b3_turns(os.path.abspath(args.b3_turns), card, json_out)
        return

    t0 = time.time()
    logs = build_kernels((fd.KERNEL, gl_cuda.KERNEL, conv_cuda.KERNEL))
    usage = []
    for source, log in logs.items():
        phase("build", "%s: %s" % (source, "; ".join(ptxas_usage(log))))
        usage += ptxas_usage(log)
    phase("build", "kernels built and loaded in %.1f s" % (time.time() - t0))

    hp = ljspeech_hparams(hparams, repo)
    seed = 1234
    ok = True
    with core.strict_numerics():
        b3, b3_extra = b3_phase(torch, dev, seed, card, usage)
        if args.b3_only:
            if json_out:
                os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                            exist_ok=True)
                with open(json_out, "w") as f:
                    json.dump({"card": card, "b3": {"%d_%s" % k: v for k, v
                                                    in b3.items()},
                               "b3_extra": b3_extra}, f, indent=1,
                              default=str)
            return

        ref_ok, ref = check_train_reference(torch, pkg, dev)
        phase("train_reference", "tiny model, 3 steps GPU (B3) vs CPU "
              "(plain): %s (bars: loss 1e-5 at step 1, 1e-4 after; "
              "grad_norm 1e-4; params 5e-5)" % json.dumps(ref))
        if not ref_ok:
            fail("the GPU train step disagreed with the CPU one")

        presets = {"B1": hp,
                   "B1_nyanko": preset_hparams(hparams, repo,
                                               "nyanko_ljspeech"),
                   "B1_vctk": preset_hparams(hparams, repo,
                                             "deepvoice3_vctk")}
        b1_rows = {}
        for label, hp_b1 in presets.items():
            errs, floor, flips, ms_, plain_ms_, placement = check_b1(
                torch, pkg, hp_b1, dev, seed)
            bound_b1 = b1_bound_ms(torch, pkg, hp_b1, dev, seed)
            b1_ok = not flips and all(errs[n] <= 3 * floor[n] + 1e-6
                                      for n in errs)
            b1_rows[label] = dict(err=max(errs.values()), ms=ms_,
                                  plain_ms=plain_ms_, bound=bound_b1)
            phase(label, "fused decode kernel vs plain (%s), B=32 Tk=96 32 "
                  "steps: max abs err %s, plain-vs-float64 floor %s (bar 3x "
                  "floor), last_attended flips %s; kernel %.3f ms, plain "
                  "%.3f ms, bound %.4f ms (%s); ring buffers %s (%s)" % (
                      hp_b1.builder, json.dumps(errs), json.dumps(floor),
                      flips[:8], ms_, plain_ms_, bound_b1[0], bound_b1[1],
                      json.dumps(placement), card))
            ok &= b1_ok
            # nyanko's 256 KiB of ring buffers a row exceed a block's shared
            # memory; LJSpeech's and VCTK's must all stay in it
            if (placement["device_bytes_per_row"] > 0) != \
                    (label == "B1_nyanko"):
                fail("%s: unexpected ring placement %s" % (label, placement))
        b1s, b1s_ok = check_b1_serve(torch, pkg, hp, dev, seed)
        phase("B1_serve", "fused decode serving modes (per-row positions "
              "advanced in the kernel, per-row context scales) vs the plain "
              "per-row decode, LJSpeech, S=8 Tk=128, rows at positions 0, "
              "16, ..., 96 and the table's end - 4, scales of buckets 64 "
              "and 128, 2 x 16 steps: max abs err %s, plain-vs-float64 "
              "floor %s (bar 3x floor), last_attended flips %s, positions "
              "exact %s; kernel %.3f ms per 16-step launch (phase B1's "
              "LJSpeech chunk: %.3f ms per 32 steps at B=32, Tk=96), plain "
              "%.3f ms, bound %.4f ms (%s); rings %s (%s)" % (
                  json.dumps(b1s["errs"]), json.dumps(b1s["floor"]),
                  b1s["flips"], b1s["positions_exact"], b1s["ms"],
                  b1_rows["B1"]["ms"], b1s["plain_ms"], b1s["bound"][0],
                  b1s["bound"][1], json.dumps(b1s["placement"]), card))
        ok &= b1s_ok
        b1_err = max([r["err"] for r in b1_rows.values()] + [b1s["err"]])
        b1_ms, b1_plain_ms = b1_rows["B1"]["ms"], b1_rows["B1"]["plain_ms"]

        b2_err, b2_rel, sc_k, sc_p, b2_ms, b2_plain_ms = check_b2(
            torch, pkg, dev, seed)
        b2_ok = b2_rel < 0.12 and sc_k <= 1.05 * sc_p
        phase("B2", "griffin-lim kernel vs plain, (32, 400, 513) x 16: max "
              "abs err %.3g (%.4f of peak, bar 0.12), spectral convergence "
              "kernel %.4f plain %.4f (bar 1.05x); kernel %.3f ms, plain "
              "%.3f ms" % (b2_err, b2_rel, sc_k, sc_p, b2_ms, b2_plain_ms))
        ok &= b2_ok

        b2s = check_b2_stream(torch, dev, seed)
        b2s_ok = (b2s["rel"] < 0.12 and b2s["sc"] <= 1.05 * b2s["sc_plain"]
                  and all(b2s["pinned_exact"]))
        phase("B2_stream", "griffin-lim stream modes kernel vs plain, "
              "(8, 152, 513) x 32, given start, 16 pinned frames, spectrum "
              "returned: max abs err %.3g (%.4f of peak, bar 0.12), "
              "spectral convergence kernel %.4f plain %.4f (bar 1.05x), "
              "pinned frames equal to the start (kernel, plain) %s; kernel "
              "%.3f ms, plain %.3f ms, bound %.4f ms (%s) (%s)" % (
                  b2s["err"], b2s["rel"], b2s["sc"], b2s["sc_plain"],
                  b2s["pinned_exact"], b2s["ms"], b2s["plain_ms"],
                  b2s["bound"][0], b2s["bound"][1], card))
        ok &= b2s_ok

        p_row, p_launches = check_p(torch, pkg, dev, seed, repo)
        p_ok = (p_row["rel"] < 0.12 and p_row["sc"] <= 1.05 * p_row["sc_plain"]
                and p_row["sc_golden"] <= 1.05 * p_row["sc_golden_plain"]
                and p_launches > 0)
        phase("P", "unfolded-window griffin-lim kernel vs plain, (32, 600, "
              "513) x 16: max abs err %.3g (%.4f of peak, bar 0.12), "
              "spectral convergence kernel %.4f plain %.4f; golden fixture "
              "kernel %.4f plain %.4f (bars 1.05x); kernel %.3f ms (4 "
              "iterations %.3f ms, %.2f us per item-iteration), folded B2 "
              "%.3f ms, plain %.3f ms, bound %.4f ms (%s); %d launches on "
              "its own path (%s)" % (
                  p_row["err"], p_row["rel"], p_row["sc"], p_row["sc_plain"],
                  p_row["sc_golden"], p_row["sc_golden_plain"], p_row["ms"],
                  p_row["ms_4"], p_row["us_per_item_iter"],
                  p_row["folded_ms"], p_row["plain_ms"], p_row["bound"][0],
                  p_row["bound"][1], p_launches, card))
        ok &= p_ok

        # the LJSpeech structure keeps its bar of 0.12 of the peak sample by
        # sample; the other two builders are held to the spectral
        # convergence of their audio, 1.05x the CPU's: a tiny random nyanko
        # makes nearly flat spectra, on which two bf16 Griffin-Lim
        # schedules part by more sample by sample
        for bname in ("deepvoice3", "nyanko", "deepvoice3_multispeaker"):
            suffix = "" if bname == "deepvoice3" else "_" + bname
            audio_bar = ("waveform 0.12 of peak" if bname == "deepvoice3"
                         else "spectral convergence 1.05x the CPU's")

            def audio_ok(w):
                return (w["wave_rel"] < 0.12 if bname == "deepvoice3"
                        else w["sc_ratio"] <= 1.05)

            worst = check_small_reference(torch, pkg, dev, bname)
            ref_ok = (worst["steps"] == 0
                      and max(worst["mel"], worst["linear"],
                              worst["alignment"]) <= 1e-4
                      and audio_ok(worst))
            phase("reference" + suffix, "tiny %s model, GPU kernels vs CPU "
                  "plain: %s (bars: steps exact, features 1e-4, %s)"
                  % (bname, json.dumps(worst), audio_bar))
            ok &= ref_ok
            worst_s = check_small_stream(torch, pkg, dev, bname)
            stream_ref_ok = (worst_s["steps"] == 0 and not worst_s["chunks"]
                             and worst_s["linear"] <= 1e-4
                             and audio_ok(worst_s))
            phase("stream_reference" + suffix, "tiny %s model tts_stream, "
                  "GPU kernels vs CPU plain: %s (bars: decoded steps and "
                  "chunk sizes exact, linear frames 1e-4, %s)"
                  % (bname, json.dumps(worst_s), audio_bar))
            ok &= stream_ref_ok
        worst_sv, sv_ref_ok = check_serve_reference(torch, pkg, dev)
        phase("serve_reference", "tiny deepvoice3 ContinuousBatcher, 3 "
              "requests one step apart, GPU kernels vs CPU plain: %s (bars: "
              "decoded steps and lengths exact, spectral convergence 1.05x "
              "the CPU's, one serving-mode B1 launch a step)"
              % json.dumps(worst_sv))
        ok &= sv_ref_ok
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
                    "griffin_lim": gl_cuda.KERNEL.by_entry.get("batch", 0)}
        phase("tts_batch", "kernel launches on the main path: %s"
              % json.dumps(launches))
        if min(launches.values()) <= 0 or conv_cuda.KERNEL.launches:
            fail("a kernel of the main path was not launched, or B3 was")
        phase("stages", "B=32 wall time by stage: %s" % json.dumps(
            stage_times(torch, synthesis, params, cfg, ap, en, SENTENCES)))

        st_rows, st_launches = stream_main_path(torch, pkg, params, cfg, ap)
        for B in (1, 8):
            r = st_rows["B%d" % B]
            phase("stream", "B=%d: ttfa_ms %.3f (best of 5: %s), stream "
                  "%.3f ms for %.3f s of decoded audio, RTF %.2fx, first "
                  "chunk %.1f ms of audio, %d chunks, decoded steps %s (%s)"
                  % (B, r["ttfa_ms"], r["ttfa_ms_all"], r["stream_total_ms"],
                     r["audio_s"], r["rtf"], r["first_chunk_audio_ms"],
                     r["chunks"], r["decoded_steps"], card))
        phase("stream", "first chunk at B=1 by stage (host ms, synchronised "
              "after each): %s" % json.dumps(st_rows["stages"]))
        prof = st_rows["profile_B1"]
        phase("stream_profile", "one B=1 stream: device %.2f ms of %.2f ms "
              "wall (busy %.3f); copies [ms, count, kind] %s; top device "
              "time [ms, launches, name]: %s" % (
                  prof["device_ms_per_step"],
                  st_rows["B1"]["stream_total_ms"], prof["busy_share"],
                  json.dumps(prof["copies"]), json.dumps(prof["top"][:10])))
        phase("stream", "kernel launches in the stream runs: %s; decoded "
              "steps B=8 stream %s, tts_batch %s" % (
                  json.dumps(st_launches), st_rows["B8"]["decoded_steps"],
                  st_rows["batch_decoded_steps"]))
        if st_launches["fused_decode"] <= 0 or \
                st_launches["griffin_lim_by_mode"].get("pinned", 0) <= 0 \
                or st_launches["conv_taps"]:
            fail("the stream did not launch B1 and B2's pinned mode, or it "
                 "launched B3")
        if st_rows["B8"]["decoded_steps"] != st_rows["batch_decoded_steps"]:
            fail("the stream's decoded steps differ from tts_batch's")

        sv_rows, sv_launches, problems = serve_main_path(torch, pkg, params,
                                                         cfg, ap)
        phase("serve", "3 requests: %s; /stats %s; launches %s (%s)" % (
            json.dumps(sv_rows["requests"]), json.dumps(sv_rows["stats"]),
            json.dumps(sv_launches), card))
        phase("serve", "tts_stream B=1 ttfa_ms in a fresh thread each %s, "
              "in the calling thread %s" % (
                  [round(v, 3) for v in sv_rows["thread_ttfa_ms"]],
                  [round(v, 3) for v in sv_rows["caller_ttfa_ms"]]))
        if problems or sv_launches["fused_decode"] <= 0 or \
                sv_launches["griffin_lim_stream"] <= 0 or \
                sv_launches["conv_taps"]:
            fail("serve: %s, launches %s" % (problems, sv_launches))

        preset_rows, b1_paths = {}, {
            "deepvoice3": launches["fused_decode"]
            + st_launches["fused_decode"]}
        for label, hp_p in (("nyanko", presets["B1_nyanko"]),
                            ("vctk", presets["B1_vctk"])):
            preset_rows[label], b1_paths[hp_p.builder] = preset_main_path(
                torch, pkg, hp_p, dev, seed, card, label)
        phase("B1", "launches on the three builders' main paths (tts_batch "
              "+ streams): %s" % json.dumps(b1_paths))

        # continuous batching: bench.py's schedules on 8 slots
        cb_rows, cb_launches = {}, {}
        cb_rows["cb"], cb_launches["cb"] = cb_main_path(
            torch, pkg, hp, dev, seed, card, "cb", profile=True)
        slot_rows, slot_launches, problems = serve_slots_main_path(
            torch, pkg, params, cfg, ap, card)
        cb_launches["serve_slots"] = slot_launches
        cb_rows["serve_slots"] = slot_rows
        phase("serve_slots", "TTSEngine(slots=8), 8 concurrent requests: "
              "%s, all in %.1f ms; /stats %s; launches %s; max_backlog=0 "
              "engine: 503 with Retry-After 1, counted as rejected (%s)" % (
                  json.dumps(slot_rows["requests"]), slot_rows["wall_ms"],
                  json.dumps(slot_rows["stats"]), json.dumps(slot_launches),
                  card))
        if problems or slot_launches["fused_decode_slots"] <= 0 or \
                slot_launches["griffin_lim"] <= 0:
            fail("serve_slots: %s, launches %s" % (problems, slot_launches))
        cb_rows["cb_nyanko"], cb_launches["cb_nyanko"] = cb_main_path(
            torch, pkg, presets["B1_nyanko"], dev, seed, card, "cb_nyanko",
            n_reqs=(8,))
        cb_rows["cb_vctk"], cb_launches["cb_vctk"] = cb_main_path(
            torch, pkg, presets["B1_vctk"], dev, seed, card, "cb_vctk",
            speakers=list(range(0, 64, 8)), min_steps=200, n_reqs=(8,))
        phase("B1", "B1 serving-mode and B2 launches on the continuous-"
              "batching paths: %s" % json.dumps(cb_launches))
        b1_slots = {k: v["fused_decode_slots"]
                    for k, v in cb_launches.items()}
        if min(b1_slots.values()) <= 0:
            fail("B1's serving mode was not launched on a serving path")

        b3_launches, train_rows = train_main_path(torch, pkg, hp, dev, seed,
                                                  card)
        phase("train", "B3 launches in the kernel-mode steps: %s"
              % json.dumps(b3_launches))
        fast = ("fwd_pipe", "wgrad_pipe", "fwd_wgmma", "wgrad_wgmma")
        if any(b3_launches.get(k, 0) <= 0 for k in fast):
            fail("a route of kernel B3 was not launched on the training "
                 "main path: %s" % json.dumps(b3_launches))
        if any(k.endswith("_simple") for k in b3_launches):
            fail("the train step at bench.py's shapes took B3's ragged "
                 "route: %s" % json.dumps(b3_launches))
        if json_out:
            os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                        exist_ok=True)
            with open(json_out, "w") as f:
                json.dump({"card": card, "train": train_rows,
                           "b3": {"%d_%s" % k: v for k, v in b3.items()},
                           "b3_extra": b3_extra,
                           "b2_stream": b2s, "p": p_row, "stream": st_rows,
                           "serve": sv_rows, "b1": b1_rows,
                           "b1_serve": b1s, "cb": cb_rows,
                           "presets": preset_rows}, f, indent=1,
                          default=str)

    b1_bound = b1_rows["B1"]["bound"]
    b2_bound = b2_bound_ms()

    print(json.dumps({"kernels": [
        {"name": "fused_decode", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/fused_decode.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/fused_decode.py:198",
         "launches": sum(b1_paths.values()) + sum(b1_slots.values()),
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain_ms,
         "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
         "library_ms": None, "timing": "host-paced"},
        {"name": "fused_decode_slots", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/fused_decode.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/fused_decode.py:198",
         "launches": sum(b1_slots.values()), "max_abs_err": b1s["err"],
         "ms": b1s["ms"], "plain_ms": b1s["plain_ms"],
         "bound_ms": b1s["bound"][0], "bound_by": b1s["bound"][1],
         "library_ms": None, "timing": "host-paced"},
        {"name": "griffin_lim", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "deepvoice3_pytorch_tpu/dsp/gl_pallas.py:146",
         "launches": launches["griffin_lim"], "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound[0],
         "bound_by": b2_bound[1], "library_ms": None},
        {"name": "griffin_lim_stream", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "deepvoice3_pytorch_tpu/dsp/gl_pallas.py:146",
         "launches": st_launches["griffin_lim_stream"] + sum(
             v["griffin_lim"] for v in cb_launches.values()),
         "max_abs_err": b2s["err"], "ms": b2s["ms"],
         "plain_ms": b2s["plain_ms"], "bound_ms": b2s["bound"][0],
         "bound_by": b2s["bound"][1], "library_ms": None},
        {"name": "griffin_lim_unfolded", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "tools/gl_pallas2_probe.py:53",
         "launches": p_launches, "max_abs_err": p_row["err"],
         "ms": p_row["ms"], "plain_ms": p_row["plain_ms"],
         "bound_ms": p_row["bound"][0], "bound_by": p_row["bound"][1],
         "library_ms": None, "timing": "host-paced"},
    ] + [
        {"name": "conv_taps_%s_%s" % (entry, route), "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/conv_taps.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/conv_pallas.py:%d" % line,
         "launches": b3_launches.get("%s_%s" % (entry, route), 0),
         "max_abs_err": step[key]["err"], "ms": step[key]["ms"],
         "plain_ms": step[key]["plain_ms"],
         "bound_ms": step[key]["bound_ms"],
         "bound_by": step[key]["bound_by"],
         "library_ms": step[key]["library_ms"], "timing": "device"}
        for route, step in (("pipe", b3[(16, "float32")][1]),
                            ("wgmma", b3[(64, "bfloat16")][1]))
        for entry, key, line in (("fwd", "conv_taps_fwd", 157),
                                 ("wgrad", "conv_taps_wgrad", 212))
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
