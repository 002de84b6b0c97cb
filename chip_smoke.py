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
     |plain - plain in float64| per output, and last_attended exact; the
     same at B = 1 (phase `B1_b1`); per phase the launch alone (host-paced
     and device), the whole call, the plain version, the bound and its
     share of the launch, the layout (blocks, weights a block and the part
     kept in shared memory), where a launch's time goes (the kernel's
     stamps: prologue, a step, an MV and an ATT stage with their grid
     barriers) and the launches by route (fails unless every launch took
     the persistent route);
  6. kernel B2 (Griffin-Lim) against its plain version at (32, 400, 513),
     16 iterations, SPSI start, momentum 0.9 (its batch route): max abs
     error 0.12 of the peak after each item's first hop (no frame is
     pinned there: the overlap-add divides by the window's square near
     zero, and that hop is held by the spectral convergence, see
     wave_err), spectral convergence 1.05x the plain version's, two runs
     bit-equal; per call the host-paced and the device
     ms, the bound and its share, the route and tiles, the launches; the
     GEMMs' device ms an iteration (torch.profiler) beside torch.matmul
     (cuBLAS) on the same bf16 operands;
  7. B2's streaming modes (phases `B2_stream`, `B2_window_152`,
     `B2_window_40`: its window route) against the plain version at
     (8, 152, 513), (1, 152, 513) with a given start, 16 pinned frames and
     the spectrum returned, and (1, 40, 513) with a given start and none
     pinned, 32 iterations each: the B2 bars (the unpinned window's
     samples after its first hop: its first hop is amplified rounding
     noise, see wave_err), the pinned frames of the returned spectrum
     equal to the start exactly; the same figures per
     call, the same steps in one launch each and replayed
     from a CUDA graph (also with the inputs copied in and the results
     cloned out), and where each call's time goes (the kernel's stamps);
     `B2_tiles`: device ms at each window tile; `B2_anchored`: the
     anchored start of a streaming window (computed in the kernel) against
     its plain version on two consecutive windows, and the device kernels
     of one streaming.gl_window call;
  8. the probe kernel P (phase `P`: B2 with the windows applied in f32
     outside the bf16 DFT matrices) against its plain version at the
     probe's shape, (32, 600, 513) x 16, with the B2 figures; then what
     the probe measured: spectral convergence on
     tests/data/dsp_golden_linear.npy (kernel and plain, bar 1.05x),
     microseconds per item-iteration from the 4- and 16-iteration times,
     and the folded B2's time at the same shape;
  9. a small input through tts_batch, and a small stream through
     tts_stream, on the GPU against the same input on the CPU (plain
     versions), as the reference; tts_batch's deepvoice3 waveform is held
     to 0.12 of the peak, every stream's audio to its spectral
     convergence, 1.05x the CPU's (the deepvoice3 stream's samples, and
     Griffin-Lim's plain version run on the GPU against the CPU, are
     printed beside it, not held);
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
     full widths (B = 32, Tk = 96, 32 steps, the B1 bar and figures), a
     tiny model of each builder through tts_batch and tts_stream
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
     16-step launches (the B1 bar, last_attended and positions exact; the
     figures of phase 5 for a launch); a tiny model's ContinuousBatcher GPU
     vs CPU (decoded steps exact, spectral convergence 1.05x); then bench.py's
     continuous-batching schedules at full width, ContinuousBatcher(8
     slots, chunk 16, text_pad 64, 200 steps) on its worker thread after a
     warm-up request: LJSpeech 8 and then 24 requests 50 ms apart
     (per-request ttfa, aggregate RTF, step phases, one B1 launch a step,
     B2 launches a step, a torch.profiler breakdown of 8 requests at once),
     nyanko 8, VCTK 8 with speakers 0, 8, ..., 56 and min_decoder_steps =
     200; each request's length must equal decoded_samples of its steps and
     at least two mid-stream admissions must decode the steps of a fresh
     tts_stream; TTSEngine(slots=8) over HTTP with two rounds of 8
     concurrent requests from a client process (the first is each client
     thread's first request), the host ms from each client's send to each
     hop of its request (serve.HOPS) and to its first bytes, /stats, and a
     503 from an engine with max_backlog=0;
 15. the training main path: the LJSpeech preset at full width, seeded
     random weights, make_train_step at bench.py's shapes (B = 16 f32 with
     TF32 off, B = 64 bf16) in conv_mode "kernel" and, as the yardstick,
     "library" (cuDNN), taken in turns; ms/step, steps/s and MFU against the
     H100's peak for the step's type (FLOPs counted by FlopCounterMode on
     the library step; the hand kernel is invisible to it); device time by
     kernel (torch.profiler) over three steps of each mode; then twenty
     steps on a synthetic-corpus batch, whose loss must be finite and fall.
     Fails unless B3's four fast entries (fwd/wgrad, pipe/wgmma) were
     launched in the kernel-mode steps, and if its ragged route was;
 16. the command lines (phases `cli_*`), each run as a user would run it,
     `python -m deepvoice3_pytorch_tpu_torch.cli.<name>` in a subprocess
     from the checkout's root, on the card, over a corpus written to a
     temporary directory (`cli_corpus`: utils/synthcorpus's 48 sentences,
     features from batch_features on the card, the .npy pairs, train.txt
     and the DSP stamp; key_position_rate from the corpus as bench.py sets
     it): `cli_train` trains the LJSpeech preset at full width (B = 16
     f32, kernel conv mode) 40 steps with async checkpoints at 20 and 40
     and an eval at 40 (every loss finite, the last below the first, 6
     eval wavs by B1 + B2, B3 off its ragged route; steady steps/s, the
     sync save's ms, the async save's stall, file sizes); `cli_resume`
     resumes the step-20 file for one step (its loss within 1e-5 relative
     of the uninterrupted run's step 21; the file's parameters and both
     Adam moments loaded onto the card bit for bit; load ms);
     `cli_synthesis` synthesizes the 32 sentences from the step-40 file at
     B = 32 after a warm-up (32 wavs, decoded steps equal to an in-process
     tts_batch on the same loaded parameters; wall ms, RTF), then 2 of them
     with --device cpu (decoded steps exact, the card's audio within 1.05x
     the CPU's spectral convergence, each written wav taken at its best
     gain) and 1 with --stream (first-chunk latency); `cli_serve` starts
     cli.serve --slots 8 on a free port of 127.0.0.1, sends 3 requests
     (HTTP 200, a WAV header, PCM; the client's ms to the first bytes) and
     stops it with SIGINT; `cli_builders` trains the nyanko and VCTK
     presets 5 steps each (VCTK on a 5-column train.txt, sentence i by
     speaker (7 i) % 108) and synthesizes 8 sentences from each file
     (VCTK as speaker 7). Each command line's launch counts (its
     --summary-json, or serve's last line) are summed into the `cli` line,
     which fails unless B1 (both modes), B2 (both modes) and B3 launched,
     and into the kernels line.
The line before the last is the kernels' JSON record (B1's launches
summed over the three builders' main paths and the serving paths, its
worst error over the four B1 phases; its times are the LJSpeech phase's;
`fused_decode_slots` is the serving mode alone: its launches on the
serving paths, B1_serve's error and times; `griffin_lim_stream` counts
its launches on the stream and serving paths; every launch count adds
the command lines'); the last line is
{"ok": true, "device": {...}}. Each record's "timing" names how its "ms"
and "plain_ms" were taken: "host-paced" (cuda_ms: events around calls as
the host issues them) or "device" (device_ms: the calls queued behind a
device sleep, met back to back). `--json-out PATH` also writes the B3 and
training numbers, in full, to PATH.

    python3 chip_smoke.py --b1-turns PARENT_DIR

times B1's launch alone at B1_SHAPES (the LJSpeech, nyanko and VCTK
chunks of 32 steps at B = 32, Tk = 96, the serving launch of 16 steps at
S = 8, Tk = 128, the LJSpeech chunk at B = 1) on another checkout's
kernel (a copy of an earlier commit) and on this one's, with this script's
timers, in turns parent, this, this, parent, each in a fresh process, and
prints one JSON line; nothing else runs.

    python3 chip_smoke.py --b3-turns PARENT_DIR

times phase 3's per-step sums of B3 (device and host-paced, kernel and
cuDNN) on another checkout's conv kernels and on this one's, in the same
turns, with this script's timers; nothing else runs.

    python3 chip_smoke.py --b3-only

builds the kernels and runs phase 3 alone.

    python3 chip_smoke.py --b2-turns PARENT_DIR

times B2 at its five calls (B2_CALLS: the batch and P shapes, the three
windows; host-paced and device) on another checkout's kernel and on this
one's, in the same turns, with this script's timers; nothing else runs.

    python3 chip_smoke.py --b2-only

builds the kernels and runs B2's phases (6 to 8) alone.

    python3 chip_smoke.py --cli-only

builds the kernels and runs the command lines' phases (16) alone.
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


def plain_cpu_first_hop(torch, S, win, kw, want):
    """The first hop of Griffin-Lim's plain version run on the CPU on the
    same inputs, against the plain version on the card, as a share of the
    card's peak: how far the plain version parts from itself there."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda

    cpu = {k: (None if v is None else tuple(a.cpu() for a in v))
           if isinstance(v, tuple) else v for k, v in kw.items()}
    cpu["mats"] = tuple(m.cpu() for m in kw["mats"])
    res = gl_cuda.griffin_lim_plain(S.cpu(), FFT, HOP, win, **cpu)
    res = res[0] if isinstance(res, tuple) else res
    return maxabs(res[:, :HOP], want[:, :HOP].cpu()) / float(
        want.abs().max())


def wave_err(got, want, unpinned_edge):
    """(max abs error, its share of the peak, the first hop's error as a
    share of the whole peak) of a Griffin-Lim waveform. unpinned_edge: a
    call without pinned frames, whose first hop is the overlap-add of one
    frame chunk divided by the window's square (up to ~2e5 at sample 1):
    its samples are amplified rounding noise, on which the plain version
    parts from itself by 0.03-0.34 of the peak between the card, the CPU
    and f64 sums (PERF.md). There the error and the peak are taken over the
    later samples, and the first hop is held only by the spectral
    convergence of the whole waveform."""
    lo = HOP if unpinned_edge else 0
    err = maxabs(got[:, lo:], want[:, lo:])
    first = maxabs(got[:, :HOP], want[:, :HOP]) / float(want.abs().max())
    return err, err / float(want[:, lo:].abs().max()), first


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


def b1_inputs(torch, pkg, hp, dev, seed, B=32, Tk=96, steps=32):
    """A preset's decoder at full width, seeded random weights, and random
    keys and values of B rows of Tk keys (lengths 40..Tk); a multi-speaker
    preset decodes speakers (7 i) % n_speakers. Returns a dict: cfg, pd
    (decoder params), fi (fused-decode inputs), mask, init, and keys,
    values, pos, se for a float64 copy."""
    from deepvoice3_pytorch_tpu_torch import builder
    from deepvoice3_pytorch_tpu_torch.ops import core

    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    E = key_width(cfg)
    keys = (torch.randn(B, Tk, E, generator=g) * 0.5).to(dev)
    values = (torch.randn(B, Tk, E, generator=g) * 0.5).to(dev)
    lengths = torch.randint(min(40, Tk), Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None, :].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    pd = params["decoder"]
    spk = batch_speakers(cfg, B)
    se = (None if spk is None else builder.embed_speakers(
        params, cfg, torch.tensor(spk, device=dev)))
    fi = cfg.family.fused_decode_inputs(pd, cfg.decoder, (keys, values), pos,
                                        steps, speaker_embed=se)
    return dict(cfg=cfg, pd=pd, fi=fi,
                mask=core.get_mask_from_lengths(lengths, Tk),
                init=torch.zeros(B, cfg.decoder.in_dim * cfg.decoder.r,
                                 device=dev),
                keys=keys, values=values, pos=pos, se=se)


# B1's launch-alone shapes: (preset, B or slots, Tk, steps, serving mode)
B1_SHAPES = {
    "ljspeech": ("deepvoice3_ljspeech", 32, 96, 32, False),
    "nyanko": ("nyanko_ljspeech", 32, 96, 32, False),
    "vctk": ("deepvoice3_vctk", 32, 96, 32, False),
    "serving": ("deepvoice3_ljspeech", 8, 128, 16, True),
    "ljspeech_b1": ("deepvoice3_ljspeech", 1, 96, 32, False),
}


def b1_launch(torch, fd, x, steps):
    """A FusedDecoder of b1_inputs `x` and a function that launches its
    chunk of `steps` frames from a fresh carry (the launch alone: no plan,
    no inputs)."""
    dec = fd.FusedDecoder(x["pd"], x["cfg"].decoder, x["fi"], x["mask"],
                          steps)
    carry, outs = dec.zero_carry(x["init"]), dec.new_outputs(steps)
    return dec, lambda **kw: dec.launch(carry, outs, 0, steps, **kw)


def b1_slot_launch(torch, fd, pkg, hp, dev, seed, S, Tk, steps):
    """A SlotDecoder at a preset's width over S slots of Tk keys (rows at
    positions 0, 16, ...; half of them at bucket 64's context scale), a
    function that launches `steps` frames, and one that admits row 0 again
    (`write_slot_row`: with this checkout's decoder it also folds the row's
    K/V; an earlier checkout's decoder keeps no att_w and folds nothing)."""
    x = b1_inputs(torch, pkg, hp, dev, seed + 1, B=S, Tk=Tk, steps=1)
    lengths = (x["mask"] == 0).sum(1)
    scales = [n * np.sqrt(1.0 / n) for n in
              [64] * (S // 2) + [Tk] * (S - S // 2)]
    dec = fd.SlotDecoder(x["pd"], x["cfg"].decoder, S, dev)
    si = slot_inputs(torch, fd, x["fi"], lengths, Tk, scales,
                     getattr(dec, "att_w", None))
    carry, outs = dec.zero_carry(), dec.new_outputs(steps, Tk)
    carry.pos[:] = torch.arange(S, device=dev) * 16
    row, mask = slot_rows(torch, x["fi"], lengths, Tk)
    n0 = int(lengths[0])
    return (dec, lambda **kw: dec.launch(si, carry, outs, steps, **kw),
            lambda: fd.write_slot_row(si, 0, row(0, n0), mask[0:1, :n0],
                                      scales[0]))


def b1_launch_times(torch, pkg, fd, repo, dev, seed, shapes=B1_SHAPES):
    """B1 at each of `shapes` with the module `fd` given (this checkout's,
    or another's in --b1-turns): the launch alone, host-paced (cuda_ms, ten
    launches) and device (device_ms); for a chunk, the whole fused_decode
    call (packed plan, K/V, mask, the fold where there is one, carry,
    buffers, the launch; host-paced) and the K/V fold's device ms where the
    decoder folds (None elsewhere); for the serving launch, an admission
    (write_slot_row of one row, host-paced), which folds the row's K/V
    where the decoder reads folded ones."""
    out = {}
    for name, (preset, B, Tk, steps, serving) in shapes.items():
        hp = preset_hparams(pkg["hparams"], repo, preset)
        if serving:
            _, launch, admit = b1_slot_launch(torch, fd, pkg, hp, dev, seed,
                                              B, Tk, steps)
            extra = {"admit_ms": cuda_ms(admit, torch, reps=10)}
        else:
            x = b1_inputs(torch, pkg, hp, dev, seed, B=B, Tk=Tk, steps=steps)
            dec, launch = b1_launch(torch, fd, x, steps)
            dc = x["cfg"].decoder
            extra = {"call_ms": cuda_ms(lambda: fd.fused_decode(
                x["pd"], dc, x["fi"], x["mask"], x["init"], steps,
                dc.min_decoder_steps, early_exit=False), torch, reps=10),
                "fold_device_ms": device_ms(lambda: fd.attention_operands(
                    dec.layout.att_w, dec.kv), torch)
                if hasattr(dec, "kvf") else None}
        out[name] = {"launch_ms": cuda_ms(launch, torch, reps=10),
                     "launch_device_ms": device_ms(launch, torch), **extra}
    return out


def stream_ttfa(torch, pkg, hp, dev, seed, n=9):
    """A B = 1 LJSpeech stream's time to first audio (host clock, from the
    tts_stream call to its first chunk) after two warm-up streams: the
    least, the median and all n."""
    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device=dev)
    ap = pkg["AudioProcessor"](hp)
    args = (torch, pkg["streaming"], params, cfg, ap, pkg["en"],
            SENTENCES[:1])
    for _ in range(2):
        run_stream(*args)
    ttfa = [run_stream(*args)[1] * 1e3 for _ in range(n)]
    return {"ttfa_ms_min": min(ttfa), "ttfa_ms_median": float(
        np.median(ttfa)), "ttfa_ms_all": [round(v, 3) for v in ttfa]}


def b1_stage_us(torch, dec, launch, steps):
    """Where a launch's time goes, from the kernel's own stamps (block 0):
    the prologue (tables and weights into shared memory, carry in), the
    mean us of a step, of an MV and of an ATT stage with its grid barrier,
    of block 0's work in them (and of its first part: the products of an
    MV stage, the scores of an ATT stage) and of its wait at the barrier
    after it, and the stages a step."""
    n = len(dec.layout.stages)
    trace = torch.zeros(2 + 3 * steps * n, dtype=torch.int64,
                        device=dec.device)
    launch(trace=trace)
    torch.cuda.synchronize()
    t = trace.cpu().numpy().astype(np.float64) / 1e3
    after = np.concatenate([t[1:2], t[4::3]])        # barrier exits
    first = (t[2::3] - after[:-1]).reshape(steps, n)
    work = (t[3::3] - after[:-1]).reshape(steps, n)
    total = np.diff(after).reshape(steps, n)
    kinds = np.array([st.words[0] for st in dec.layout.stages] * steps) \
        .reshape(steps, n)
    row = {"prologue_us": round(float(t[1] - t[0]), 2),
           "step_us": round(float(total.sum(1).mean()), 2),
           "stages_a_step": n}
    for k, name in ((0, "mv"), (1, "att")):
        if (kinds == k).any():
            row[name + "_stage_us"] = round(float(total[kinds == k].mean()),
                                            3)
            row[name + "_work_us"] = round(float(work[kinds == k].mean()), 3)
            row[name + "_first_part_us"] = round(float(
                first[kinds == k].mean()), 3)
    row["barrier_wait_us"] = round(float((total - work).mean()), 3)
    return row


def b1_layout_row(dec):
    lay = dec.layout
    return {"grid": lay.grid, "resident_kb_a_block": lay.resident / 256,
            "weights_kb_a_block": lay.per_block / 256,
            "smem_bytes": dec.smem_bytes,
            "ring_bytes_per_row_in_device_memory": 4 * dec.ring_floats}


def b1_row_inputs(x, b, steps):
    """Row b of b1_inputs `x` as inputs of its own, B = 1."""
    one = slice(b, b + 1)
    keys, values, pos = x["keys"][one], x["values"][one], x["pos"][one]
    se = None if x["se"] is None else x["se"][one]
    fi = x["cfg"].family.fused_decode_inputs(
        x["pd"], x["cfg"].decoder, (keys, values), pos, steps,
        speaker_embed=se)
    return dict(x, fi=fi, mask=x["mask"][one], init=x["init"][one],
                keys=keys, values=values, pos=pos, se=se)


B1_DRIFT_STEPS = (1, 2, 4, 8, 16, 32)


def b1_errors(torch, fd, x, steps):
    """The kernel's, the plain f32 version's and a float64 plain decode of
    b1_inputs `x`, one chunk of `steps`: the kernel's errors against plain,
    the plain version's floor (its own drift from float64), the kernel's
    drift from float64, each one's decoder-state drift from float64 after
    steps B1_DRIFT_STEPS, last_attended flips, the kernel's launches by
    route, and the kernel's and the plain version's whole calls."""
    cfg, pd, fi, mask, init = (x[k] for k in ("cfg", "pd", "fi", "mask",
                                              "init"))
    fam = cfg.family
    min_steps = cfg.decoder.min_decoder_steps

    def kernel():
        return fd.fused_decode(pd, cfg.decoder, fi, mask, init, steps,
                               min_steps, early_exit=False)

    def plain():
        return fd.fused_decode_plain(pd, cfg.decoder, fi, mask, init, steps,
                                     min_steps, early_exit=False)

    fd.KERNEL.reset_counts()
    got, want = kernel(), plain()
    routes = dict(fd.KERNEL.by_route)
    pd64 = copy.deepcopy(pd).double()
    fi64 = fam.fused_decode_inputs(
        pd64, cfg.decoder, (x["keys"].double(), x["values"].double()),
        x["pos"], steps,
        speaker_embed=None if x["se"] is None else x["se"].double())
    exact = fd.fused_decode_plain(pd64, cfg.decoder, fi64, mask,
                                  init.double(), steps, min_steps,
                                  early_exit=False)
    torch.cuda.synchronize()
    names = ("outputs", "alignments", "done", "decoder_states")
    at = [t for t in B1_DRIFT_STEPS if t <= steps]

    def by_step(a):
        d = (a.decoder_states.double()
             - exact.decoder_states).abs().amax(dim=(0, 2))
        return [float(d[t - 1]) for t in at]

    return {"drift_by_step": {"kernel": by_step(got),
                              "plain": by_step(want)},
            "errs": {n: maxabs(getattr(got, n), getattr(want, n))
                     for n in names},
            "floor": {n: float((getattr(want, n).double()
                                - getattr(exact, n)).abs().max())
                      for n in names},
            "vs_float64": {n: float((getattr(got, n).double()
                                     - getattr(exact, n)).abs().max())
                           for n in names},
            "flips": (got.last_attended
                      != want.last_attended).nonzero().tolist(),
            "routes": routes}, kernel, plain


def b1_keys_scored(fd, dec, mask, las):
    """Keys B1's attention needs, summed over rows, attention layers and
    steps, from last_attended before each step (las: (steps, B, n_att)):
    a monotonic layer's window [la - back, la + ahead) clipped to the text
    where it holds an unpadded key (the plain softmax gives every key
    outside it an exact zero), else every key. mask (B, Tk): True where
    padded."""
    valid = ~mask.cpu().numpy().astype(bool)
    B, Tk = valid.shape
    csum = np.concatenate([np.zeros((B, 1), np.int64),
                           np.cumsum(valid, 1)], 1)
    rows = np.arange(B)
    n = 0
    for st in dec.layout.stages:
        w = st.words
        if w[fd.S_KIND] != fd.K_ATT:
            continue
        la = las[:, :, w[fd.S_AIDX]]
        if not w[fd.S_MONO]:
            n += la.size * Tk
            continue
        lo = np.clip(la - w[fd.S_BACK], 0, Tk)
        hi = np.clip(la + w[fd.S_AHEAD], 0, Tk)
        held = csum[rows, hi] - csum[rows, lo] > 0
        n += int(np.where(held, hi - lo, Tk).sum())
    return n


def b1_step_las(torch, dec, la, launch_one, steps):
    """(steps, B, n_att) last_attended before each step: la() reads the
    carry's, launch_one(t) launches frame t alone."""
    out = []
    for t in range(steps):
        out.append(la().cpu().numpy().astype(np.int64))
        launch_one(t)
    torch.cuda.synchronize()
    return np.stack(out)


def b1_timings(torch, pkg, hp, dev, seed, fd, x, steps, kernel, plain):
    """Times of a decode of b1_inputs `x`: the whole fused_decode call
    (packed plan cached, inputs built), the plain version's, the launch
    alone (host-paced and device), the K/V fold's device ms (outside the
    launch, once a decode), the layout, where a launch's time goes
    (b1_stage_us), and the bound with the keys this decode's windows
    need."""
    dec, launch = b1_launch(torch, fd, x, steps)
    carry, outs = dec.zero_carry(x["init"]), dec.new_outputs(steps)
    las = b1_step_las(torch, dec, lambda: dec.last_attended(carry),
                      lambda t: dec.launch(carry, outs, t, 1), steps)
    B, Tk = x["mask"].shape
    row = {"ms": cuda_ms(kernel, torch),
           "plain_ms": cuda_ms(plain, torch),
           "launch_ms": cuda_ms(launch, torch, reps=10),
           "launch_device_ms": device_ms(launch, torch),
           "fold_device_ms": device_ms(lambda: fd.attention_operands(
               dec.layout.att_w, dec.kv), torch),
           "layout": b1_layout_row(dec),
           "stage_us": b1_stage_us(torch, dec, launch, steps),
           "keys_scored": b1_keys_scored(fd, dec, x["mask"], las),
           "keys_all": B * steps * dec.plan.n_att * Tk}
    row["bound"] = b1_bound_ms(torch, pkg, hp, dev, seed, B=B, Tk=Tk,
                               steps=steps, keys=row["keys_scored"])
    row["bound_share"] = row["bound"][0] / row["launch_ms"]
    return row


def check_b1(torch, pkg, hp, dev, seed, B=32, Tk=96, steps=32):
    """B1 kernel vs plain at a preset's widths: B rows (32 by default), Tk =
    96, one 32-step chunk, random keys and values; a multi-speaker preset
    decodes speakers (7 i) % n_speakers. Returns a row: b1_errors (bar:
    each error within 3x the floor, no flip) and b1_timings."""
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    x = b1_inputs(torch, pkg, hp, dev, seed, B=B, Tk=Tk, steps=steps)
    row, kernel, plain = b1_errors(torch, fd, x, steps)
    row["flips"] = row["flips"][:8]
    row["err"] = max(row["errs"].values())
    row["ok"] = not row["flips"] and all(
        row["errs"][n] <= 3 * row["floor"][n] + 1e-6 for n in row["errs"])
    row.update(b1_timings(torch, pkg, hp, dev, seed, fd, x, steps, kernel,
                          plain))
    return row


B1_ROWS = tuple(range(32))            # rows of B1's inputs decoded alone


def check_b1_rows(torch, pkg, hp, dev, seed, Tk=96, steps=32, rows=B1_ROWS):
    """B1 at B = 1: rows `rows` of check_b1's B = 32 inputs, each decoded
    alone, kernel vs plain vs float64. Bar: every row's errors within 3x the
    largest plain-vs-float64 floor among them (one row's floor is one
    sample of the f32 drift; the largest of the 32 rows is check_b1's
    floor at B = 32), no flip in any row. The times are row rows[0]'s.
    Returns check_b1's row, with each decoded row's errors, floor and
    drift from float64."""
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    x32 = b1_inputs(torch, pkg, hp, dev, seed, B=32, Tk=Tk, steps=steps)
    per_row, routes = [], {}
    for b in rows:
        x = b1_row_inputs(x32, b, steps)
        r, kernel, plain = b1_errors(torch, fd, x, steps)
        for k, v in r.pop("routes").items():
            routes[k] = routes.get(k, 0) + v
        per_row.append(dict(r, row=b))
        if b == rows[0]:
            first = (x, kernel, plain)
    names = per_row[0]["errs"]
    floor = {n: max(r["floor"][n] for r in per_row) for n in names}
    errs = {n: max(r["errs"][n] for r in per_row) for n in names}
    row = {"errs": errs, "floor": floor,
           "vs_float64": {n: max(r["vs_float64"][n] for r in per_row)
                          for n in names},
           "drift_by_step": {k: [max(v) for v in zip(
               *(r["drift_by_step"][k] for r in per_row))]
               for k in ("kernel", "plain")},
           "flips": [[r["row"]] + f for r in per_row for f in r["flips"]][:8],
           "rows": [{"row": r["row"], "errs": r["errs"], "floor": r["floor"],
                     "vs_float64": r["vs_float64"]} for r in per_row],
           "routes": routes, "err": max(errs.values())}
    row["ok"] = not row["flips"] and all(
        r["errs"][n] <= 3 * floor[n] + 1e-6 for r in per_row for n in names)
    row.update(b1_timings(torch, pkg, hp, dev, seed, fd, first[0], steps,
                          first[1], first[2]))
    return row


def b1_line(label, builder_name, B, row, card):
    return ("fused decode kernel vs plain (%s), B=%d Tk=96 32 steps: max "
            "abs err %s, plain-vs-float64 floor %s (%s), kernel-vs-float64 "
            "%s, decoder-state drift from float64 after steps %s: kernel "
            "%s, plain %s; last_attended flips %s; launch alone %.4f ms "
            "host-paced, "
            "%.4f ms device; K/V fold (once a decode, outside the launch) "
            "%.4f ms device; whole fused_decode call %.3f ms; plain %.3f "
            "ms; bound %.4f ms (%s; %d keys scored of %d), %.4f of the "
            "launch; layout %s; a launch's time (block 0's stamps) %s; "
            "launches by route %s (%s)"
            % (builder_name, B, json.dumps(row["errs"]),
               json.dumps(row["floor"]),
               "bar 3x floor" if B > 1 else
               "rows %d..%d decoded one at a time, each within 3x the "
               "largest floor among them" % (B1_ROWS[0], B1_ROWS[-1]),
               json.dumps(row["vs_float64"]), list(B1_DRIFT_STEPS),
               ["%.2e" % v for v in row["drift_by_step"]["kernel"]],
               ["%.2e" % v for v in row["drift_by_step"]["plain"]],
               row["flips"], row["launch_ms"],
               row["launch_device_ms"], row["fold_device_ms"], row["ms"],
               row["plain_ms"], row["bound"][0], row["bound"][1],
               row["keys_scored"], row["keys_all"], row["bound_share"],
               json.dumps(row["layout"]), json.dumps(row["stage_us"]),
               json.dumps(row["routes"]), card))


def b1_bound_ms(torch, pkg, hp, dev, seed, B=32, Tk=96, steps=32,
                keys=None):
    """Least time for check_b1's decode: per row and step, one MAC per
    decoder weight (the attention's query and out projections included;
    the key/value and speaker projections run before the decode) and, per
    key scored, 2 E MACs (score and context) in f32 outside the tensor
    cores; `keys`: the keys the run's windows need (b1_keys_scored; None:
    every key of every layer); bytes: the weights, K/V, mask, speaker
    biases and position rows read once, the four outputs written once."""
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    cfg, params = pkg["model_builder"].build_model(hp, pkg["en"].n_vocab,
                                                   seed=seed, device="cpu")
    sd = {k: v for k, v in params["decoder"].state_dict().items()
          if "positions" not in k and "key_proj" not in k
          and "value_proj" not in k and "speaker_proj" not in k}
    dc = cfg.decoder
    E, C = key_width(cfg), fd.state_dim(dc)
    n_att = dc.num_attention_layers
    if keys is None:
        keys = B * steps * n_att * Tk
    n_sp = sum(fd.build_plan(params["decoder"], dc).sp_widths)
    macs = sum(v.numel() for k, v in sd.items() if k.endswith(".v")) \
        * B * steps + 2 * E * keys
    nbytes = 4 * (sum(v.numel() for v in sd.values())
                  + n_att * 2 * B * Tk * E + B * Tk + B * n_sp + steps * C
                  + B * steps * (dc.in_dim * dc.r + Tk + 1 + C))
    return bound(2.0 * macs, nbytes, "float32")


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


# the five calls of B2's aims: (B, n, iterations, start, pinned frames,
# spectrum returned, windows folded, seed offset)
B2_CALLS = {
    "batch": (32, 400, 16, "spsi", 0, False, True, 2),
    "P": (32, 600, 16, "spsi", 0, False, False, 4),
    "stream": (8, 152, 32, "given", 16, True, True, 3),
    "window_152": (1, 152, 32, "given", 16, True, True, 5),
    "window_40": (1, 40, 32, "given", 0, False, True, 6),
}


def b2_inputs(torch, dev, seed, name):
    """Magnitudes, window and griffin_lim keywords of one of B2_CALLS. The
    keywords are those every version of the port takes (so that
    --b2-turns can give them to an earlier checkout); a given start is the
    magnitudes on their SPSI phase."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    B, n, iters, start, n_pinned, spec, fold, off = B2_CALLS[name]
    win = dsp.lws_hann_window(FFT, HOP)
    S = tone_mags(torch, dev, seed + off, B, n)
    kw = dict(n_iters=iters, momentum=0.9, fold_windows=fold,
              mats=gl_cuda.gl_mats(FFT, win, dev, fold=fold))
    if start == "given":
        phi = dsp.spsi_phase(S, FFT, HOP)
        kw.update(init_spec=(S * torch.cos(phi), S * torch.sin(phi)),
                  n_pinned=n_pinned, return_spec=spec)
    else:
        kw.update(phase_init=start)
    return S, win, kw


def b2_bound(name):
    """b2_bound_ms of one of B2_CALLS: a given start and a returned
    spectrum are two (B, n, F) planes each."""
    B, n, iters, start, _, spec, _, _ = B2_CALLS[name]
    planes = 2 * (start == "given") + 2 * spec
    return b2_bound_ms(B, n, FFT, HOP, iters, planes=planes)


def b2_timed(torch, fn):
    """Both timers of one call: host-paced (events around calls as the
    host issues them) and device (queued behind a device sleep)."""
    return {"cuda_ms": cuda_ms(fn, torch), "device_ms": device_ms(fn, torch)}


def capture_graph(torch, fn):
    """fn captured into a CUDA graph after a warm-up call on a side
    stream: (graph, the captured call's result)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        res = fn()
    return graph, res


def graph_timed(torch, fn, inputs=()):
    """Both timers of fn replayed from a CUDA graph of one call. inputs:
    tensors the graph reads; with them the timed call is the graph as a
    caller would use it: fresh inputs copied into the captured ones, the
    replay, and the results cloned out of the graph's memory."""
    graph, res = capture_graph(torch, fn)
    if not inputs:
        return b2_timed(torch, graph.replay)
    fresh = [x.clone() for x in inputs]
    flat = res if isinstance(res, torch.Tensor) else [res[0], *res[1]]

    def call():
        for x, y in zip(inputs, fresh):
            x.copy_(y)
        graph.replay()
        return [r.clone() for r in flat]

    return b2_timed(torch, call)


def b2_gemm_ms(torch, fn, n_iters):
    """Device ms per iteration of the batch route's two GEMMs (synthesis
    `gemm_batch<..., 0>`, n_iters + 1 launches; analysis
    `gemm_batch<..., 1>`, n_iters) from a torch.profiler trace of one
    call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    syn = ana = 0.0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if "gemm_batch<" in e.key:   # <columns, 0> synthesis, 1 analysis
            if ", 0>" in e.key:
                syn += us / 1e3
            else:
                ana += us / 1e3
    return syn / (n_iters + 1) + ana / n_iters, syn, ana


def b2_gemm_library_ms(torch, gl_cuda, mats, B, n):
    """cuBLAS yardstick for one iteration's two GEMMs at (B, n): device ms
    of torch.matmul on the kernel's own bf16 operands (the carry's 2F
    columns against synT, a16 against anaT; bf16 out)."""
    synT, anaT = gl_cuda.gl_operands(mats)
    F2 = anaT.shape[0]
    g = torch.Generator(device=synT.device).manual_seed(0)
    c = torch.randn(B * n, synT.shape[1], generator=g, device=synT.device,
                    dtype=torch.bfloat16)
    a16 = torch.randn(B * n, FFT, generator=g, device=synT.device,
                      dtype=torch.bfloat16)
    return device_ms(lambda: (torch.matmul(c[:, :F2], synT[:, :F2].t()),
                              torch.matmul(a16, anaT.t())), torch)


def window_steps(torch, dev, call, n_iters):
    """Where a window-route call's time goes, from one call with the
    kernel's stamps (gl_cuda._griffin_lim_cuda's trace): mean microseconds
    an iteration of each step (first block's start to last block's end) and
    of the gap between steps (last end to first start: a grid barrier, or a
    launch), the blocks (those that stamped the first step), and the SMs
    they ran on."""
    P = 3 * n_iters + 3
    trace = torch.zeros(P + 1, 1024, 2, dtype=torch.int64, device=dev)
    call(trace)
    torch.cuda.synchronize()
    grid = int((trace[0, :, 0] != 0).sum())
    st = trace[:, :grid].cpu().numpy().astype(np.float64)
    start, end = st[:P, :, 0] / 1e3, st[:P, :, 1] / 1e3    # us
    steps = {"synthesis": [], "overlap_add": [], "analysis": [], "gap": []}
    for p in range(1, P - 1):
        kind = ("synthesis", "overlap_add", "analysis")[(p - 1) % 3]
        steps[kind].append(end[p].max() - start[p].min())
    for p in range(P - 1):
        steps["gap"].append(start[p + 1].min() - end[p].max())
    out = {k: round(float(np.mean(v)), 2) for k, v in steps.items() if v}
    out.update(blocks=grid, sms=int(len(set(st[P, :, 0].tolist()))),
               total_us=round(float(end[P - 1].max() - start[0].min()), 1))
    return out


def check_b2_call(torch, dev, seed, name, alternatives=False):
    """One of B2_CALLS, kernel vs plain: max abs error and its share of the
    peak (bar 0.12), spectral convergence of both (bar 1.05x the plain
    version's), the pinned frames of the returned spectrum equal to the
    start's for the kernel and the plain version (each against its own
    spectrum after 0 iterations), two kernel calls bit-equal; the route,
    tiles, grid and launches of a call; both timers of the kernel,
    the plain version's host-paced ms, the bound and its share of the
    host-paced time, the cuBLAS yardstick of an iteration's GEMMs.
    alternatives (window route): the same call in one launch per step, and
    those launches replayed from a CUDA graph, with where the time of each
    goes (window_steps)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda

    S, win, kw = b2_inputs(torch, dev, seed, name)
    B, n, iters, _, n_pinned, spec, _, _ = B2_CALLS[name]

    def kernel(iters=iters, plan=None, trace=None):
        if plan is None and trace is None:
            return gl_cuda.griffin_lim(S, FFT, HOP, win,
                                       **dict(kw, n_iters=iters))
        return gl_cuda._griffin_lim_cuda(S, FFT, HOP, win, plan=plan,
                                         trace=trace,
                                         **dict(kw, n_iters=iters))

    def plain(iters=iters):
        res = gl_cuda.griffin_lim_plain(S, FFT, HOP, win,
                                        **dict(kw, n_iters=iters))
        return (res[0][:, :n * HOP], res[1]) if spec else res[:, :n * HOP]

    got, want, again = kernel(), plain(), kernel()
    torch.cuda.synchronize()
    plan = gl_cuda.gl_plan(B, n, FFT, HOP)
    row = {"plan": plan._asdict(),
           "launches_per_call": gl_cuda.gl_launches(plan, iters, spec)}
    if spec:
        (got, got_spec), (want, want_spec) = got, want
        starts = (kernel(0)[1], plain(0)[1])
        row["pinned_exact"] = [
            all(torch.equal(a[:, :n_pinned], b[:, :n_pinned])
                for a, b in zip(sp, st))
            for sp, st in zip((got_spec, want_spec), starts)]
        row["bit_equal"] = torch.equal(got, again[0]) and all(
            torch.equal(a, b) for a, b in zip(got_spec, again[1]))
    else:
        row["bit_equal"] = torch.equal(got, again)
    row["unpinned_edge"] = n_pinned == 0
    err, rel, first = wave_err(got, want, row["unpinned_edge"])
    row.update(err=err, rel=rel, first_hop_rel=first,
               sc=spectral_convergence(torch, got, S),
               sc_plain=spectral_convergence(torch, want, S),
               bound=b2_bound(name))
    if row["unpinned_edge"] and B == 1:
        row["plain_cpu_first_hop_rel"] = plain_cpu_first_hop(
            torch, S, win, dict(kw, n_iters=iters), want)
    row.update(b2_timed(torch, kernel))
    row["plain_ms"] = cuda_ms(plain, torch)
    row["bound_share"] = row["bound"][0] / row["cuda_ms"]
    row["gemm_library_ms"] = b2_gemm_library_ms(torch, gl_cuda, kw["mats"],
                                                B, n)
    if alternatives and plan.route == "window":
        steps = plan._replace(one_launch=False)
        row["steps"] = b2_timed(torch, lambda: kernel(plan=steps))
        row["steps_graph"] = graph_timed(torch, lambda: kernel(plan=steps))
        row["steps_graph_copies"] = graph_timed(
            torch, lambda: kernel(plan=steps),
            inputs=[S] + list(kw.get("init_spec", ())))
        row["step_us"] = window_steps(torch, dev,
                                      lambda tr: kernel(trace=tr), iters)
        row["grid"] = row["step_us"]["blocks"]
        row["steps_graph_us"] = window_steps(
            torch, dev, lambda tr: capture_graph(
                torch, lambda: kernel(plan=steps, trace=tr))[0].replay(),
            iters)
    return row, S, win, kw


def b2_ok(row):
    """The B2 bars: 0.12 of the peak (wave_err), spectral convergence 1.05x
    the plain version's, pinned frames exact, two runs bit-equal."""
    return (row["rel"] < 0.12 and row["sc"] <= 1.05 * row["sc_plain"]
            and all(row.get("pinned_exact", [True])) and row["bit_equal"])


def b2_line(name, row, card):
    B, n, iters, start, n_pinned, spec, fold, _ = B2_CALLS[name]
    alt = ""
    if "steps" in row:
        alt = ("; one launch a step %.3f / %.3f ms, those launches from a "
               "CUDA graph %.3f / %.3f ms (with the inputs copied in and the "
               "results cloned out, as a caller would: %.3f / %.3f ms); us "
               "an iteration in the one launch %s, in the graph %s" % (
                   row["steps"]["cuda_ms"], row["steps"]["device_ms"],
                   row["steps_graph"]["cuda_ms"],
                   row["steps_graph"]["device_ms"],
                   row["steps_graph_copies"]["cuda_ms"],
                   row["steps_graph_copies"]["device_ms"],
                   json.dumps(row["step_us"]),
                   json.dumps(row["steps_graph_us"])))
    edge = ""
    if row["unpinned_edge"]:
        edge = (" after the first hop; the first hop, amplified rounding "
                "noise where no frame is pinned, %.4f of the whole peak, "
                "held by the spectral convergence" % row["first_hop_rel"])
        if "plain_cpu_first_hop_rel" in row:
            edge += ("; the plain version on the CPU parts from the card's "
                     "there by %.4f" % row["plain_cpu_first_hop_rel"])
    return ("(%d, %d, 513) x %d, %s start%s, %d pinned%s: max abs err %.3g "
            "(%.4f of peak, bar 0.12%s), spectral convergence kernel %.4f "
            "plain %.4f (bar 1.05x)%s, two runs bit-equal %s; kernel "
            "%.3f ms host-paced, %.3f ms device, plain %.3f ms, bound "
            "%.4f ms (%s, %.3f of the host-paced time); route %s (%d-row "
            "tiles, %d / %d columns%s), %d launches a call%s (%s)"
            % (B, n, iters, start, "" if fold else ", windows unfolded",
               n_pinned, ", spectrum returned" if spec else "", row["err"],
               row["rel"], edge, row["sc"], row["sc_plain"],
               ", pinned frames equal to the start (kernel, plain) %s"
               % row["pinned_exact"] if "pinned_exact" in row else "",
               row["bit_equal"], row["cuda_ms"], row["device_ms"],
               row["plain_ms"], row["bound"][0], row["bound"][1],
               row["bound_share"], row["plan"]["route"], row["plan"]["bm"],
               row["plan"]["bn_syn"], row["plan"]["bn_ana"],
               ", grid %d" % row["grid"]
               if row["plan"]["route"] == "window" else "",
               row["launches_per_call"], alt, card))


WINDOW_TILES = ((64, 32), (64, 64), (128, 128))


def check_window_tiles(torch, dev, seed):
    """Device ms of the three window calls at every window tile (rows,
    columns), one launch each, and the plan's pick."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda

    out = {}
    for name in ("stream", "window_152", "window_40"):
        S, win, kw = b2_inputs(torch, dev, seed, name)
        B, n = S.shape[:2]
        p = gl_cuda.gl_plan(B, n, FFT, HOP)
        row = {"picked": "%d x %d" % (p.bm, p.bn_syn)}
        for bm, bn in WINDOW_TILES:
            plan = gl_cuda.Plan("window", bm, bn, bn, True)
            row["%d x %d" % (bm, bn)] = round(device_ms(
                lambda: gl_cuda._griffin_lim_cuda(S, FFT, HOP, win,
                                                  plan=plan, **kw),
                torch), 4)
        out[name] = row
    return out


def check_b2(torch, dev, seed):
    """B2 at (32, 400, 513) x 16, SPSI start (the batch route); the GEMMs'
    device ms per iteration (profiler) against the cuBLAS yardstick."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda

    row, S, win, kw = check_b2_call(torch, dev, seed, "batch")
    per_iter, syn, ana = b2_gemm_ms(
        torch, lambda: gl_cuda.griffin_lim(S, FFT, HOP, win, **kw),
        kw["n_iters"])
    row.update(gemm_ms_per_iter=per_iter, gemm_syn_ms=syn, gemm_ana_ms=ana)
    return row


def check_anchored(torch, dev, seed, n=152, n_ctx=16, n_iters=32):
    """B2's anchored start (a streaming window's, computed in the kernel)
    against its plain version (`gl_cuda.anchored_start` + the given start)
    on two consecutive windows of one signal: the first without a context,
    the second with the first's retrieved spectrum of its last n_ctx
    frames. Per window: the start spectra (0 iterations) bit-equal to the
    plain version's on the card, and against the plain version on the CPU
    2^-8 in relative L2 norm with at most 1 in 1000 of the bf16 values
    different; the waveform (after the first hop of the first, unpinned,
    window: wave_err) and spectral
    convergence after n_iters at the B2 bars, the pinned frames of the
    returned spectrum equal to the kernel's own start; then the device
    kernels of one streaming.gl_window call (profiler)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    win = dsp.lws_hann_window(FFT, HOP)
    S_all = tone_mags(torch, dev, seed + 7, 1, 2 * n - n_ctx)
    mats = gl_cuda.gl_mats(FFT, win, dev)
    cpu_mats = gl_cuda.gl_mats(FFT, win, "cpu")
    rows, ctx = [], None
    for S in (S_all[:, :n], S_all[:, n - n_ctx:]):
        kw = dict(momentum=0.9, mats=mats, phase_init="anchored",
                  context_spec=ctx, return_spec=True)
        got, spec = gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=n_iters,
                                        **kw)
        want, want_spec = gl_cuda.griffin_lim_plain(
            S, FFT, HOP, win, n_iters=n_iters, **kw)
        want = want[:, :n * HOP]
        _, start = gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=0, **kw)
        _, pstart = gl_cuda.griffin_lim_plain(S, FFT, HOP, win, n_iters=0,
                                              **kw)
        _, cstart = gl_cuda.griffin_lim_plain(
            S.cpu(), FFT, HOP, win, n_iters=0, **dict(
                kw, mats=cpu_mats, context_spec=None if ctx is None
                else tuple(a.cpu() for a in ctx)))
        torch.cuda.synchronize()
        k = 0 if ctx is None else n_ctx
        cs, cc = torch.complex(*start), torch.complex(*cstart)
        err, rel, first = wave_err(got, want, k == 0)
        rows.append({
            "n_ctx": k,
            "start_equal": all(torch.equal(a, b)
                               for a, b in zip(start, pstart)),
            "start_rel_cpu": float((cs.cpu() - cc).abs().norm()
                                   / cc.abs().norm()),
            "start_differs_cpu": float(sum(
                (a.cpu() != b).double().mean() for a, b in zip(
                    start, cstart)) / 2),
            "err": err, "rel": rel, "first_hop_rel": first,
            "unpinned_edge": k == 0,
            "plain_cpu_first_hop_rel": plain_cpu_first_hop(
                torch, S, win, dict(kw, n_iters=n_iters), want)
            if k == 0 else None,
            "sc": spectral_convergence(torch, got, S),
            "sc_plain": spectral_convergence(torch, want, S),
            "pinned_exact": all(torch.equal(a[:, :k], b[:, :k])
                                for a, b in zip(spec, start))})
        ctx = tuple(a[:, n - n_ctx:] for a in spec)
    ok = all(r["start_equal"] and r["start_rel_cpu"] <= 2.0 ** -8
             and r["start_differs_cpu"] <= 1e-3 and r["rel"] < 0.12
             and r["sc"] <= 1.05 * r["sc_plain"] and r["pinned_exact"]
             for r in rows)
    return rows, ok


def gl_window_kernels(torch, streaming, ap, dev, seed, n=152, n_ctx=16):
    """Device kernels (name, launches) of one streaming.gl_window call with
    a context, from torch.profiler: B2's one launch and the eager
    denormalisation around it."""
    from torch.profiler import ProfilerActivity, profile

    spec = torch.rand(1, n, ap.fft_size // 2 + 1, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(seed))
    prev = streaming.gl_window(ap, spec[:, :n_ctx], None, 32)[1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        streaming.gl_window(ap, spec, prev, 32)
        torch.cuda.synchronize()
    return [[e.key[:60], e.count] for e in prof.key_averages()
            if str(e.device_type).split(".")[-1] == "CUDA"]


def check_p(torch, pkg, dev, seed, repo):
    """The probe kernel P (B2 with the windows applied in f32 outside the
    bf16 DFT matrices) at the probe's shape, kernel vs plain
    (check_b2_call); then its own path, what the probe measured: spectral
    convergence on the golden fixture (kernel and plain), the
    per-iteration slope from the 4- and 16-iteration times, and the time of
    the folded B2 at the same shape. Returns (row, P launches on its own
    path)."""
    from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda

    row, S, win, kw = check_b2_call(torch, dev, seed, "P")
    B, n_iters = S.shape[0], kw["n_iters"]
    folded_mats = gl_cuda.gl_mats(FFT, win, dev)

    def kernel(iters=n_iters, S=S):
        return gl_cuda.griffin_lim(S, FFT, HOP, win,
                                   **dict(kw, n_iters=iters))

    gl_cuda.KERNEL.reset_counts()
    lin = np.load(os.path.join(repo, "tests", "data",
                               "dsp_golden_linear.npy"))       # (F, n)
    ap = pkg["AudioProcessor"](ljspeech_hparams(pkg["hparams"], repo))
    Sg = ap._denorm_pow(torch.from_numpy(lin.T.copy())[None].to(dev))
    row["sc_golden"] = spectral_convergence(torch, kernel(S=Sg), Sg)
    row["ms_4"] = cuda_ms(lambda: kernel(4), torch)
    row["ms"] = cuda_ms(kernel, torch)
    launches = gl_cuda.KERNEL.by_entry.get("unfolded", 0)
    row["sc_golden_plain"] = spectral_convergence(
        torch, gl_cuda.griffin_lim_plain(Sg, FFT, HOP, win, **kw)
        [:, :Sg.shape[1] * HOP], Sg)
    row["us_per_item_iter"] = ((row["ms"] - row["ms_4"]) * 1e3
                               / (n_iters - 4) / B)
    row["folded_ms"] = cuda_ms(lambda: gl_cuda.griffin_lim(
        S, FFT, HOP, win, n_iters=n_iters, momentum=0.9, mats=folded_mats),
        torch)
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


class plain_griffin_lim_on_card:
    """Within it, Griffin-Lim on CUDA tensors runs its plain version (on the
    card) instead of kernel B2: the yardstick of how far two correct
    schedules of the same retrieval part on this input."""

    def __enter__(self):
        from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda

        self.gl, self.kernel = gl_cuda, gl_cuda._griffin_lim_cuda

        def plain(S, fft, hop, win, **kw):
            return gl_cuda.griffin_lim_plain(S, fft, hop, win, **kw)

        gl_cuda._griffin_lim_cuda = plain
        return self

    def __exit__(self, *exc):
        self.gl._griffin_lim_cuda = self.kernel


def check_small_stream(torch, pkg, dev, name="deepvoice3"):
    """The tiny model's tts_stream on the GPU (kernels) and on the CPU
    (plain versions), emit_linear on; for the builder held to the sample
    bar, also the waveform of the same stream on the GPU with Griffin-Lim's
    plain version (`plain_wave_rel`, against the CPU)."""
    cfg, params, ap, spk = tiny_model(pkg, name=name)
    kw = dict(max_decoder_steps=40, emit_linear=True, speaker_ids=spk)
    texts = SENTENCES[:3]
    stream = pkg["streaming"].tts_stream
    ref = list(stream(params, cfg, ap, pkg["en"], texts, **kw))
    got = list(stream(params.to(dev), cfg, ap, pkg["en"], texts, **kw))
    plain_got = None
    if name == "deepvoice3":
        with plain_griffin_lim_on_card():
            plain_got = list(stream(params.to(dev), cfg, ap, pkg["en"],
                                    texts, **kw))
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
        if plain_got is not None:
            worst["plain_wave_rel"] = max(
                float(np.abs(g["audio"] - r["audio"]).max()
                      / max(np.abs(r["audio"]).max(), 1e-9))
                for g, r in zip(plain_got, ref))
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


def b1_setup_split(torch, pkg, params, cfg, ap, text, reps=5):
    """Host ms, synchronised after each part, of what streaming's
    prepare_decode does at B = 1 before the first launch: the encoder and
    the decode inputs, the packed plan's lookup (fd.packed_plan), the whole
    FusedDecoder construction (the lookup again, the K/V fold, the mask,
    the position rows, the workspace), the fold alone once more, and the
    carry and output buffers; per part the least of `reps`. Also the plan
    builds (fd.build_plan calls) during three whole streams after it: 0
    when every stream hits the cache."""
    from deepvoice3_pytorch_tpu_torch import builder
    from deepvoice3_pytorch_tpu_torch.ops import core
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    synthesis, en, dc = pkg["synthesis"], pkg["en"], cfg.decoder
    fam = cfg.family
    dev = next(iter(params.parameters())).device
    grid, budget = fd.device_info(dev)
    best = {}
    with torch.inference_mode():
        x, pos, lengths = (torch.from_numpy(a).to(dev) for a in
                           synthesis._prepare_batch(en, [text], 0.0, 8))
        for _ in range(reps):
            t = [time.time()]

            def mark(name):
                torch.cuda.synchronize()
                t.append(time.time())
                v = (t[-1] - t[-2]) * 1e3
                best[name] = min(best.get(name, v), v)

            se = builder.embed_speakers(params, cfg, None)
            enc = fam.encoder_apply(params["encoder"], cfg.encoder, x,
                                    speaker_embed=se)
            mask = core.get_mask_from_lengths(lengths, enc[0].shape[1])
            fi = fam.fused_decode_inputs(params["decoder"], dc, enc, pos,
                                         200, speaker_embed=se)
            mark("encoder_and_inputs")
            fd.packed_plan(params["decoder"], dc, grid, budget)
            mark("plan_lookup")
            dec = fd.FusedDecoder(params["decoder"], dc, fi, mask, 200)
            mark("decoder_init")
            fd.attention_operands(dec.layout.att_w, dec.kv)
            mark("fold")
            dec.zero_carry(torch.zeros(1, dc.in_dim * dc.r, device=dev))
            dec.new_outputs(200)
            mark("carry_and_outputs")
    out = {k: round(v, 4) for k, v in best.items()}
    builds = [0]
    build_plan = fd.build_plan

    def counted(*a, **kw):
        builds[0] += 1
        return build_plan(*a, **kw)

    fd.build_plan = counted
    try:
        for _ in range(3):
            run_stream(torch, pkg["streaming"], params, cfg, ap, en, [text])
    finally:
        fd.build_plan = build_plan
    out["plan_builds_in_3_streams"] = builds[0]
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
                "griffin_lim_by_route": dict(gl_cuda.KERNEL.by_route),
                "conv_taps": conv_cuda.KERNEL.launches}
    res = pkg["synthesis"].tts_batch(params, cfg, ap, en, SENTENCES[:8],
                                     max_decoder_steps=200)
    rows["batch_decoded_steps"] = [r["num_decoder_steps"] for r in res]
    rows["stages"] = stream_stages(torch, streaming, pkg["synthesis"],
                                   params, cfg, ap, en, SENTENCES[0])
    rows["setup_split"] = b1_setup_split(torch, pkg, params, cfg, ap,
                                         SENTENCES[0])
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


def slot_rows(torch, fi, lengths, Tk):
    """(row, mask): row(b, n=Tk) gives row b of the batched fused-decode
    inputs fi as batch-1 inputs of its first n keys; mask (B, Tk) is True
    where padded."""
    from deepvoice3_pytorch_tpu_torch.ops import core

    def row(b, n=Tk):
        one = slice(b, b + 1)
        return dict(fi, projected_kv=[
            None if p is None else (p[0][one, :n], p[1][one, :n])
            for p in fi["projected_kv"]],
            w_query=None if fi["w_query"] is None else fi["w_query"][one],
            speaker_bias=[x[one] for x in fi["speaker_bias"] or []],
            speaker_embed=(None if fi.get("speaker_embed") is None
                           else fi["speaker_embed"][one]))

    return row, core.get_mask_from_lengths(lengths, Tk)


def slot_inputs(torch, fd, fi, lengths, Tk, scales, att_w=None):
    """fused_decode.SlotInputs whose row b holds row b of the batched
    fused-decode inputs fi, written the way an admission writes it; folded
    with a SlotDecoder's att_w when it is given."""
    row, mask = slot_rows(torch, fi, lengths, Tk)
    si = fd.slot_inputs(row(0), mask.shape[0], Tk,
                        *([] if att_w is None else [att_w]))
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
    kern = fd.SlotDecoder(pd, dc, S, dev)
    si = slot_inputs(torch, fd, fi, lengths, Tk, scales, kern.att_w)
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

    fd.KERNEL.reset_counts()
    got, c_k = run(kern, si)
    routes = dict(fd.KERNEL.by_route)
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

    def launch(**kw):
        kern.launch(si, carry, outs, steps, **kw)
    ms = cuda_ms(launch, torch, reps=10)
    p_carry = plain.zero_carry()
    p_outs = plain.new_outputs(steps, Tk)
    plain_ms = cuda_ms(lambda: plain.launch(si, p_carry, p_outs, steps),
                       torch, reps=1)
    c1 = kern.zero_carry()
    c1.pos[:] = local
    o1 = kern.new_outputs(1, Tk)
    las = b1_step_las(torch, kern,
                      lambda: c1.last_attended[:, :kern.plan.n_att],
                      lambda t: kern.launch(si, c1, o1, 1), steps)
    n_keys = b1_keys_scored(fd, kern, si.addmask < 0, las)
    row_of, mask = slot_rows(torch, fi, lengths, Tk)
    row0 = row_of(0)
    bound_ = b1_bound_ms(torch, pkg, hp, dev, seed, B=S, Tk=Tk, steps=steps,
                         keys=n_keys)
    ok = (not flips and pos_exact
          and all(errs[n] <= 3 * floor[n] + 1e-6 for n in errs))
    return {"errs": errs, "floor": floor, "flips": flips[:8],
            "positions_exact": pos_exact, "err": max(errs.values()),
            "ms": ms, "launch_device_ms": device_ms(launch, torch),
            "plain_ms": plain_ms, "bound": bound_, "keys_scored": n_keys,
            "keys_all": S * steps * kern.plan.n_att * Tk,
            "admit_ms": cuda_ms(lambda: fd.write_slot_row(
                si, 0, row0, mask[0:1], scales[0]), torch, reps=10),
            "bound_share": bound_[0] / ms, "layout": b1_layout_row(kern),
            "stage_us": b1_stage_us(torch, kern, launch, steps),
            "routes": routes}, ok


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
                        "griffin_lim_by_route": dict(
                            gl_cuda.KERNEL.by_route),
                        "conv_taps": conv_cuda.KERNEL.launches}
            for k in path_launches:
                path_launches[k] += launches[k]
            if launches["fused_decode_slots"] != steps or \
                    launches["fused_decode_other"] or \
                    launches["griffin_lim"] <= 0 or launches["conv_taps"] \
                    or set(launches["griffin_lim_by_route"]) != {"window"}:
                fail("%s: launches %s over %d steps: one serving-mode B1 "
                     "launch a step, B2 launched on its window route, "
                     "nothing else" % (label, launches, steps))
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
    out[i] = (t_first, time.time() - t, body.hex(), t)

rounds = []
for _ in range(2):   # the first round is each thread's first request
    out = {}
    threads = [threading.Thread(target=fetch, args=(i,))
               for i in range(len(texts))]
    t0 = time.time()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    rounds.append({"wall": time.time() - t0, "out": out})
print(json.dumps({"rounds": rounds}))
"""


def serve_slots_main_path(torch, pkg, params, cfg, ap, card):
    """TTSEngine(slots=8) + make_handler on serve.TTSServer at
    127.0.0.1:0: after the warm-up, two rounds of 8 concurrent /tts
    requests from a client process of their own (its time to the first PCM
    bytes: clients in this process would wait for the interpreter lock
    behind the batcher's worker thread), the first being each client
    thread's first request; /stats; then one request to an engine with
    max_backlog=0, which must answer 503 with Retry-After: 1 and count it
    as rejected. Per request, the host ms from the client's send to each
    hop of serve.HOPS and to the client's first bytes (wall clocks of one
    host). Returns (rows, serving launches of B1, problems)."""
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
    engine = serve.TTSEngine(params, cfg, ap, en, max_decoder_steps=200,
                             slots=8)
    engine.warmup()
    server = serve.TTSServer(("127.0.0.1", 0), serve.make_handler(engine))
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
                    "griffin_lim": gl_cuda.KERNEL.launches,
                    "griffin_lim_by_route": dict(gl_cuda.KERNEL.by_route)}
        if res.returncode != 0:
            fail("serve_slots clients: %s" % res.stderr[-2000:])
        rounds = json.loads(res.stdout.strip().splitlines()[-1])["rounds"]
        rows["wall_ms"] = rounds[0]["wall"] * 1e3
        rows["wall_ms_second_round"] = rounds[1]["wall"] * 1e3
        # a text's first trace (oldest first) is its first round's
        by_round = [{}, {}]
        for h in engine.hops():
            by_round[1 if h["text"] in by_round[0] else 0].setdefault(
                h["text"], h)
        rows["requests_second_round"] = []
        for got, key, traces in zip(rounds, ("requests",
                                             "requests_second_round"),
                                    by_round):
            for i in range(8):
                if str(i) not in got["out"]:
                    problems.append("request %d failed" % i)
                    continue
                t_first, wall, body, t_send = got["out"][str(i)]
                body = bytes.fromhex(body)
                n = (len(body) - 44) // 2
                trace = traces.get(SENTENCES[i], {})
                rows[key].append({
                    "ttfa_ms": t_first * 1e3, "wall_ms": wall * 1e3,
                    "samples": n, "hops_ms": {
                        h: None if trace.get(h) is None
                        else round((trace[h] - t_send) * 1e3, 2)
                        for h in serve.HOPS}})
                if body[:4] != b"RIFF" or \
                        struct.unpack("<I", body[24:28])[0] != \
                        ap.sample_rate or n <= 0 or n % per_step or \
                        n > 200 * per_step:
                    problems.append("request %d: bad WAV (%d samples)"
                                    % (i, n))
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            rows["stats"] = json.loads(r.read())
        st = rows["stats"]
        if st["requests_total"] != 16 or st["requests_failed"] or \
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


# Run in a checkout's root with this script's path as its one argument:
# B1's launch alone at B1_SHAPES, timed by this script's functions on the
# checkout's own kernel (an earlier commit's included).
B1_TURNS = r"""
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location('smoke', sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, '.')
from deepvoice3_pytorch_tpu_torch import hparams, model_builder, streaming
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
from deepvoice3_pytorch_tpu_torch.frontend import en
from deepvoice3_pytorch_tpu_torch.ops import core, fused_decode as fd
cs.build_kernels((fd.KERNEL, gl_cuda.KERNEL))
pkg = dict(hparams=hparams, model_builder=model_builder, en=en,
           streaming=streaming, AudioProcessor=AudioProcessor)
dev = torch.device('cuda', 0)
with core.strict_numerics():
    r = cs.b1_launch_times(torch, pkg, fd, '.', dev, 1234)
    r['stream_b1'] = cs.stream_ttfa(torch, pkg, cs.ljspeech_hparams(
        hparams, '.'), dev, 1234)
print(json.dumps(r))
"""


def b1_turns(parent, card):
    """B1's launch alone at B1_SHAPES (the LJSpeech, nyanko and VCTK chunks
    at B = 32, the serving launch, the LJSpeech chunk at B = 1), with the
    whole call, the fold and an admission (b1_launch_times), and a B = 1
    stream's time to first audio (stream_ttfa), on `parent`'s package and
    on this checkout's, timed by this script in turns parent, this, this,
    parent, each a fresh process."""
    here = os.path.abspath(__file__)
    turns = []
    for name, tree in (("parent", parent), ("this", os.path.dirname(here)),
                       ("this", os.path.dirname(here)), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", B1_TURNS, here],
                             cwd=tree, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            fail("b1 turn in %s: %s" % (tree, res.stderr[-2000:]))
        turns.append([name, json.loads(res.stdout.strip().splitlines()[-1])])
        phase("b1_turns", "%s: %s (%s)" % (name, json.dumps(turns[-1][1]),
                                           card))
    print(json.dumps({"b1_launch_turns": turns, "card": card}), flush=True)


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


def b1_phases(torch, pkg, presets, dev, seed, card):
    """Phases B1, B1_nyanko, B1_vctk, B1_b1 and B1_serve. Returns (all
    bars met, rows by phase, the B1_serve row)."""
    ok = True
    b1_rows = {}
    for label, hp_b1, B in (("B1", presets["B1"], 32),
                            ("B1_nyanko", presets["B1_nyanko"], 32),
                            ("B1_vctk", presets["B1_vctk"], 32),
                            ("B1_b1", presets["B1"], 1)):
        row = (check_b1(torch, pkg, hp_b1, dev, seed) if B > 1 else
               check_b1_rows(torch, pkg, hp_b1, dev, seed))
        b1_rows[label] = row
        phase(label, b1_line(label, hp_b1.builder, B, row, card))
        if B == 1:
            phase(label, "each row decoded alone, [row, the largest of its "
                  "errors over its own floor, of the kernel's drift from "
                  "float64 over the plain version's]: %s" % json.dumps([
                      [r["row"]] + [round(max(
                          r[k][n] / max(r["floor"][n], 1e-30)
                          for n in r["errs"]), 3)
                          for k in ("errs", "vs_float64")]
                      for r in row["rows"]]))
        ok &= row["ok"]
        if set(row["routes"]) != {"persistent"}:
            fail("%s: B1 took routes %s" % (label, row["routes"]))
    b1s, b1s_ok = check_b1_serve(torch, pkg, presets["B1"], dev, seed)
    phase("B1_serve", "fused decode serving modes (per-row positions "
          "advanced in the kernel, per-row context scales) vs the plain "
          "per-row decode, LJSpeech, S=8 Tk=128, rows at positions 0, "
          "16, ..., 96 and the table's end - 4, scales of buckets 64 "
          "and 128, 2 x 16 steps: max abs err %s, plain-vs-float64 "
          "floor %s (bar 3x floor), last_attended flips %s, positions "
          "exact %s; a 16-step launch (the whole SlotDecoder.launch "
          "call) %.4f ms host-paced, %.4f ms device (phase B1's LJSpeech "
          "chunk: %.4f ms per 32 steps at B=32, Tk=96), plain %.3f ms, "
          "an admission (write_slot_row, which folds the row's K/V) %.4f "
          "ms host-paced, bound %.4f ms (%s; %d keys scored of %d), %.4f "
          "of the launch; layout %s; a launch's "
          "time (block 0's stamps) %s; launches by route %s (%s)" % (
              json.dumps(b1s["errs"]), json.dumps(b1s["floor"]),
              b1s["flips"], b1s["positions_exact"], b1s["ms"],
              b1s["launch_device_ms"], b1_rows["B1"]["launch_ms"],
              b1s["plain_ms"], b1s["admit_ms"], b1s["bound"][0],
              b1s["bound"][1], b1s["keys_scored"], b1s["keys_all"],
              b1s["bound_share"], json.dumps(b1s["layout"]),
              json.dumps(b1s["stage_us"]), json.dumps(b1s["routes"]), card))
    if set(b1s["routes"]) != {"persistent"}:
        fail("B1_serve: B1 took routes %s" % b1s["routes"])
    ok &= b1s_ok
    return ok, b1_rows, b1s


def b2_phases(torch, pkg, hp, dev, seed, repo, card):
    """B2's phases: the batch call with its GEMM yardstick, the three window
    calls (with their one-launch-a-step and CUDA-graph alternatives), the
    anchored start and one streaming.gl_window call's device kernels, and
    P. Returns (every bar held, rows)."""
    from deepvoice3_pytorch_tpu_torch import streaming
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor

    ok = True
    b2 = check_b2(torch, dev, seed)
    phase("B2", "griffin-lim kernel vs plain, " + b2_line("batch", b2,
                                                            card))
    phase("B2", "its GEMMs, device ms an iteration at (32, 400): %.4f "
          "(synthesis %.3f ms in 17 launches, analysis %.3f ms in 16); "
          "torch.matmul (cuBLAS) on the same bf16 operands %.4f ms (%s)"
          % (b2["gemm_ms_per_iter"], b2["gemm_syn_ms"],
             b2["gemm_ana_ms"], b2["gemm_library_ms"], card))
    ok &= b2_ok(b2)
    b2_windows = {}
    for name in ("stream", "window_152", "window_40"):
        row = check_b2_call(torch, dev, seed, name, alternatives=True)[0]
        b2_windows[name] = row
        phase("B2_stream" if name == "stream" else "B2_" + name,
              "griffin-lim stream modes kernel vs plain, "
              + b2_line(name, row, card))
        ok &= b2_ok(row) and row["plan"]["route"] == "window"
    b2s = b2_windows["stream"]
    tiles = check_window_tiles(torch, dev, seed)
    phase("B2_tiles", "window calls, device ms at each window tile: %s (%s)"
          % (json.dumps(tiles), card))

    anchored, anchored_ok = check_anchored(torch, dev, seed)
    window_kernels = gl_window_kernels(torch, streaming,
                                       AudioProcessor(hp), dev, seed)
    b2_calls = sum(c for k, c in window_kernels if "gl_window" in k)
    phase_ops = [k for k, _ in window_kernels if any(
        s in k for s in ("atan2", "cos_", "sin_", "Scan", "scan",
                         "CatArray"))]
    phase("B2_anchored", "anchored start (in the kernel) vs its plain "
          "version, two consecutive windows (1, 152, 513) x 32, the "
          "second with 16 context frames: %s (bars: start spectra "
          "bit-equal to the plain version's on the card, 2^-8 relative L2 "
          "and at most 1e-3 of the values different against the CPU's, "
          "0.12 of peak (the unpinned first window after its first hop), "
          "spectral convergence 1.05x, "
          "pinned frames exact); one streaming.gl_window call on the "
          "card: device kernels %s, B2 launches %d, phase ops %s (%s)"
          % (json.dumps(anchored), json.dumps(window_kernels), b2_calls,
             phase_ops, card))
    ok &= anchored_ok and b2_calls == 1 and not phase_ops

    p_row, p_launches = check_p(torch, pkg, dev, seed, repo)
    p_ok = (b2_ok(p_row) and p_launches > 0
            and p_row["sc_golden"] <= 1.05 * p_row["sc_golden_plain"])
    phase("P", "unfolded-window griffin-lim kernel vs plain, "
          + b2_line("P", p_row, card))
    phase("P", "golden fixture kernel %.4f plain %.4f (bar 1.05x); "
          "kernel %.3f ms (4 iterations %.3f ms, %.2f us per "
          "item-iteration), folded B2 %.3f ms; cuBLAS yardstick for an "
          "iteration's two GEMMs %.4f ms; %d launches on its own path "
          "(%s)" % (p_row["sc_golden"], p_row["sc_golden_plain"],
                    p_row["ms"], p_row["ms_4"],
                    p_row["us_per_item_iter"], p_row["folded_ms"],
                    p_row["gemm_library_ms"], p_launches, card))
    ok &= p_ok
    return ok, {"b2": b2, "b2_windows": b2_windows, "b2s": b2s,
                "b2_tiles": tiles,
                "anchored": anchored, "p": p_row, "p_launches": p_launches}


# Run in a checkout's root with this script's path as its one argument:
# B2 at the five calls of B2_CALLS, timed by this script's functions (both
# timers) on the checkout's own Griffin-Lim kernel (an earlier commit's
# included: the keywords are those every version takes).
B2_TURNS = r"""
import importlib.util, json, sys, torch
spec = importlib.util.spec_from_file_location('smoke', sys.argv[1])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.path.insert(0, '.')
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.ops import core
cs.build_kernels((gl_cuda.KERNEL,))
dev = torch.device('cuda', 0)
out = {}
with core.strict_numerics():
    for name in cs.B2_CALLS:
        S, win, kw = cs.b2_inputs(torch, dev, 1234, name)
        out[name] = cs.b2_timed(torch, lambda: gl_cuda.griffin_lim(
            S, cs.FFT, cs.HOP, win, **kw))
print(json.dumps(out))
"""


def b2_turns(parent, card, json_out):
    """B2 at the five calls of B2_CALLS (both timers) on `parent`'s kernel
    and this checkout's, timed by this script in turns parent, this, this,
    parent, each a fresh process."""
    here = os.path.abspath(__file__)
    turns = []
    for name, tree in (("parent", parent), ("this", os.path.dirname(here)),
                       ("this", os.path.dirname(here)), ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", B2_TURNS, here],
                             cwd=tree, capture_output=True, text=True,
                             timeout=900)
        if res.returncode != 0:
            fail("b2 turn in %s: %s" % (tree, res.stderr[-2000:]))
        calls = json.loads(res.stdout.strip().splitlines()[-1])
        turns.append([name, calls])
        for call, ms in calls.items():
            phase("b2_turns", "%s %s: %s ms (%s)" % (
                name, call, json.dumps(ms), card))
    if json_out:
        os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                    exist_ok=True)
        with open(json_out, "w") as f:
            json.dump({"card": card, "b2_turns": turns}, f, indent=1)


# ---------------------------------------------------------------------------
# the command lines (deepvoice3_pytorch_tpu_torch/cli), run as a user would
# ---------------------------------------------------------------------------

CLI = "deepvoice3_pytorch_tpu_torch.cli."


def run_cli(repo, name, args, timeout=600):
    """One command line as a subprocess from the checkout's root; fails the
    smoke (with the tail of its output) on a non-zero exit. Returns its
    stdout."""
    cmd = [sys.executable, "-m", CLI + name] + [str(a) for a in args]
    t = time.time()
    try:
        r = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                           timeout=timeout)
    except subprocess.TimeoutExpired:
        fail("cli.%s timed out after %d s" % (name, timeout))
    if r.returncode != 0:
        fail("cli.%s exited %d after %.1f s:\n%s\n%s" % (
            name, r.returncode, time.time() - t, r.stdout[-3000:],
            r.stderr[-3000:]))
    return r.stdout


def write_corpus(torch, pkg, hp, root, dev, speakers=None):
    """The synthetic language's 48 sentences (utils/synthcorpus,
    make_sentences(48, seed=3)) as a preprocessed corpus under `root`:
    features from batch_features on `dev`, the .npy pairs, train.txt
    (with a fifth column of speakers (7 i) % n for a multi-speaker corpus,
    the audio rendered by that speaker) and the DSP stamp. Returns the
    sentences."""
    from deepvoice3_pytorch_tpu_torch.training import dataset
    from deepvoice3_pytorch_tpu_torch.utils import synthcorpus as sc

    texts = sc.make_sentences(48, seed=3)
    spk = None if speakers is None else [(7 * i) % speakers
                                         for i in range(len(texts))]
    wavs = [sc.synth_wav(t, hp.sample_rate, hp.hop_size,
                         speaker_id=None if spk is None else spk[i])
            for i, t in enumerate(texts)]
    feats = pkg["AudioProcessor"](hp).batch_features(wavs, device=dev)
    os.makedirs(root, exist_ok=True)
    lines = []
    for i, (text, (spec, mel)) in enumerate(zip(texts, feats)):
        names = ["synth-spec-%05d.npy" % i, "synth-mel-%05d.npy" % i]
        np.save(os.path.join(root, names[0]), np.asarray(spec, np.float32))
        np.save(os.path.join(root, names[1]), np.asarray(mel, np.float32))
        cols = names + [str(len(mel)), text]
        if spk is not None:
            cols.append(str(spk[i]))
        lines.append("|".join(cols))
    with open(os.path.join(root, "train.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    dataset.write_dsp_stamp(root, hp)
    return texts


def cli_launches(summary):
    """{kernel: launches, by entry} of a command line's summary."""
    return {k: v["by_entry"] for k, v in summary["launches"].items()}


def sc_gain(torch, ap, wav, lin):
    """Spectral convergence of a written waveform against the magnitudes
    Griffin-Lim was given for the normalized linear frames `lin`, after
    the gain that fits it best: a written wav is scaled to its peak."""
    from deepvoice3_pytorch_tpu_torch.dsp import stft as dsp

    S = ap._denorm_pow(torch.from_numpy(np.asarray(lin, np.float32)))
    w = preemphasis(torch, np.asarray(wav, np.float32), ap.preemphasis_coef)
    win = torch.from_numpy(dsp.lws_hann_window(ap.fft_size, ap.hop_size))
    M = torch.abs(dsp.stft(dsp.lws_pad(w, ap.fft_size, ap.hop_size),
                           ap.fft_size, ap.hop_size, win))[:S.shape[0]]
    gain = float((M * S).sum() / (M * M).sum())
    return float(torch.linalg.norm(gain * M - S) / torch.linalg.norm(S))


def serve_cli(repo, ckpt_path, preset, hp_str, texts, device="cuda",
              timeout=300):
    """cli.serve on 127.0.0.1 (a free port) with 8 slots; one request per
    text, one after another, from this process. Returns (rows, launches by
    kernel); stops the server with SIGINT, and kills it on any failure."""
    import http.client
    import signal
    import threading
    import urllib.parse

    proc = subprocess.Popen(
        [sys.executable, "-m", CLI + "serve", ckpt_path, "--preset", preset,
         "--hparams", hp_str, "--slots", "8", "--port", "0",
         "--max-decoder-steps", "200", "--device", device], cwd=repo,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines, errs = [], []
    up = threading.Event()

    def read_out():
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("serving on"):
                up.set()

    def read_err():
        errs.extend(proc.stderr)

    readers = [threading.Thread(target=read_out, daemon=True),
               threading.Thread(target=read_err, daemon=True)]
    for t in readers:
        t.start()
    try:
        deadline = time.time() + timeout
        while not up.wait(0.5) and proc.poll() is None \
                and time.time() < deadline:
            pass
        if not up.is_set():
            for t in readers:
                t.join(timeout=10)
            fail("cli.serve did not come up in %d s (exit %s):\n%s%s" % (
                timeout, proc.poll(), "".join(lines)[-2000:],
                "".join(errs)[-3000:]))
        port = int([l for l in lines if l.startswith("serving on")][0]
                   .split(":")[2].split()[0])
        rows = []
        for text in texts:
            conn = http.client.HTTPConnection("127.0.0.1", port,
                                              timeout=timeout)
            t0 = time.perf_counter()
            conn.request("GET", "/tts?" + urllib.parse.urlencode(
                {"text": text}))
            resp = conn.getresponse()
            head = resp.read(44)
            first_ms = (time.perf_counter() - t0) * 1e3
            body = head + resp.read()
            rows.append({"status": resp.status, "first_bytes_ms": first_ms,
                         "total_ms": (time.perf_counter() - t0) * 1e3,
                         "wav_header": body[:4] == b"RIFF"
                         and body[8:12] == b"WAVE",
                         "pcm_samples": (len(body) - 44) // 2,
                         "pcm_even": (len(body) - 44) % 2 == 0})
            conn.close()
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=120)
        for t in readers:
            t.join(timeout=10)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        fail("cli.serve exited %d:\n%s" % (proc.returncode,
                                           "".join(errs)[-3000:]))
    launch = [l for l in lines if l.startswith("kernel launches: ")]
    if not launch:
        fail("cli.serve printed no launch counts")
    counts = json.loads(launch[-1][len("kernel launches: "):])
    return rows, {k: v["by_entry"] for k, v in counts.items()}


def cli_totals(launches):
    """The command lines' launches summed over their phases, as the kernels
    line counts them: B1 outside and inside its serving mode, B2's batch
    route and its streaming modes, B3 by entry and route. Fails unless each
    of B1, B2 and B3 was launched."""
    out = {"fused_decode": 0, "fused_decode_slots": 0, "griffin_lim": 0,
           "griffin_lim_stream": 0, "conv_taps": {}}
    for per in launches.values():
        for entry, n in per["fused_decode"].items():
            out["fused_decode_slots" if entry == "slots"
                else "fused_decode"] += n
        for entry, n in per["griffin_lim"].items():
            out["griffin_lim" if entry == "batch"
                else "griffin_lim_stream"] += n
        for entry, n in per["conv_taps"].items():
            out["conv_taps"][entry] = out["conv_taps"].get(entry, 0) + n
    if not (out["fused_decode"] and out["fused_decode_slots"]
            and out["griffin_lim"] and out["griffin_lim_stream"]
            and sum(out["conv_taps"].values())):
        fail("B1, B2 (both modes) or B3 was not launched on the command "
             "lines' paths: %s" % json.dumps(out))
    return out


def cli_phases(torch, pkg, repo, card, dev, device="cuda", extra_hp="",
               train_steps=40, builder_steps=5):
    """Phases cli_corpus, cli_train, cli_resume, cli_synthesis, cli_serve
    and cli_builders: the six command lines' main path at the presets' full
    width (extra_hp narrows them for a rehearsal on the CPU). Returns
    (ok, rows, launches: {phase: {kernel: by entry}})."""
    import shutil
    import tempfile

    from deepvoice3_pytorch_tpu_torch.training import checkpoint as ckpt
    from deepvoice3_pytorch_tpu_torch.utils import synthcorpus as sc

    hparams, en = pkg["hparams"], pkg["en"]
    presets = {k: os.path.join(repo, "presets", k + ".json") for k in
               ("deepvoice3_ljspeech", "nyanko_ljspeech", "deepvoice3_vctk")}
    work = tempfile.mkdtemp(prefix="dv3_cli_")
    ok, rows, launches = True, {}, {}
    try:
        # -- corpus ------------------------------------------------------
        hp = preset_hparams(hparams, repo, "deepvoice3_ljspeech")
        hp.parse(extra_hp)
        t = time.time()
        corpus = os.path.join(work, "ljspeech")
        texts = write_corpus(torch, pkg, hp, corpus, dev)
        kpr = sc.mean_frames_per_char(texts, hp.sample_rate, hp.hop_size) \
            / (hp.downsample_step * hp.outputs_per_step)
        hp_str = ",".join(s for s in ("key_position_rate=%.4f" % kpr,
                                      extra_hp) if s)
        hp.parse(hp_str)
        phase("cli_corpus", "48 synthetic sentences, features on %s, "
              "train.txt + .npy + dsp_config.json in %.1f s; "
              "key_position_rate %.4f" % (dev, time.time() - t, kpr))

        # -- train ---------------------------------------------------------
        ck_dir = os.path.join(work, "ck")
        train_hp = hp_str + ",checkpoint_interval=%d,eval_interval=%d" % (
            train_steps // 2, train_steps)
        common = ["--preset", presets["deepvoice3_ljspeech"], "--device",
                  device, "--data-root", corpus]
        t = time.time()
        run_cli(repo, "train", common + [
            "--hparams", train_hp, "--checkpoint-dir", ck_dir,
            "--max-steps", train_steps, "--async-checkpoint",
            "--log-event-path", os.path.join(work, "log"),
            "--summary-json", os.path.join(work, "train.json")])
        wall = time.time() - t
        with open(os.path.join(work, "train.json")) as f:
            tr = json.load(f)
        losses = tr["losses"]
        launches["cli_train"] = cli_launches(tr)
        b3 = launches["cli_train"]["conv_taps"]
        evals = sorted(os.listdir(os.path.join(ck_dir, "eval")))
        mid = ckpt.checkpoint_path(ck_dir, train_steps // 2)
        last = ckpt.checkpoint_path(ck_dir, train_steps)
        rows["cli_train"] = {
            "steps": len(losses), "first_loss": losses[0],
            "last_loss": losses[-1],
            "steady_steps_per_s": tr.get("steady_steps_per_s"),
            "sync_save_ms": tr["save_ms"],
            "async_save_stall_ms": tr["async_stall_ms"],
            "eval_ms": tr["eval_ms"], "file_bytes": tr["files"],
            "command_s": wall, "b3_by_route": b3,
            "b1": launches["cli_train"]["fused_decode"],
            "b2": launches["cli_train"]["griffin_lim"],
            "eval_wavs": len(evals)}
        phase("cli_train", "%s (%s)" % (json.dumps(rows["cli_train"]), card))
        phase("cli_train", "losses %s" % [round(v, 4) for v in losses])
        train_ok = (len(losses) == train_steps
                    and all(np.isfinite(losses)) and losses[-1] < losses[0]
                    and len(evals) == 6
                    and sum(launches["cli_train"]["fused_decode"].values())
                    > 0 and sum(launches["cli_train"]["griffin_lim"]
                                .values()) > 0
                    and sum(b3.values()) > 0
                    and not any(k.endswith("_simple") for k in b3))
        if not train_ok:
            fail("cli_train: losses finite and falling, 6 eval wavs by B1 "
                 "and B2, B3 launched off its ragged route: %s"
                 % json.dumps(rows["cli_train"]))

        # -- resume ----------------------------------------------------------
        run_cli(repo, "train", common + [
            "--hparams", train_hp, "--checkpoint-dir",
            os.path.join(work, "ck_resume"), "--checkpoint", mid,
            "--max-steps", train_steps // 2 + 1,
            "--log-event-path", os.path.join(work, "log"),
            "--summary-json", os.path.join(work, "resume.json")])
        with open(os.path.join(work, "resume.json")) as f:
            rs = json.load(f)
        launches["cli_resume"] = cli_launches(rs)
        # the loader on the card: parameters and both Adam moments against
        # the file's arrays, bit for bit
        cfg, params = pkg["model_builder"].build_model(hp, en.n_vocab,
                                                       device=dev)
        from deepvoice3_pytorch_tpu_torch.training import trainer
        opt = trainer.make_optimizer(hp, trainer.make_lr_fn(hp))
        template = trainer.init_train_state(params, opt).opt_state
        _, opt_state, gstep, _ = ckpt.load_checkpoint(mid, params, template)
        blob = ckpt._load_blob(mid)
        names = [k for k, _ in ckpt.jax_order(ckpt.param_tree(params))]
        saved = {k: v for k, (_, v) in zip(
            names, ckpt.jax_order(blob["params"]))}
        n = len(names)
        mu = dict(zip(names, blob["opt_state"][1:1 + n]))
        nu = dict(zip(names, blob["opt_state"][1 + n:1 + 2 * n]))
        sd = params.state_dict()
        unequal = [k for k in names if not (
            np.array_equal(sd[k].cpu().numpy(), saved[k])
            and np.array_equal(opt_state.mu[k].cpu().numpy(), mu[k])
            and np.array_equal(opt_state.nu[k].cpu().numpy(), nu[k]))]
        on_card = all(t.device == dev for t in list(sd.values())
                      + list(opt_state.mu.values()))
        want = losses[train_steps // 2]
        got = rs["losses"][0] if rs["losses"] else float("nan")
        rel = abs(got - want) / abs(want)
        rows["cli_resume"] = {
            "step": rs["first_step"], "loss": got, "uninterrupted_loss": want,
            "rel": rel, "load_ms": rs["load_ms"],
            "loaded_step": gstep, "tensors_unequal": len(unequal),
            "on_card": on_card}
        phase("cli_resume", "%s (bars: step %d's loss 1e-5 relative to the "
              "uninterrupted run's, %d parameters and both Adam moments "
              "loaded on the card bit for bit) (%s)" % (
                  json.dumps(rows["cli_resume"]), train_steps // 2 + 1,
                  len(names), card))
        if unequal or not on_card or gstep != train_steps // 2:
            fail("cli_resume: the step-%d file did not load bit for bit "
                 "onto the card: %s" % (train_steps // 2, unequal[:5]))
        if not rel <= 1e-5:
            ok = False
            phase("cli_resume", "FAILED: the resumed step's loss is %.3g "
                  "relative from the uninterrupted run's" % rel)

        # -- synthesis -------------------------------------------------------
        text_file = os.path.join(work, "sentences.txt")
        with open(text_file, "w", encoding="utf-8") as f:
            f.write("\n".join(SENTENCES) + "\n")
        syn = os.path.join(work, "syn")
        syn_args = [last, text_file, syn, "--preset",
                    presets["deepvoice3_ljspeech"], "--hparams", hp_str]
        run_cli(repo, "synthesis", syn_args + [
            "--batch-size", 32, "--warmup", "--device", device,
            "--summary-json", os.path.join(work, "syn.json")])
        with open(os.path.join(work, "syn.json")) as f:
            sy = json.load(f)
        launches["cli_synthesis"] = cli_launches(sy)
        wavs = [p for p in os.listdir(syn) if p.endswith(".wav")]
        ckpt.load_checkpoint(last, params)
        ap = pkg["AudioProcessor"](hp)
        ref = pkg["synthesis"].tts_batch(params, cfg, ap, en, SENTENCES,
                                         max_decoder_steps=500)
        steps = sy["batches"][0]["decoded_steps"]
        b = sy["batches"][0]
        rows["cli_synthesis"] = {
            "wavs": len(wavs), "wall_ms": b["wall_ms"],
            "audio_s": b["audio_s"], "rtf": b["audio_s"] / b["wall_ms"] * 1e3,
            "decoded_steps_min_max": [min(steps), max(steps)],
            "in_process_steps_equal": steps == [
                r["num_decoder_steps"] for r in ref],
            "launches": launches["cli_synthesis"]}
        phase("cli_synthesis", "B=32: %s (%s)" % (
            json.dumps(rows["cli_synthesis"]), card))
        if len(wavs) != 32 or not rows["cli_synthesis"][
                "in_process_steps_equal"]:
            fail("cli_synthesis: 32 wavs whose decoded steps equal an "
                 "in-process tts_batch's on the same parameters")

        two = os.path.join(work, "two.txt")
        with open(two, "w", encoding="utf-8") as f:
            f.write("\n".join(SENTENCES[:2]) + "\n")
        t = time.time()
        run_cli(repo, "synthesis", [last, two, os.path.join(work, "cpu"),
                                    "--preset",
                                    presets["deepvoice3_ljspeech"],
                                    "--hparams", hp_str, "--batch-size", 2,
                                    "--device", "cpu", "--summary-json",
                                    os.path.join(work, "cpu.json")])
        cpu_s = time.time() - t
        with open(os.path.join(work, "cpu.json")) as f:
            cpu_steps = json.load(f)["batches"][0]["decoded_steps"]
        card_ref = pkg["synthesis"].tts_batch(params, cfg, ap, en,
                                              SENTENCES[:2],
                                              max_decoder_steps=500)
        from scipy.io import wavfile
        ratios = []
        for i, r in enumerate(card_ref):
            name = "%d_%s.wav" % (i, os.path.splitext(
                os.path.basename(last))[0])
            _, w_cpu = wavfile.read(os.path.join(work, "cpu", name))
            lin = (r["linear"] - ap.min_level_db) / -ap.min_level_db
            if len(w_cpu) == len(r["waveform"]):
                ratios.append(sc_gain(torch, ap, r["waveform"], lin)
                              / sc_gain(torch, ap, w_cpu, lin))
        card_steps = [r["num_decoder_steps"] for r in card_ref]
        rows["cli_synthesis_cpu"] = {
            "cpu_steps": cpu_steps, "card_steps": card_steps,
            "sc_ratio": ratios, "command_s": cpu_s}
        phase("cli_synthesis", "--device cpu on 2 sentences: %s (bars: "
              "decoded steps exact, spectral convergence of the card's "
              "audio within 1.05x the CPU's, each after its best gain)"
              % json.dumps(rows["cli_synthesis_cpu"]))
        if cpu_steps != card_steps or len(ratios) != 2 or \
                max(ratios) > 1.05:
            ok = False
            phase("cli_synthesis", "FAILED: the CPU run disagreed")

        one = os.path.join(work, "one.txt")
        with open(one, "w", encoding="utf-8") as f:
            f.write(SENTENCES[0] + "\n")
        run_cli(repo, "synthesis", [last, one, os.path.join(work, "stream"),
                                    "--preset",
                                    presets["deepvoice3_ljspeech"],
                                    "--hparams", hp_str, "--stream",
                                    "--warmup", "--device", device,
                                    "--summary-json",
                                    os.path.join(work, "stream.json")])
        with open(os.path.join(work, "stream.json")) as f:
            st = json.load(f)
        launches["cli_stream"] = cli_launches(st)
        rows["cli_stream"] = {
            "first_chunk_ms": [b["first_chunk_ms"] for b in st["batches"]],
            "wall_ms": [b["wall_ms"] for b in st["batches"]],
            "decoded_steps": [b["decoded_steps"] for b in st["batches"]],
            "launches": launches["cli_stream"]}
        phase("cli_synthesis", "--stream, one sentence: %s (%s)"
              % (json.dumps(rows["cli_stream"]), card))

        # -- serve -----------------------------------------------------------
        sv, launches["cli_serve"] = serve_cli(
            repo, last, presets["deepvoice3_ljspeech"], hp_str,
            SENTENCES[:3], device)
        rows["cli_serve"] = {"requests": sv, "launches": launches["cli_serve"]}
        phase("cli_serve", "cli.serve --slots 8, 3 requests one after "
              "another: %s (%s)" % (json.dumps(rows["cli_serve"]), card))
        if not all(r["status"] == 200 and r["wav_header"] and r["pcm_even"]
                   and r["pcm_samples"] > 0 for r in sv):
            fail("cli_serve: a request did not get 200 with a WAV header "
                 "and PCM")

        # -- the other builders ----------------------------------------------
        vctk_corpus = os.path.join(work, "vctk")
        hp_v = preset_hparams(hparams, repo, "deepvoice3_vctk")
        hp_v.parse(extra_hp)
        write_corpus(torch, pkg, hp_v, vctk_corpus, dev,
                     speakers=hp_v.n_speakers)
        for label, preset, data, spk in (
                ("nyanko", "nyanko_ljspeech", corpus, None),
                ("vctk", "deepvoice3_vctk", vctk_corpus, 7)):
            d = os.path.join(work, label)
            b_hp = ",".join(s for s in ("checkpoint_interval=100000,"
                                        "eval_interval=100000", extra_hp)
                            if s)
            run_cli(repo, "train", [
                "--preset", presets[preset], "--device", device,
                "--data-root", data, "--hparams", b_hp,
                "--checkpoint-dir", os.path.join(d, "ck"),
                "--max-steps", builder_steps,
                "--log-event-path", os.path.join(work, "log"),
                "--summary-json", os.path.join(d, "train.json")])
            with open(os.path.join(d, "train.json")) as f:
                bt = json.load(f)
            eight = os.path.join(d, "eight.txt")
            with open(eight, "w", encoding="utf-8") as f:
                f.write("\n".join(SENTENCES[:8]) + "\n")
            extra = [] if spk is None else ["--speaker_id", spk]
            run_cli(repo, "synthesis", [
                ckpt.checkpoint_path(os.path.join(d, "ck"), builder_steps),
                eight, os.path.join(d, "syn"), "--preset", presets[preset],
                "--hparams", b_hp, "--batch-size", 8, "--device", device,
                "--summary-json", os.path.join(d, "syn.json")] + extra)
            with open(os.path.join(d, "syn.json")) as f:
                bs = json.load(f)
            n_wavs = len([p for p in os.listdir(os.path.join(d, "syn"))
                          if p.endswith(".wav")])
            launches["cli_train_" + label] = cli_launches(bt)
            launches["cli_synthesis_" + label] = cli_launches(bs)
            rows["cli_" + label] = {
                "losses": bt["losses"],
                "steady_steps_per_s": bt.get("steady_steps_per_s"),
                "b3_by_route": launches["cli_train_" + label]["conv_taps"],
                "wavs": n_wavs, "synthesis_wall_ms":
                bs["batches"][0]["wall_ms"],
                "decoded_steps": bs["batches"][0]["decoded_steps"],
                "synthesis_launches": launches["cli_synthesis_" + label]}
            phase("cli_builders", "%s: %d steps and 8 sentences%s: %s (%s)"
                  % (label, builder_steps, "" if spk is None
                     else " as speaker %d" % spk,
                     json.dumps(rows["cli_" + label]), card))
            if len(bt["losses"]) != builder_steps or \
                    not all(np.isfinite(bt["losses"])) or n_wavs != 8:
                fail("cli_builders: %s: finite losses and 8 wavs" % label)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return ok, rows, launches


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Smoke run of the port on one "
                                             "GPU.")
    ap.add_argument("--json-out", default=None,
                    help="also write the B3 and training numbers, in full, "
                         "to this JSON file")
    ap.add_argument("--b1-turns", default=None, metavar="PARENT_DIR",
                    help="only time B1's launch alone at its five shapes "
                         "here and in PARENT_DIR, in turns")
    ap.add_argument("--b1-only", action="store_true",
                    help="only build the kernels and run B1's phases (B1, "
                         "B1_nyanko, B1_vctk, B1_b1, B1_serve)")
    ap.add_argument("--b3-turns", default=None, metavar="PARENT_DIR",
                    help="only time phase B3's per-step sums here and in "
                         "PARENT_DIR, in turns")
    ap.add_argument("--b3-only", action="store_true",
                    help="only build the kernels and run phase B3")
    ap.add_argument("--b2-turns", default=None, metavar="PARENT_DIR",
                    help="only time B2 at its five calls here and in "
                         "PARENT_DIR, in turns")
    ap.add_argument("--b2-only", action="store_true",
                    help="only build the kernels and run B2's phases (B2, "
                         "its windows and anchored start, P)")
    ap.add_argument("--cli-only", action="store_true",
                    help="only build the kernels and run the command "
                         "lines' phases (cli_*)")
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
    from deepvoice3_pytorch_tpu_torch.cli import (  # noqa: F401
        compute_timestamp_ratio, convert_checkpoint, dump_hparams_to_json)
    from deepvoice3_pytorch_tpu_torch.cli import serve as cli_serve  # noqa
    from deepvoice3_pytorch_tpu_torch.cli import synthesis as cli_syn  # noqa
    from deepvoice3_pytorch_tpu_torch.cli import train as cli_train  # noqa

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
    if args.b2_turns:
        b2_turns(os.path.abspath(args.b2_turns), card, json_out)
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
        if args.b1_only:
            b1_ok_all, b1_rows, b1s = b1_phases(
                torch, pkg, {"B1": hp, "B1_nyanko": preset_hparams(
                    hparams, repo, "nyanko_ljspeech"),
                    "B1_vctk": preset_hparams(hparams, repo,
                                              "deepvoice3_vctk")},
                dev, seed, card)
            if json_out:
                os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                            exist_ok=True)
                with open(json_out, "w") as f:
                    json.dump({"card": card, "b1": b1_rows,
                               "b1_serve": b1s}, f, indent=1, default=str)
            if not b1_ok_all:
                fail("a B1 phase missed its bar")
            return
        if args.b2_only:
            b2_ok_all, b2_rows = b2_phases(torch, pkg, hp, dev, seed, repo,
                                           card)
            if json_out:
                os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                            exist_ok=True)
                with open(json_out, "w") as f:
                    json.dump({"card": card, "b2": b2_rows}, f, indent=1,
                              default=str)
            if not b2_ok_all:
                fail("a B2 phase missed its bar")
            return
        if args.cli_only:
            cli_ok, cli_rows, cli_l = cli_phases(torch, pkg, repo, card, dev)
            phase("cli", "kernel launches on the command lines' paths: %s"
                  % json.dumps(cli_totals(cli_l)))
            if json_out:
                os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                            exist_ok=True)
                with open(json_out, "w") as f:
                    json.dump({"card": card, "cli": cli_rows,
                               "cli_launches": cli_l}, f, indent=1,
                              default=str)
            if not cli_ok:
                fail("a command line's phase missed its bar")
            return
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
        b1_ok_all, b1_rows, b1s = b1_phases(torch, pkg, presets, dev, seed,
                                            card)
        ok &= b1_ok_all
        b1_err = max([r["err"] for r in b1_rows.values()] + [b1s["err"]])
        b1_ms, b1_plain_ms = b1_rows["B1"]["ms"], b1_rows["B1"]["plain_ms"]
        b1_launch_ms = b1_rows["B1"]["launch_ms"]

        b2_ok_all, b2_rows = b2_phases(torch, pkg, hp, dev, seed, repo, card)
        ok &= b2_ok_all
        b2, b2_windows, b2s = (b2_rows[k] for k in ("b2", "b2_windows",
                                                    "b2s"))
        anchored, p_row, p_launches = (b2_rows[k] for k in (
            "anchored", "p", "p_launches"))

        # tts_batch of the LJSpeech structure keeps its bar of 0.12 of the
        # peak sample by sample; the other two builders, and every stream,
        # are held to the spectral convergence of their audio, 1.05x the
        # CPU's: a tiny random nyanko makes nearly flat spectra, on which
        # two bf16 Griffin-Lim schedules part by more sample by sample, and
        # a stream chains 32 bf16 iterations a window through its pinned
        # context, where Griffin-Lim's own plain version run on the card
        # parts from the CPU by 0.310 of the peak (PERF.md, §6)
        sc_bar = "spectral convergence 1.05x the CPU's"
        for bname in ("deepvoice3", "nyanko", "deepvoice3_multispeaker"):
            suffix = "" if bname == "deepvoice3" else "_" + bname
            audio_bar = ("waveform 0.12 of peak" if bname == "deepvoice3"
                         else sc_bar)
            worst = check_small_reference(torch, pkg, dev, bname)
            ref_ok = (worst["steps"] == 0
                      and max(worst["mel"], worst["linear"],
                              worst["alignment"]) <= 1e-4
                      and (worst["wave_rel"] < 0.12 if bname == "deepvoice3"
                           else worst["sc_ratio"] <= 1.05))
            phase("reference" + suffix, "tiny %s model, GPU kernels vs CPU "
                  "plain: %s (bars: steps exact, features 1e-4, %s)"
                  % (bname, json.dumps(worst), audio_bar))
            ok &= ref_ok
            worst_s = check_small_stream(torch, pkg, dev, bname)
            stream_ref_ok = (worst_s["steps"] == 0 and not worst_s["chunks"]
                             and worst_s["linear"] <= 1e-4
                             and worst_s["sc_ratio"] <= 1.05)
            phase("stream_reference" + suffix, "tiny %s model tts_stream, "
                  "GPU kernels vs CPU plain: %s (bars: decoded steps and "
                  "chunk sizes exact, linear frames 1e-4, %s; wave_rel%s "
                  "are figures, not bars)"
                  % (bname, json.dumps(worst_s), sc_bar,
                     " and plain_wave_rel (the plain Griffin-Lim on the GPU "
                     "against the CPU)" if "plain_wave_rel" in worst_s
                     else ""))
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
        phase("tts_batch", "kernel launches on the main path: %s; B2 by "
              "route %s" % (json.dumps(launches),
                            json.dumps(gl_cuda.KERNEL.by_route)))
        if min(launches.values()) <= 0 or conv_cuda.KERNEL.launches:
            fail("a kernel of the main path was not launched, or B3 was")
        if gl_cuda.KERNEL.by_route.get("batch", 0) <= 0:
            fail("tts_batch did not take B2's batch route")
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
        phase("stream", "B=1 decode set-up split (host ms, synchronised "
              "after each, least of 5; the lookup and the fold are parts "
              "of decoder_init): %s" % json.dumps(st_rows["setup_split"]))
        if st_rows["setup_split"]["plan_builds_in_3_streams"]:
            fail("the stream rebuilt B1's packed plan")
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
                or st_launches["conv_taps"] or \
                set(st_launches["griffin_lim_by_route"]) != {"window"}:
            fail("the stream did not launch B1 and B2's pinned mode on B2's "
                 "window route, or it launched B3")
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
        for key in ("requests", "requests_second_round"):
            hop_med = {}
            for h in serve.HOPS + ("first_bytes",):
                vals = sorted(
                    r["ttfa_ms"] if h == "first_bytes" else r["hops_ms"][h]
                    for r in slot_rows[key]
                    if h == "first_bytes" or r["hops_ms"][h] is not None)
                hop_med[h] = vals[len(vals) // 2] if vals else None
            slot_rows["hops_median_ms_" + key] = hop_med
            phase("serve_slots", "%s: per request, ms from the client's "
                  "send to each hop (median of 8): %s (%s)" % (
                      "each client thread's first request"
                      if key == "requests" else "the second round",
                      json.dumps(hop_med), card))
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

        cli_ok, cli_rows, cli_l = cli_phases(torch, pkg, repo, card, dev)
        cli = cli_totals(cli_l)
        phase("cli", "kernel launches on the command lines' paths: %s"
              % json.dumps(cli))
        if not cli_ok:
            fail("a command line's phase missed its bar")
        if json_out:
            os.makedirs(os.path.dirname(os.path.abspath(json_out)),
                        exist_ok=True)
            with open(json_out, "w") as f:
                json.dump({"card": card, "train": train_rows,
                           "b3": {"%d_%s" % k: v for k, v in b3.items()},
                           "b3_extra": b3_extra,
                           "b2": b2, "b2_windows": b2_windows,
                           "b2_anchored": anchored, "p": p_row,
                           "stream": st_rows,
                           "serve": sv_rows, "b1": b1_rows,
                           "b1_serve": b1s, "cb": cb_rows,
                           "presets": preset_rows, "cli": cli_rows,
                           "cli_launches": cli_l}, f, indent=1,
                          default=str)

    b1_bound = b1_rows["B1"]["bound"]

    print(json.dumps({"kernels": [
        {"name": "fused_decode", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/fused_decode.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/fused_decode.py:198",
         "launches": sum(b1_paths.values()) + sum(b1_slots.values())
         + cli["fused_decode"] + cli["fused_decode_slots"],
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain_ms,
         "bound_ms": b1_bound[0], "bound_by": b1_bound[1],
         "library_ms": None, "timing": "host-paced",
         "launch_ms": b1_launch_ms},
        {"name": "fused_decode_slots", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/fused_decode.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/fused_decode.py:198",
         "launches": sum(b1_slots.values()) + cli["fused_decode_slots"],
         "max_abs_err": b1s["err"],
         "ms": b1s["ms"], "plain_ms": b1s["plain_ms"],
         "bound_ms": b1s["bound"][0], "bound_by": b1s["bound"][1],
         "library_ms": None, "timing": "host-paced",
         "launch_ms": b1s["ms"]},
        {"name": "griffin_lim", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "deepvoice3_pytorch_tpu/dsp/gl_pallas.py:146",
         "launches": launches["griffin_lim"] + cli["griffin_lim"],
         "max_abs_err": b2["err"],
         "ms": b2["cuda_ms"], "plain_ms": b2["plain_ms"],
         "bound_ms": b2["bound"][0], "bound_by": b2["bound"][1],
         "library_ms": None, "timing": "host-paced",
         "gemm_library_ms": b2["gemm_library_ms"]},
        {"name": "griffin_lim_stream", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "deepvoice3_pytorch_tpu/dsp/gl_pallas.py:146",
         "launches": st_launches["griffin_lim_stream"] + sum(
             v["griffin_lim"] for v in cb_launches.values())
         + cli["griffin_lim_stream"],
         "max_abs_err": b2s["err"], "ms": b2s["cuda_ms"],
         "plain_ms": b2s["plain_ms"], "bound_ms": b2s["bound"][0],
         "bound_by": b2s["bound"][1], "library_ms": None,
         "timing": "host-paced",
         "gemm_library_ms": b2s["gemm_library_ms"]},
        {"name": "griffin_lim_unfolded", "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/griffin_lim.cu",
         "replaces": "tools/gl_pallas2_probe.py:53",
         "launches": p_launches, "max_abs_err": p_row["err"],
         "ms": p_row["ms"], "plain_ms": p_row["plain_ms"],
         "bound_ms": p_row["bound"][0], "bound_by": p_row["bound"][1],
         "library_ms": None, "timing": "host-paced",
         "gemm_library_ms": p_row["gemm_library_ms"]},
    ] + [
        {"name": "conv_taps_%s_%s" % (entry, route), "route": "cuda",
         "source": "deepvoice3_pytorch_tpu_torch/csrc/conv_taps.cu",
         "replaces": "deepvoice3_pytorch_tpu/ops/conv_pallas.py:%d" % line,
         "launches": b3_launches.get("%s_%s" % (entry, route), 0)
         + cli["conv_taps"].get("%s_%s" % (entry, route), 0),
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
