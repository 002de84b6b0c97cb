#!/usr/bin/env python
# coding: utf-8
"""Kernel B1 on the card: where its launches spend their time by stage
kind over one pass of a benchmark cell's batches, its registers, and its
outputs for a bit-for-bit comparison between two checkouts.

Run from the root of a checkout (the package imported is that checkout's,
so an earlier commit unpacked with `git archive` is measured the same
way):

    python3 tools/b1_probe.py [--seed N] [--json-out PATH] [--batches N]
        [--device cuda|cpu] [--outputs PATH] [--steps N] [--split 0|1]
    python3 tools/b1_probe.py --compare A.pt B.pt

Split (--split 1, the default): for each of the cells
`dv3_ljspeech.batch32` and `nyanko_ljspeech.batch32` it builds the
preset's model at full width (seeded weights), makes the cell's 16
batches of 32 from its traffic file (`dv3bench/generate.py`), synthesises
them once to build and warm every shape, then once more inside
`profiling.recording()`, and folds every B1 launch's stamps (block 0's
globaltimer) itself, so that a checkout older than the products split of
`profiling.fold_b1_stamps_by_kind` reads the same: for each stage of
each step, its products (the barrier before it passed -> its first part
done: an MV stage's products, an ATT stage's scores), its epilogue (->
its work done) and the barrier wait after it, summed by the stage's
kind. Prints one JSON line (and
writes it to --json-out): nvcc's -Xptxas -v report on fused_decode_kernel,
and per cell and kind the summed ns, the stage-steps and the us a
stage-step of each part, the launches' total, and the window's counters.

On the card it then profiles one more pass (`dv3bench/trace.py`, as a
`--trace 1` run does) and reports, per cell, B1's device seconds and
launches in it and the device idle between consecutive B1 launches of
one decode (`between_b1`: every gap from a launch's end to the next
launch's start, less the kernels that ran inside it; the launches split
into decodes by each batch's ceil(N / 32)), and the idle time that
`dv3bench/spans.py` gives to the decode's spans (`idle_by_span_s`).

--outputs PATH: B1's chunk mode at the LJSpeech, VCTK and nyanko presets'
full widths (B = 32, Tk = 96, --steps steps, 64 by default: two launches
of 32; seeded weights, keys and values) saved to PATH (frames,
alignments, done, decoder states, last_attended). --compare A B: whether
two such files hold the same numbers bit for bit.

On the CPU (--device cpu, for a dry run with few --batches) B1 runs its
plain version and writes no stamps.
"""

import argparse
import json
import os
import sys

import numpy as np

CELLS = {"dv3_ljspeech.batch32": ("dv3_ljspeech", "ljspeech_batch32"),
         "nyanko_ljspeech.batch32": ("nyanko_ljspeech", "nyanko_batch32")}
PRESETS = ("deepvoice3_ljspeech", "deepvoice3_vctk", "nyanko_ljspeech")
OUTPUTS = ("outputs", "alignments", "done", "decoder_states",
           "last_attended")


def fold(stamps):
    """{kind: {products_ns, epilogue_ns, barrier_ns, stage_steps}} and the
    launch total (ns) of the window's B1 stamps, each entry (buffer, steps,
    stages, kinds)."""
    out, launch_ns = {}, 0
    for buf, steps, n_stages, *kinds in stamps:
        kinds = kinds[0] if kinds else None
        t = buf.cpu().numpy().astype(np.int64)
        if t.shape != (2 + 3 * steps * n_stages,) or (np.diff(t) < 0).any():
            continue
        passed = np.concatenate([t[1:2], t[4::3]])
        parts = {"products_ns": t[2::3] - passed[:-1],
                 "epilogue_ns": t[3::3] - t[2::3],
                 "barrier_ns": t[4::3] - t[3::3]}
        launch_ns += int(t[-1] - t[0])
        for s in range(n_stages):
            kind = kinds[s] if kinds else "all"
            acc = out.setdefault(kind, dict(products_ns=0, epilogue_ns=0,
                                            barrier_ns=0, stage_steps=0))
            for k, v in parts.items():
                acc[k] += int(v.reshape(steps, n_stages)[:, s].sum())
            acc["stage_steps"] += steps
    for acc in out.values():
        for k in ("products", "epilogue", "barrier"):
            acc[k + "_us"] = round(acc[k + "_ns"] / 1e3 / acc["stage_steps"],
                                   4)
    return out, launch_ns


def _covered(intervals, a, b):
    """Seconds of [a, b] (µs) that the union of intervals [(s, t)] covers."""
    out, end = 0.0, a
    for s, t in sorted(intervals):
        s, t = max(s, end), min(t, b)
        if t > s:
            out += t - s
            end = t
    return out / 1e6


def between_launches(tr, decodes):
    """The device idle between consecutive B1 launches of one decode in
    trace `tr`; decodes: the launches of each decode, in order. None when
    the trace's B1 launches do not add up to them."""
    from dv3bench.kernels import b1

    launches = sorted((s, t) for n, s, t in tr.device
                      if b1.PATTERN.search(n))
    if len(launches) != sum(decodes):
        return None
    kernels = [(s, t) for _, s, t in tr.kernels()]
    gaps, other, i = [], 0.0, 0
    for n in decodes:
        for (_, end), (start, _) in zip(launches[i:i + n - 1],
                                        launches[i + 1:i + n]):
            inside = [(s, t) for s, t in kernels if t > end and s < start]
            busy = _covered(inside, end, start)
            gaps.append(max(0.0, (start - end) / 1e6 - busy))
            other += busy
        i += n
    if not gaps:
        return {"gaps": 0}
    us = sorted(g * 1e6 for g in gaps)
    return {"gaps": len(gaps), "idle_s": sum(gaps),
            "mean_us": sum(us) / len(us), "median_us": us[len(us) // 2],
            "max_us": us[-1], "other_kernels_s": other}


def traced_pass(torch, one_pass, decodes):
    """One more pass under the profiler: B1's device time and launches,
    the idle between its launches within a decode, and the idle that
    dv3bench/spans.py gives to the decode's spans."""
    from dv3bench import spans, trace
    from dv3bench.kernels import b1

    from deepvoice3_pytorch_tpu_torch.utils import profiling

    _, tr = trace.profiled(torch, one_pass)
    b1_s, b1_n = tr.device_seconds(lambda n: bool(b1.PATTERN.search(n)))
    out = {"window_s": tr.window_s, "kernel_busy_s": tr.kernel_busy_s,
           "b1_s": b1_s, "b1_launches": b1_n,
           "between_b1": between_launches(tr, decodes)}
    w = profiling.recorded()
    roots = [s for s in w.spans if s.parent < 0 and s.name == spans.CALL]
    r = spans.reading({"kind": "batch", "trace": tr, "calls": [
        tuple(s.attrs.get(k) for k in ("rows", "text_padded", "steps_asked"))
        for s in roots]})
    out["idle_by_span_s"] = None if r is None else {
        k: r["idle_s"].get(k, 0.0)
        for k in ("dv3.decode", "dv3.decode.prepare", "dv3.decode.chunk")}
    return out


def ptxas_lines(log):
    """nvcc's -Xptxas -v lines about fused_decode_kernel: its registers,
    stack frame and spills."""
    lines, keep = [], False
    for ln in log.splitlines():
        if "Compiling entry function" in ln or "Function properties" in ln:
            keep = "fused_decode_kernel" in ln
        if keep:
            lines.append(ln.strip())
    return lines


def port_hparams(repo, name):
    from deepvoice3_pytorch_tpu_torch import hparams

    hp = hparams.default_hparams()
    with open(os.path.join(repo, name)) as f:
        values = json.load(f)
    known = hp.values()
    hp.override_from_dict({k: v for k, v in values.items() if k in known})
    return hp, values


def cell_split(torch, repo, cell, seed, dev, n_batches=None):
    from dv3bench import generate

    from deepvoice3_pytorch_tpu_torch import model_builder, synthesis
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en
    from deepvoice3_pytorch_tpu_torch.utils import profiling

    config, traffic_name = CELLS[cell]
    hp, hp_cell = port_hparams(repo, os.path.join(
        "dv3bench", "configs", config + ".json"))
    with open(os.path.join(repo, "dv3bench", "traffic",
                           traffic_name + ".json")) as f:
        traffic = json.load(f)
    cfg, params = model_builder.build_model(hp, en.n_vocab, seed=seed,
                                            device=dev)
    ap = AudioProcessor(hp)
    batches = generate.synthesis_batches(traffic, seed, hp_cell)[:n_batches]

    def one_pass():
        for texts, spk, steps in batches:
            synthesis.tts_batch(params, cfg, ap, en, texts, speaker_ids=spk,
                                max_decoder_steps=steps, early_exit=False)
        if dev.type == "cuda":
            torch.cuda.synchronize()

    one_pass()
    with profiling.recording() as w:
        one_pass()
    kinds, launch_ns = fold(w.stamps)
    out = {"kinds": kinds, "launch_ns": launch_ns,
           "launches": len(w.stamps), "counters": w.counters()}
    if dev.type == "cuda":
        from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

        out["traced"] = traced_pass(torch, one_pass, [
            -(-steps // fd.DEFAULT_CHUNK) for _, _, steps in batches])
    return out


def preset_outputs(torch, repo, preset, seed, dev, B=32, Tk=96, steps=64):
    """B1's chunk mode at a preset's full width: its outputs on the CPU."""
    from deepvoice3_pytorch_tpu_torch import builder, model_builder
    from deepvoice3_pytorch_tpu_torch.ops import core
    from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

    hp, _ = port_hparams(repo, os.path.join("presets", preset + ".json"))
    cfg, params = model_builder.build_model(hp, 149, seed=seed, device=dev)
    g = torch.Generator().manual_seed(seed + 1)
    width = (cfg.decoder.channels if cfg.builder == "nyanko"
             else cfg.decoder.embed_dim)
    enc = tuple(torch.randn(B, Tk, width, generator=g).to(dev) * 0.5
                for _ in range(2))
    lengths = torch.randint(Tk // 2, Tk + 1, (B,), generator=g).to(dev)
    pos = torch.arange(1, Tk + 1, device=dev)[None].repeat(B, 1)
    pos = torch.where(pos <= lengths[:, None], pos, torch.zeros_like(pos))
    se = (builder.embed_speakers(params, cfg, (7 * torch.arange(
        B, device=dev)) % cfg.n_speakers) if cfg.n_speakers > 1 else None)
    dc = cfg.decoder
    fi = cfg.family.fused_decode_inputs(params["decoder"], dc, enc, pos,
                                        steps, speaker_embed=se)
    out = fd.fused_decode(params["decoder"], dc, fi,
                          core.get_mask_from_lengths(lengths, Tk),
                          torch.zeros(B, dc.in_dim * dc.r, device=dev),
                          steps, 2, early_exit=False, chunk=32)
    return {name: getattr(out, name).cpu() for name in OUTPUTS}


def compare(a, b):
    import torch

    x, y = torch.load(a), torch.load(b)
    out = {}
    for preset in sorted(set(x) | set(y)):
        both = preset in x and preset in y
        out[preset] = {name: both and torch.equal(x[preset][name],
                                                  y[preset][name])
                       for name in OUTPUTS}
    print(json.dumps({"bit_equal": out}), flush=True)


def main():
    pa = argparse.ArgumentParser()
    pa.add_argument("--seed", type=int, default=3100000211)
    pa.add_argument("--json-out", default=None)
    pa.add_argument("--batches", type=int, default=None)
    pa.add_argument("--device", default="cuda")
    pa.add_argument("--outputs", default=None)
    pa.add_argument("--steps", type=int, default=64)
    pa.add_argument("--split", type=int, default=1)
    pa.add_argument("--compare", nargs=2, default=None)
    args = pa.parse_args()
    repo = os.getcwd()
    sys.path.insert(0, repo)
    if args.compare:
        compare(*args.compare)
        return
    import torch

    dev = torch.device(args.device)
    out = {"tree": repo, "seed": args.seed,
           "card": torch.cuda.get_device_name(0) if dev.type == "cuda"
           else "cpu"}
    if dev.type == "cuda":
        from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd

        fd.KERNEL.lib                       # build: ptxas's report
        out["ptxas"] = ptxas_lines(fd.KERNEL.build_log)
    if args.outputs:
        torch.save({p: preset_outputs(torch, repo, p, 3, dev,
                                      steps=args.steps)
                    for p in PRESETS}, args.outputs)
    if args.split:
        for cell in CELLS:
            out[cell] = cell_split(torch, repo, cell, args.seed, dev,
                                   args.batches)
    line = json.dumps(out)
    print(line, flush=True)
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)),
                    exist_ok=True)
        with open(args.json_out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
