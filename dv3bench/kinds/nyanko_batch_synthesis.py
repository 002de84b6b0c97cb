# coding: utf-8
"""Traffic kind `nyanko_batch_synthesis`: offline batch synthesis with the
nyanko voice (DCTTS) through `synthesis.tts_batch`, a closed loop of calls
back to back over the generator's batches, cycled, as `batch_synthesis`
runs DeepVoice3: the same window, pass rule, trace and judged calls, with
nyanko's configuration, seeded weights and reference
(reference/nyanko.py, reference/nyanko_synthesis.py).

Set-up makes the weights, the batches and the audio processor, and calls
every batch once (every shape the window will use), holding each call's
results until the next call has returned, as the window does: so the
page-locked slabs a steady window holds at once are made in set-up, not in
the window's first pass (the traced pass is that first pass)."""

import gc
import time

import torch

from .. import generate
from ..reference import nyanko as ref_nyanko
from ..reference import nyanko_synthesis as ref_synthesis
from ..reference import text as ref_text
from . import common
from .batch_synthesis import _call_shape


def configs(hp):
    """(port hparams, port model config, reference model config)."""
    from deepvoice3_pytorch_tpu_torch import model_builder
    from deepvoice3_pytorch_tpu_torch.frontend import en

    php = common.port_hparams(hp)
    return (php, model_builder.build_config(php, en.n_vocab),
            ref_nyanko.config_from_hparams(hp, ref_text.N_VOCAB))


def weights(cfg_ref, seed, device, done_bias=None):
    """The seeded weights, made anew on every call."""
    return ref_nyanko.seeded_tree(cfg_ref, common.weight_seed(seed), device,
                                  done_bias=done_bias)


def run(hp, traffic, seed, seconds, trace, device, window_started,
        control=False, call_fault=None):
    """control: also read the control on the kept calls (control.py);
    call_fault: wraps the port's tts_batch (the tests plant faults there)."""
    from deepvoice3_pytorch_tpu_torch import synthesis
    from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
    from deepvoice3_pytorch_tpu_torch.frontend import en

    php, cfg_p, cfg_r = configs(hp)
    params = common.port_params(weights(cfg_r, seed, device,
                                        traffic["done_bias"]))
    ap = AudioProcessor(php)
    batches = generate.synthesis_batches(traffic, seed, hp)
    keep_at = generate.sampled_calls(seed, len(batches),
                                     traffic["sample_calls"])

    tts_batch = synthesis.tts_batch if call_fault is None \
        else call_fault(synthesis.tts_batch)

    def call(i):
        texts, spk, steps = batches[i % len(batches)]
        return tts_batch(params, cfg_p, ap, en, texts, speaker_ids=spk,
                         max_decoder_steps=steps, early_exit=False)

    res = None
    for i in range(len(batches)):           # every shape, once
        res = call(i)                       # the last results held meanwhile
    common.synchronize(device)
    del res
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    gc.collect()
    window_started()

    kept, audio_s, n_calls, n_utts, passes = {}, 0.0, 0, 0, []

    def window(n_max=None):
        nonlocal audio_s, n_calls, n_utts
        t0 = time.perf_counter()
        while True:
            res = call(n_calls)
            audio_s += sum(len(r["waveform"]) for r in res) / hp["sample_rate"]
            n_utts += len(res)
            if n_calls in keep_at:
                kept[n_calls] = res
            n_calls += 1
            if n_calls % len(batches) == 0:
                passes.append(time.perf_counter() - t0)
            if n_max is not None:
                if n_calls >= n_max:
                    break
            elif (time.perf_counter() - t0 >= seconds
                  and n_calls % len(batches) == 0):
                break               # whole passes over the batches
        common.synchronize(device)
        return time.perf_counter() - t0

    out = {}
    if trace:
        from .. import trace as trace_lib
        _, tr = trace_lib.profiled(
            torch, lambda: window(traffic["trace_calls"]),
            cuda=torch.device(device).type == "cuda")
        work = [batches[i % len(batches)] for i in range(n_calls)]
        out["trace"] = {"kind": "batch", "trace": tr, "cfg": cfg_r, "hp": hp,
                        "calls": [_call_shape(b) for b in work]}
    else:
        window_s = window()
        out["metrics"] = {"synth_rtf": audio_s / window_s}
    out["memory_peak"] = common.memory_peak(device)
    out["attempted"] = n_utts

    del params, ap
    common.free(device)
    tree = weights(cfg_r, seed, device, traffic["done_bias"])
    readings, controls = [], []
    for i, res in sorted(kept.items()):
        texts, spk, steps = batches[i % len(batches)]
        readings.append(ref_synthesis.judge_call(
            tree, cfg_r, hp, texts, spk, steps, res, device))
        if control:
            controls.append(ref_synthesis.control(
                tree, cfg_r, hp, texts, spk, steps, res, device))
    numbers = ref_synthesis.worst(readings)
    if control:
        out["control_numbers"] = ref_synthesis.worst(controls)
        out["control_numbers"].pop("windows_followed", None)
    out["notes"] = {"windows_followed": numbers.pop("windows_followed", 0),
                    "judged_calls": sorted(kept),
                    "pass_s": [b - a for a, b in zip([0.0] + passes, passes)]}
    out["numbers"] = numbers
    return out
