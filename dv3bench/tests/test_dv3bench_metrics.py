# coding: utf-8
"""The end-to-end metrics are rates over the whole window and all its
work, so a stall anywhere in it moves them; the per-layer readers'
arithmetic on a known trace."""

import time

import pytest

from conftest import small_traffic, tiny_hp
from dv3bench import bench, counts, peaks, trace
from dv3bench.kinds import batch_synthesis, train_step
from dv3bench.kernels import b1, b2, b3
from dv3bench.reference import builder, text


def _stall_once(after):
    def wrap(fn):
        n = [0]

        def call(*a, **kw):
            n[0] += 1
            if n[0] == after:
                time.sleep(1.5)
            return fn(*a, **kw)
        return call
    return wrap


def test_a_stall_moves_synth_rtf():
    hp, tr = tiny_hp("dv3_ljspeech"), small_traffic("ljspeech_batch32")
    n_batches = tr["pool"] // tr["batch"]
    runs = [batch_synthesis.run(hp, tr, 9, 0.5, 0, "cpu", lambda: None,
                                call_fault=fault)["metrics"]["synth_rtf"]
            for fault in (None, _stall_once(n_batches + 2))]
    assert runs[1] < 0.8 * runs[0], runs


def test_a_stall_moves_train_step_ms():
    hp, tr = tiny_hp("dv3_vctk"), small_traffic("vctk_train16")
    runs = [train_step.run(hp, tr, 9, 0.5, 0, "cpu", lambda: None,
                           step_fault=fault)["metrics"]["train_step_ms"]
            for fault in (None, _stall_once(tr["pool_batches"] + 2))]
    assert runs[1] > runs[0] + 1500 / 12, runs


def FakeTrace(events, window_s):
    """A trace of the given device events (name, start µs, end µs)."""
    return trace.Trace(events, [], window_s)


def _cfg(config):
    hp = bench.load_json(bench.HERE / "configs" / (config + ".json"))
    return hp, builder.config_from_hparams(hp, text.N_VOCAB)


def test_batch_readers_on_a_known_trace():
    hp, cfg = _cfg("dv3_ljspeech")
    calls = [(32, 96, 100, [90] * 32)]
    ev = [("(anonymous namespace)::fused_decode_kernel(B1Args)", 0, 20000),
          ("void (anonymous namespace)::gemm_batch<256, 0>(CUtensorMap_st)",
           20000, 25000),
          ("sm80_xmma_fprop_implicit_gemm", 25000, 30000),
          ("Memcpy DtoH (Device -> Pageable)", 30000, 40000)]
    ctx = {"kind": "batch", "trace": FakeTrace(ev, 0.05), "cfg": cfg,
           "hp": hp, "calls": calls}
    least = peaks.bound_s(*b1.work(cfg, 32, 96, 100, [90] * 32), "float32")
    assert bench.load_metric("b1_roofline.batch")(ctx) == \
        pytest.approx(100 * least / 0.02)
    least = peaks.bound_s(*b2.work(hp, 32, 400), "bfloat16")
    assert bench.load_metric("b2_roofline.batch")(ctx) == \
        pytest.approx(100 * least / 0.005)
    # the copy keeps the device busy but no kernel runs through it
    assert ctx["trace"].busy_s == pytest.approx(0.04)
    assert bench.load_metric("device.idle.batch")(ctx) == pytest.approx(40.0)
    at_peak = sum(f / peaks.FLOPS[p] for p, f in counts.synthesis_flops(
        cfg, hp, 32, 96, 100, [90] * 32).items())
    assert bench.load_metric("synth.mfu")(ctx) == \
        pytest.approx(100 * at_peak / 0.05)
    for name in ("train.mfu", "b3_roofline.train", "device.idle.train",
                 "train.launches_per_step"):
        assert bench.load_metric(name)(ctx) is None


def test_train_readers_on_a_known_trace():
    hp, cfg = _cfg("dv3_vctk")
    steps = [(64, 128, 192)] * 2
    ev = [("(anonymous namespace)::fwd_f32_pipe(float const*)", 0, 30000),
          ("(anonymous namespace)::wgrad_f32_pipe(float const*)", 30000,
           40000),
          ("elementwise_kernel", 40000, 60000)]
    ctx = {"kind": "train", "trace": FakeTrace(ev, 0.2), "cfg": cfg,
           "hp": hp, "steps": steps, "trained": lambda k: True}
    least = 2 * peaks.bound_s(*b3.work(cfg, 64, 128, 192), "float32")
    assert bench.load_metric("b3_roofline.train")(ctx) == \
        pytest.approx(100 * least / 0.04)
    assert bench.load_metric("train.launches_per_step")(ctx) == 1.5
    assert bench.load_metric("device.idle.train")(ctx) == pytest.approx(70.0)
    flops = 2 * counts.train_step_flops(cfg, 64, 128, 192, lambda k: True)
    assert bench.load_metric("train.mfu")(ctx) == \
        pytest.approx(100 * flops / 67e12 / 0.2)
    assert bench.load_metric("b1_roofline.batch")(ctx) is None
    # a kernel that did not run leaves its roofline out
    ctx["trace"] = FakeTrace(ev[2:], 0.2)
    assert bench.load_metric("b3_roofline.train")(ctx) is None
