# coding: utf-8
"""The readers of the program's own spans and counters (dv3bench/spans.py
and the five metrics that use it): their arithmetic on a known trace and
recorder, the program's per-call counts against `_call_shape`'s
reconstruction, and a traced window in which no `dv3.*` event reaches the
device's events."""

import pytest
import torch

from conftest import small_traffic, tiny_hp
from dv3bench import bench, spans, trace
from dv3bench.kinds import batch_synthesis

from deepvoice3_pytorch_tpu_torch.utils import profiling

NEW = ("synth.to_host.batch", "synth.copy_useful.batch",
       "device.idle_host_stages.batch", "device.idle_launch.batch",
       "b1.barrier.batch")

# one call on the trace's µs axis: (name, start, end, parent, stage)
CALL = [("dv3.tts_batch", 0, 100, -1, None),
        ("dv3.tts.frontend", 0, 10, 0, "host"),
        ("dv3.tts.to_device", 10, 15, 0, "host"),
        ("dv3.encoder", 15, 30, 0, "device"),
        ("dv3.decode", 30, 60, 0, "device"),
        ("dv3.decode.prepare", 30, 35, 4, "device"),
        ("dv3.decode.chunk", 35, 60, 4, "device"),
        ("dv3.tts.sync_steps", 60, 62, 0, "host"),
        ("dv3.tts.converter", 62, 70, 0, "device"),
        ("dv3.tts.griffin_lim", 70, 80, 0, "device"),
        ("dv3.tts.denormalize", 80, 82, 0, "device"),
        ("dv3.tts.to_host", 82, 95, 0, "host"),
        ("dv3.tts.unpack", 95, 99, 0, "host")]
SHAPE = dict(rows=2, text_padded=16, steps_asked=40)
# B2's last GEMM still runs when the copies are asked for: the host waits
# in `to_host` with a kernel running, and that wait is not the copies'
KERNELS = [("encoder_conv", 16, 29), ("fused_decode_kernel", 36, 59),
           ("converter_conv", 62, 70), ("gemm_batch", 71, 80),
           ("elementwise_kernel", 80, 81), ("gemm_batch", 82, 84)]
COPY = ("Memcpy DtoH (Device -> Pageable)", 84, 93)


def _known_window(call=CALL):
    """A recorder window holding `call` (ns = µs × 1000 + 7e9, so the clock
    marker has to carry the offset), counters and one launch of B1's
    stamps (2 steps of 1 stage)."""
    w = profiling.Window()
    for i, (name, s, e, parent, stage) in enumerate(call):
        sp = profiling.Span(w, name, stage, dict(SHAPE) if i == 0 else {})
        sp.start, sp.end = s * 1000 + 7e9, e * 1000 + 7e9
        sp.parent, sp.call, sp.index = parent, 1, i
        w.spans.append(sp)
    w.clock = [(7e9 - 3000, 7e9 - 1000), (7e9 - 500, 7e9 - 500)]
    w.add("tts.bytes_to_host", 1000)
    w.add("tts.bytes_kept", 900)
    # start, prologue done, then (first part, work done, barrier passed)
    stamps = torch.tensor([100, 300, 310, 400, 450, 460, 600, 700])
    w.stamps.append((stamps, 2, 1))
    return w


def _ctx(w, monkeypatch, window_us=120.0):
    monkeypatch.setattr(profiling, "recorded", lambda: w, raising=False)
    # the markers as the profiler saw them: the first slow and lopsided,
    # the second tight around its read (the one the offset comes from)
    host = [(profiling.CLOCK, -40.0, 10.0), (profiling.CLOCK, -1.0, 0.0)]
    tr = trace.Trace(KERNELS + [COPY], host, window_us / 1e6)
    return {"kind": "batch", "trace": tr, "cfg": None, "hp": None,
            "calls": [(2, 16, 40, [5, 9])]}


def test_the_readers_on_a_known_trace_and_recorder(monkeypatch):
    ctx = _ctx(_known_window(), monkeypatch)
    got = {n: bench.load_metric(n)(ctx) for n in NEW}
    # to_host 13 less B2's GEMM 2 (the copy is idle)
    assert got["synth.to_host.batch"] == pytest.approx(100 * 11 / 120)
    assert got["synth.copy_useful.batch"] == pytest.approx(90.0)
    # frontend 10 + to_device 5 + sync 2 + to_host 11 + unpack 4
    assert got["device.idle_host_stages.batch"] == \
        pytest.approx(100 * 32 / 120)
    # encoder 2 + prepare 5 + chunk 2 + Griffin-Lim 1 + denormalize 1
    assert got["device.idle_launch.batch"] == pytest.approx(100 * 11 / 120)
    # barrier waits 50 + 100 of the launch's 600 ns
    assert got["b1.barrier.batch"] == pytest.approx(100 * 150 / 600)
    idle = bench.load_metric("device.idle.batch")(ctx)
    assert idle == pytest.approx(100 * 64 / 120)
    r = spans.reading(ctx)
    assert r["idle_s"]["dv3.tts_batch"] == pytest.approx(1e-6)
    assert r["idle_outside_s"] == pytest.approx(20e-6)


def test_unclassified_spans_and_spans_outside_a_call(monkeypatch):
    """A span under a call with no class leaves both idle shares out (its
    idle time would leave them unseen); a root that is not a call (a lower
    layer called on its own) is not read; calls that are not the traced
    ones leave every span reader out."""
    bare = list(CALL)
    bare[3] = bare[3][:4] + (None,)
    ctx = _ctx(_known_window(bare), monkeypatch)
    got = {n: bench.load_metric(n)(ctx) for n in NEW}
    assert got["device.idle_host_stages.batch"] is None
    assert got["device.idle_launch.batch"] is None
    assert got["synth.to_host.batch"] == pytest.approx(100 * 11 / 120)

    w = _known_window()
    orphan = profiling.Span(w, "dv3.encoder", "device", {})
    orphan.start, orphan.end = 100 * 1000 + 7e9, 110 * 1000 + 7e9
    orphan.parent, orphan.call, orphan.index = -1, 2, len(w.spans)
    w.spans.append(orphan)
    ctx = _ctx(w, monkeypatch)
    assert bench.load_metric("device.idle_launch.batch")(ctx) == \
        pytest.approx(100 * 11 / 120)
    assert spans.reading(ctx)["idle_outside_s"] == pytest.approx(20e-6)

    ctx = _ctx(_known_window(), monkeypatch)
    ctx["calls"] = [(2, 24, 40, [5, 9])]
    assert [bench.load_metric(n)(ctx) for n in NEW] == [None] * 5


def test_the_readers_leave_their_metric_out_without_the_recorder(
        monkeypatch):
    """A program without `profiling.recorded`, a window the trace's markers
    do not match, or a train cell: no value, no error."""
    w = _known_window()
    ctx = _ctx(w, monkeypatch)
    monkeypatch.delattr(profiling, "recorded")
    assert [bench.load_metric(n)(ctx) for n in NEW] == [None] * 5
    ctx = _ctx(w, monkeypatch)
    ctx["trace"].host.pop()
    assert [bench.load_metric(n)(ctx) for n in NEW] == [None] * 5
    ctx = _ctx(w, monkeypatch)
    ctx["kind"] = "train"
    assert [bench.load_metric(n)(ctx) for n in NEW] == [None] * 5


def _traced(device):
    hp, tr = tiny_hp("dv3_ljspeech"), small_traffic("ljspeech_batch32")
    out = batch_synthesis.run(hp, tr, 3000000001, 0.5, 1, device,
                              lambda: None)
    return out["trace"]


def _check_traced_window(ctx):
    w = profiling.recorded()
    roots = [s for s in w.spans if s.parent < 0]
    assert [s.name for s in roots] == ["dv3.tts_batch"] * len(ctx["calls"])
    for s, (B, tk, steps, lengths) in zip(roots, ctx["calls"]):
        assert s.attrs == dict(rows=B, text_padded=tk, steps_asked=steps)
    assert not spans.reading(ctx)["unclassified"]
    tr = ctx["trace"]
    assert not [e for e in tr.device if e[0].startswith("dv3.")]
    assert [e[0] for e in tr.host if e[0].startswith("dv3.")] == \
        [profiling.CLOCK] * profiling.CLOCK_MARKS
    got = {n: bench.load_metric(n)(ctx) for n in NEW}
    idle = bench.load_metric("device.idle.batch")(ctx)
    assert got["device.idle_host_stages.batch"] + \
        got["device.idle_launch.batch"] <= idle + 1e-9
    return got


def test_counts_match_the_call_shapes_and_no_span_is_a_device_event():
    got = _check_traced_window(_traced("cpu"))
    assert got["b1.barrier.batch"] is None          # no kernel on the CPU
    for n in NEW[:4]:
        assert got[n] is not None and 0 <= got[n] <= 100, (n, got[n])


@pytest.mark.cuda
def test_the_traced_window_on_the_card(card):
    got = _check_traced_window(_traced(card))
    for n in NEW:
        assert got[n] is not None and 0 <= got[n] <= 100, (n, got[n])
