# coding: utf-8
"""The port's recorder (utils/profiling.py): spans and counters inside
tts_batch. Off, a span or a count keeps nothing and reads no clock; on
(under `recording()` or a profiler session), one call of tts_batch gives
one `dv3.tts_batch` span with its stages nested under it, each of its
class, one call id, its shape, the bytes it copied and those of them in
page-locked memory (none on the CPU), the decode steps B1 ran and those
it returned; the spans line up
with the profiler's own events through the `dv3.clock` markers; kernel
B1's stamps fold into prologue, work and barrier wait.

The `cuda` test runs tts_batch on the card and reads B1's stamps from the
main path (`python -m pytest tests/test_torch_spans.py -m cuda
--noconftest -q`; this file imports no JAX)."""

import copy
import tracemalloc

import numpy as np
import pytest
import torch

from deepvoice3_pytorch_tpu_torch import hparams, model_builder, synthesis
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
from deepvoice3_pytorch_tpu_torch.frontend import en
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as fd
from deepvoice3_pytorch_tpu_torch.utils import profiling

TEXTS = ["Hello world.", "A second, longer sentence to batch."]
STEPS = 40

# a call's stages and their classes
CHILDREN = (("dv3.tts.frontend", "host"), ("dv3.tts.to_device", "host"),
            ("dv3.encoder", "device"), ("dv3.decode", "device"),
            ("dv3.tts.sync_steps", "host"), ("dv3.tts.converter", "device"),
            ("dv3.tts.griffin_lim", "device"),
            ("dv3.tts.denormalize", "device"), ("dv3.tts.to_host", "host"),
            ("dv3.tts.unpack", "host"))


@pytest.fixture(scope="module")
def tiny():
    torch.set_num_threads(1)
    hp = hparams.default_hparams().parse(
        "text_embed_dim=32,encoder_channels=32,decoder_channels=32,"
        "converter_channels=32,fft_size=256,hop_size=64")
    cfg, params = model_builder.build_model(hp, en.n_vocab, seed=3,
                                            device="cpu")
    return hp, cfg, params


def _call(tiny, params=None, texts=TEXTS):
    hp, cfg, p = tiny
    return synthesis.tts_batch(params if params is not None else p, cfg,
                               AudioProcessor(hp), en, texts,
                               max_decoder_steps=STEPS, early_exit=False)


def test_off_path_keeps_nothing_and_reads_no_clock(tiny, monkeypatch):
    with profiling.recording():
        pass
    before = profiling.recorded()

    def no_clock():
        raise AssertionError("the off path read the clock")

    monkeypatch.setattr(profiling.time, "time_ns", no_clock)
    spans = [profiling.span("dv3.a"), profiling.span("dv3.b", x=1)]
    assert spans[0] is spans[1] and not spans[0]
    tracemalloc.start()
    try:
        held = tracemalloc.get_traced_memory()[0]
        for _ in range(2000):
            with profiling.span("dv3.off", "host", rows=3) as sp:
                sp.set(more=1)
                assert sp.stamps(4, 8, "cpu") is None
                profiling.count("tts.off", 5)
        grown = tracemalloc.get_traced_memory()[0] - held
    finally:
        tracemalloc.stop()
    assert grown < 1024, grown
    monkeypatch.undo()
    _call(tiny)
    assert profiling.recorded() is before
    assert before.spans == [] and before.counters() == {}


def test_one_call_gives_one_nested_span_tree(tiny):
    with profiling.recording() as w:
        res = _call(tiny)
    assert profiling.recorded() is w
    spans = w.spans
    roots = [s for s in spans if s.parent < 0]
    assert [s.name for s in roots] == ["dv3.tts_batch"]
    root = roots[0]
    assert {s.call for s in spans} == {root.call}
    assert root.stage is None
    assert tuple((s.name, s.stage) for s in spans
                 if s.parent == root.index) == CHILDREN
    for s in spans:
        assert s.name.startswith("dv3.") and s.start <= s.end
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    decode = next(s for s in spans if s.name == "dv3.decode")
    under = [(s.name, s.stage) for s in spans if s.parent == decode.index]
    n_chunks = -(-STEPS // min(fd.DEFAULT_CHUNK, STEPS))
    assert under == [("dv3.decode.prepare", "device")] + \
        [("dv3.decode.chunk", "device")] * n_chunks

    seqs = [en.text_to_sequence(t) for t in TEXTS]
    padded = -(-max(map(len, seqs)) // 8) * 8
    n_dec = max(r["num_decoder_steps"] for r in res)
    n_bucket = min(STEPS, -(-(n_dec + synthesis.SLACK_DEC_STEPS)
                            // synthesis.BUCKET_DEC_STEPS)
                   * synthesis.BUCKET_DEC_STEPS)
    assert root.attrs == dict(rows=2, text_padded=padded, steps_asked=STEPS)
    c = w.counters()
    kept = sum(r[k].nbytes for r in res
               for k in ("waveform", "mel", "linear", "alignment"))
    assert sorted(c) == ["b1.steps_kept", "b1.steps_run", "tts.bytes_kept",
                         "tts.bytes_pinned", "tts.bytes_to_host"]
    # the plain decoder's steps: every one of the STEPS asked, none more
    assert c["b1.steps_run"] == c["b1.steps_kept"] == STEPS
    assert c["tts.bytes_kept"] == kept
    assert c["tts.bytes_pinned"] == 0           # the CPU's plain copies
    # the six copies: waveform, mel, linear, alignment (whole buffers),
    # the text lengths (int64) and the decoded lengths (int32)
    hp = tiny[0]
    moved = 4 * 2 * (n_bucket * 4 * hp.hop_size + STEPS * hp.num_mels
                     + n_bucket * 4 * (hp.fft_size // 2 + 1)
                     + STEPS * padded) + 8 * 2 + 4 * 2
    assert c["tts.bytes_to_host"] == moved
    assert kept < moved
    assert w.b1_split() is None                 # no kernel B1, no stamps

    with profiling.recording() as w2:
        _call(tiny)
        _call(tiny)
    roots = [s for s in w2.spans if s.parent < 0]
    assert len(roots) == 2 and roots[0].call != roots[1].call
    assert w2.counters() == {k: 2 * n for k, n in c.items()}


def test_a_lower_layer_called_on_its_own(tiny):
    """builder.model_decode outside tts_batch: its spans are roots of
    their own calls, of their class, and no `dv3.tts_batch` appears."""
    hp, cfg, params = tiny
    x, pos, lengths = synthesis._prepare_batch(en, TEXTS, pad_to=8)
    with profiling.recording() as w:
        synthesis.model_decode(params, cfg, torch.from_numpy(x),
                               torch.from_numpy(pos),
                               input_lengths=torch.from_numpy(lengths),
                               max_decoder_steps=STEPS, early_exit=False)
    roots = [s for s in w.spans if s.parent < 0]
    assert [(s.name, s.stage) for s in roots] == \
        [("dv3.encoder", "device"), ("dv3.decode", "device")]
    assert len({s.call for s in roots}) == 2
    assert {s.name for s in w.spans} == {"dv3.encoder", "dv3.decode",
                                         "dv3.decode.prepare",
                                         "dv3.decode.chunk"}
    with profiling.recording(), pytest.raises(ValueError):
        profiling.span("dv3.bad", "kernel")


def test_spans_line_up_with_the_profiler(tiny):
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with profiling.span("dv3.test.mm"):
                torch.mm(x, x)
            torch.relu(x)
    w = profiling.recorded()
    assert [s.name for s in w.spans] == ["dv3.test.mm"] * 3
    ev = [e for e in prof.events()]
    assert not [e for e in ev if e.name.startswith("dv3.")
                and e.name != profiling.CLOCK]
    marks = sorted((e.time_range.start, e.time_range.end) for e in ev
                   if e.name == profiling.CLOCK)
    off = profiling.clock_offset_us(w, marks)
    assert off is not None
    mms = sorted((e.time_range.start, e.time_range.end) for e in ev
                 if e.name == "aten::mm")
    assert len(mms) == 3
    for s, (a, b) in zip(w.spans, mms):
        assert s.start / 1e3 + off - 50 <= a and b <= s.end / 1e3 + off + 50
    # the next span outside the session starts no window and keeps this one
    with profiling.span("dv3.test.after"):
        pass
    assert profiling.recorded() is w and len(w.spans) == 3


def test_fold_b1_stamps():
    steps, n_stages = 2, 3
    t = [1000, 1400]                        # start, prologue done
    now, work, wait = 1400, 0, 0
    for i in range(steps * n_stages):
        first, done, passed = now + 3, now + 5 + i, now + 5 + i + 2 * i + 1
        t += [first, done, passed]
        work += done - now
        wait += passed - done
        now = passed
    got = profiling.fold_b1_stamps(np.array(t), steps, n_stages)
    assert got == dict(launch_ns=now - 1000, prologue_ns=400, work_ns=work,
                       barrier_ns=wait)
    assert got["prologue_ns"] + got["work_ns"] + got["barrier_ns"] == \
        got["launch_ns"]
    # a buffer the launch did not fill, or of another shape
    assert profiling.fold_b1_stamps(np.zeros(len(t)), steps, n_stages) \
        is None
    bad = list(t)
    bad[5] = 0
    assert profiling.fold_b1_stamps(np.array(bad), steps, n_stages) is None
    assert profiling.fold_b1_stamps(np.array(t[:-1]), steps, n_stages) is None


@pytest.mark.cuda
def test_b1_stamps_on_the_main_path(tiny):
    """tts_batch on the card under recording(): every chunk span holds one
    launch of B1 (as the kernel's own launch counter counts them) with its
    stamps; the fold adds up; every byte copied to the host landed in
    page-locked memory; B1 ran the STEPS asked and no more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hp, cfg, params = tiny
    gpu = copy.deepcopy(params).to("cuda")
    _call(tiny, gpu)                              # build the kernels
    before = fd.KERNEL.by_route.get("persistent", 0)
    with profiling.recording() as w:
        res = _call(tiny, gpu)
    chunks = [s for s in w.spans if s.name == "dv3.decode.chunk"]
    assert len(w.stamps) == len(chunks) > 0
    assert fd.KERNEL.by_route["persistent"] - before == len(chunks)
    split = w.b1_split()
    assert split["launches"] == len(chunks)
    assert split["prologue_ns"] + split["work_ns"] + split["barrier_ns"] \
        == split["launch_ns"]
    assert split["work_ns"] > 0 and split["barrier_ns"] > 0
    assert len(res) == len(TEXTS)
    c = w.counters()
    assert c["tts.bytes_pinned"] == c["tts.bytes_to_host"] > 0
    assert c["b1.steps_run"] == c["b1.steps_kept"] == STEPS


def test_steps_kept_reader_over_a_profiled_call(tiny):
    """The benchmark's reader of `b1.steps_kept.batch` over one tts_batch
    profiled on the CPU: 100 % (the decode ran only the steps it returned);
    no value from a window without the two counters, as from a program
    that predates them."""
    from dv3bench import bench, trace

    _, tr = trace.profiled(torch, lambda: _call(tiny), cuda=False)
    w = profiling.recorded()
    root = next(s for s in w.spans if s.parent < 0)
    shape = tuple(root.attrs[k] for k in ("rows", "text_padded",
                                          "steps_asked"))
    read = bench.load_metric("b1.steps_kept.batch")
    assert read({"kind": "batch", "trace": tr,
                 "calls": [shape + (None,)]}) == 100.0
    full = w.counters()
    for gone in ("b1.steps_run", "b1.steps_kept"):
        w._counts = {k: v for k, v in full.items() if k != gone}
        again = trace.Trace(tr.device, tr.host, tr.window_s)
        assert read({"kind": "batch", "trace": again,
                     "calls": [shape + (None,)]}) is None
