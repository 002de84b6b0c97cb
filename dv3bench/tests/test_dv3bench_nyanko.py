# coding: utf-8
"""The cell nyanko_ljspeech.batch32 at tiny widths and small traffic on the
CPU: its loop against the plain reference (reference/nyanko.py), the
faults planted under its timed path, its operation counts against a hand
count and torch's FlopCounterMode, and the readers the cell is listed
under on a synthetic nyanko context."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_hp
from dv3bench import bench, counts_nyanko, faults, peaks
from dv3bench.kernels import b1_nyanko, b2
from dv3bench.kinds import nyanko_batch_synthesis
from dv3bench.reference import nyanko as ref_nyanko
from dv3bench.reference import text as ref_text
from test_dv3bench_spans import _ctx, _known_window

from deepvoice3_pytorch_tpu_torch.utils import profiling

CELL = "nyanko_ljspeech.batch32"
SEED = 2 ** 31 + 12345
NEW = ("b1_roofline.nyanko", "synth.mfu.nyanko", "b1.highway.nyanko")
LISTED = ("device.idle.batch", "b2_roofline.batch", "b1.barrier.batch")


def _traffic():
    tr = bench.load_json(bench.HERE / "traffic" / "nyanko_batch32.json")
    tr.update(pool=8, batch=4, trace_calls=2, sample_calls=2,
              corpus=dict(tr["corpus"], max_s=2.0))
    return tr


def _run(trace=0, **kw):
    return nyanko_batch_synthesis.run(tiny_hp("nyanko_ljspeech"), _traffic(),
                                      SEED, 0.2, trace, "cpu", lambda: None,
                                      **kw)


def test_cell_is_declared_with_its_files():
    spec = bench.benchmark()
    cell, hp, traffic, limits = bench.cell_files(CELL, spec)
    assert cell["chips"] == 1 and hp["builder"] == "nyanko"
    assert traffic["kind"] == "nyanko_batch_synthesis"
    names = {m["name"] for m in bench.cell_metrics(CELL, spec, "per_layer")}
    assert names == set(NEW) | set(LISTED)
    assert [m["name"] for m in bench.cell_metrics(CELL, spec)] == \
        ["synth_rtf", "setup_s"]
    # the same numbers as the DeepVoice3 cell's traffic: the same texts
    # and steps for a seed
    other = bench.load_json(bench.HERE / "traffic" / "ljspeech_batch32.json")
    assert {k: v for k, v in traffic.items() if k not in ("kind", "about")} \
        == {k: v for k, v in other.items() if k not in ("kind", "about")}


def test_reference_agrees_with_port():
    out = _run()
    assert out["notes"]["judged_calls"]
    nums = out["numbers"]
    assert nums["shape_faults"] == 0
    for k in ("frame_gap", "align_gap", "linear_gap"):
        assert nums[k] < 1e-5, (k, nums)
    assert abs(nums["gl_sc_excess"]) < 2e-3, nums
    assert bench.judge(nums, bench.limits(CELL))[0], nums


@pytest.mark.parametrize("fault", sorted(faults.BY_KIND["batch_synthesis"][1]))
def test_faults_are_not_correct(fault):
    out = _run(call_fault=faults.BY_KIND["batch_synthesis"][1][fault])
    assert not bench.judge(out["numbers"], bench.limits(CELL))[0], \
        out["numbers"]


def test_traced_run_feeds_every_reader():
    """The traced loop on the CPU: its context is the batch kind's with the
    nyanko configuration, and every reader the cell is listed under reads
    it without raising (the CPU has no device events and no B1 stamps, so
    the kernels' readers give None)."""
    out = _run(trace=1)
    ctx = out["trace"]
    assert ctx["kind"] == "batch" and ctx["cfg"].builder == "nyanko"
    assert len(ctx["calls"]) == _traffic()["trace_calls"]
    got = {n: bench.load_metric(n)(ctx) for n in NEW + LISTED}
    assert got["b1_roofline.nyanko"] is None
    assert got["b2_roofline.batch"] is None
    assert got["b1.highway.nyanko"] is None
    assert got["device.idle.batch"] is not None
    assert got["synth.mfu.nyanko"] > 0


def _cfg():
    hp = tiny_hp("nyanko_ljspeech")
    return hp, ref_nyanko.config_from_hparams(hp, ref_text.N_VOCAB)


def test_b1_work_matches_a_hand_count():
    hp, cfg = _cfg()
    D, F, k = 32, hp["num_mels"], 3
    B, Tk, steps, lengths = 2, 16, 40, [5, 3]
    weights = (F * D + D * D + D * D + 10 * k * D * 2 * D       # audio enc
               + 2 * D * D + 6 * k * D * 2 * D + 3 * D * D      # audio dec
               + D * F + D)                                     # last, fc
    biases = 3 * D + 10 * 2 * D + D + 6 * 2 * D + 3 * D + F + 1
    keys = (4 + 3) * steps            # a window of 1 + 3 keys, or the text
    flops, nbytes = b1_nyanko.work(cfg, B, Tk, steps, lengths)
    assert flops == 2 * (weights * B * steps + 2 * D * keys)
    assert nbytes == 4 * (weights + biases + 2 * B * Tk * (D + 1) + B * Tk
                          + steps * D + B * steps * (F + Tk + 1 + D))


def test_synthesis_flops_match_flop_counter_and_hand_count():
    """The encoder and the converter counted by FlopCounterMode on the
    reference; the whole call's count at one small shape by hand."""
    hp, cfg = _cfg()
    tree = ref_nyanko.seeded_tree(cfg, 3, "cpu")
    B, Tk, steps = 2, 16, 12
    ids = torch.randint(2, 60, (B, Tk), generator=torch.Generator()
                        .manual_seed(0))
    states = torch.rand(B, steps, cfg.converter.in_dim)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        ref_nyanko.encoder(tree, cfg, ids)
        ref_nyanko.converter(tree, cfg, states)
    assert counts_nyanko.encoder_flops(cfg, B, Tk) + \
        counts_nyanko.converter_flops(cfg, B, steps) == fc.get_total_flops()
    E, D2, C, Fd, k = 32, 64, 32, hp["fft_size"] // 2 + 1, 3
    enc = 2 * B * Tk * (E * D2 + D2 * D2 + 10 * k * D2 * 2 * D2
                        + D2 * 2 * D2)
    conv = 0
    for T in (steps, 2 * steps, 4 * steps):     # two highways a length
        conv += 2 * 2 * B * T * k * C * 2 * C
    conv += 2 * B * steps * 32 * C                            # 1x1 D -> C
    conv += 2 * B * steps * C * 2 * C + 2 * B * 2 * steps * C * 2 * C
    T4 = 4 * steps                                            # ^ the convTs
    conv += 2 * B * T4 * (C * 2 * C + 2 * k * 2 * C * 4 * C
                          + 2 * C * Fd + 3 * Fd * Fd)
    lengths = [7, 9]
    got = counts_nyanko.synthesis_flops(cfg, hp, B, Tk, steps, lengths)
    assert got == {"float32": enc + conv + b1_nyanko.work(
        cfg, B, Tk, steps, lengths)[0],
        "bfloat16": b2.work(hp, B, 4 * steps)[0]}


def _nyanko_ctx(monkeypatch, kinds=True):
    w = _known_window()
    stamps, steps, n_stages = w.stamps[0]
    if kinds:
        w.stamps[0] = (stamps, steps, n_stages, ("HIGHWAY",))
    ctx = _ctx(w, monkeypatch)
    hp = bench.load_json(bench.HERE / "configs" / "nyanko_ljspeech.json")
    ctx["hp"] = hp
    ctx["cfg"] = ref_nyanko.config_from_hparams(hp, ref_text.N_VOCAB)
    return ctx


def test_readers_on_a_synthetic_nyanko_context(monkeypatch):
    ctx = _nyanko_ctx(monkeypatch)
    B, tk, steps, lengths = ctx["calls"][0]
    cfg, hp = ctx["cfg"], ctx["hp"]
    got = {n: bench.load_metric(n)(ctx) for n in NEW + LISTED}
    least = peaks.bound_s(*b1_nyanko.work(cfg, B, tk, steps, lengths),
                          "float32")
    assert got["b1_roofline.nyanko"] == pytest.approx(100 * least / 23e-6)
    # B2's two GEMMs: 9 + 2 µs, over 4x the steps' frames
    least = peaks.bound_s(*b2.work(hp, B, 4 * steps), "bfloat16")
    assert got["b2_roofline.batch"] == pytest.approx(100 * least / 11e-6)
    at_peak = sum(f / peaks.FLOPS[p] for p, f in counts_nyanko
                  .synthesis_flops(cfg, hp, B, tk, steps, lengths).items())
    assert got["synth.mfu.nyanko"] == pytest.approx(100 * at_peak / 120e-6)
    # a launch of 600 ns: prologue 200, work 100 + 150, waits 50 + 100
    assert got["b1.barrier.batch"] == pytest.approx(100 * 150 / 600)
    assert got["b1.highway.nyanko"] == pytest.approx(100 * 400 / 600)
    assert got["device.idle.batch"] == pytest.approx(100 * 64 / 120)


def test_readers_without_kinds_or_on_deepvoice3(monkeypatch):
    """A program that keeps no kinds with B1's stamps (the parent of the
    split) leaves b1.highway.nyanko out and b1.barrier.batch as it was;
    the nyanko readers leave a DeepVoice3 context out."""
    ctx = _nyanko_ctx(monkeypatch, kinds=False)
    assert bench.load_metric("b1.highway.nyanko")(ctx) is None
    assert bench.load_metric("b1.barrier.batch")(ctx) == \
        pytest.approx(100 * 150 / 600)
    hp = bench.load_json(bench.HERE / "configs" / "dv3_ljspeech.json")
    from dv3bench.reference import builder
    ctx["cfg"] = builder.config_from_hparams(hp, ref_text.N_VOCAB)
    assert bench.load_metric("b1_roofline.nyanko")(ctx) is None
    assert bench.load_metric("synth.mfu.nyanko")(ctx) is None


def test_stamps_kinds_kept_only_while_recording():
    """The window keeps each launch's kinds with its buffer; outside a
    window nothing is kept."""
    off = profiling.span("dv3.decode.chunk", "device")
    assert off.stamps(3, 2, "cpu", ("A", "B", "C")) is None
    with profiling.recording() as w:
        with profiling.span("dv3.decode.chunk", "device") as sp:
            buf = sp.stamps(3, 2, "cpu", ("LINEAR", "HIGHWAY", "ATTN"))
    assert buf.shape == (2 + 3 * 2 * 3,)
    assert w.stamps[-1][3] == ("LINEAR", "HIGHWAY", "ATTN")


@pytest.mark.cuda
def test_controls_fail_the_cell(card):
    """The reference one precision lower (TF32, e4m3 Griffin-Lim) in the
    program's place fails the cell's limits at test size on the card."""
    out = nyanko_batch_synthesis.run(
        bench.load_json(bench.HERE / "configs" / "nyanko_ljspeech.json"),
        _traffic(), SEED, 0.5, 0, card, lambda: None, control=True)
    assert bench.judge(out["numbers"], bench.limits(CELL))[0], out["numbers"]
    assert not bench.judge(out["control_numbers"], bench.limits(CELL))[0], \
        out["control_numbers"]
