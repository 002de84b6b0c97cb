# coding: utf-8
"""Continuous batching of the PyTorch port (serving.ContinuousBatcher) on
the CPU, at the narrow widths of tests/torch_port_common.py (fft 128, hop
32), with the JAX parameters loaded into the port:

  * the plain version of kernel B1's serving modes (PlainSlotDecoder: rows
    at their own positions, one past the position table's end, each with
    its own context scale) against the JAX kernel's fpe_per_sample /
    per_sample_scale launch in interpret mode, for the three families:
    frames, alignments, done and states <= 2e-5 (the bar of
    tests/test_torch_fused_decode.py), last_attended and the advanced
    positions exact;
  * the port's batcher against JAX's under one submit/step schedule, at
    the configuration of tests/test_torch_streaming.py (tiny widths, fft
    1024): decoded steps exact, audio 0.12 of the peak with spectral
    convergence no worse than 1.05x JAX's (that file's bars for a stream
    against JAX's: JAX vocodes in f32 on the CPU, the port through B2's
    bf16 schedule), on that file's texts: the bar was set on them, and the
    two packages' fresh streams of TEXT_A below already part by 0.31 of
    the peak at this configuration, while the port's batcher equals the
    port's stream to rounding;
  * a counterpart of every test of tests/test_serving.py, held against the
    port's own tts_stream of each text at JAX's bar, 0.05 of the peak: a
    slot admitted mid-stream, a reused slot, the speakers, nyanko, a text
    bucket growth, the admission policies, the launch contract (one B1
    launch, one Griffin-Lim window per emission group, one copy to the
    host per step) and the rewind of the pipelined retire.

oneDNN is off in this module: its convolutions sum in an order that
depends on the batch, so a converter window of a group of slots would
differ from a batch-1 stream's in the last ulp, which the bf16 Griffin-Lim
amplifies; PyTorch's own convolution works sample by sample.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import builder as j_builder
from deepvoice3_pytorch_tpu import serving as j_serving
from deepvoice3_pytorch_tpu.dsp import reference_model as ref
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAP
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
from deepvoice3_pytorch_tpu.model_builder import build_model as j_build
from deepvoice3_pytorch_tpu.models import deepvoice3 as j_dv3
from deepvoice3_pytorch_tpu.models import nyanko as j_nk
from deepvoice3_pytorch_tpu.ops import fused_decode as j_fd
from deepvoice3_pytorch_tpu_torch import builder as t_builder
from deepvoice3_pytorch_tpu_torch import serving, streaming
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAP
from deepvoice3_pytorch_tpu_torch.frontend import en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams
from deepvoice3_pytorch_tpu_torch.model_builder import build_config
from deepvoice3_pytorch_tpu_torch.ops import core as t_core
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as t_fd

from torch_port_common import (jax_params, maxdiff, port_params, t,
                               text_inputs, tiny_configs)

TOL = 2e-5
TEXT_A = "the first serving test sentence."
TEXT_B = "a different second one."
TEXT_C = "and one more."
TEXT_D = "a fourth one to fill the batch."
TEXT_LONG = "this one is longer than sixteen tokens."
CHUNK, MAX, PAD, CTX = 8, 24, 40, 8
FAMILIES = ["deepvoice3", "nyanko", "deepvoice3_multispeaker"]


@pytest.fixture(scope="module", autouse=True)
def native_conv():
    saved = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = saved


def _hparams(make):
    hp = make()
    hp.fft_size, hp.hop_size = 128, 32
    return hp


@pytest.fixture(scope="module")
def models():
    """builder -> (JAX cfg, params), (port cfg, params); the two audio
    processors (fft 128)."""
    out = {}
    for name in FAMILIES:
        cfg_j, cfg_t = tiny_configs(name)
        pj = jax_params(cfg_j)
        out[name] = (cfg_j, pj), (cfg_t, port_params(pj, cfg_t))
    return out, JAP(_hparams(j_hparams)), TAP(_hparams(default_hparams))


def _batcher(model, ap, **kw):
    cfg, params = model
    args = dict(n_slots=3, text_pad=PAD, chunk=CHUNK, max_decoder_steps=MAX,
                gl_context=CTX)
    args.update(kw)
    return serving.ContinuousBatcher(params, cfg, ap, en, **args)


def _run(b, limit=80):
    n = 0
    while b.step():
        n += 1
        assert n < limit
    return n


def _drain(q):
    audio, n_dec = [], None
    while True:
        kind, payload = q.get_nowait()
        assert kind != "error", payload
        if kind == "end":
            n_dec = payload
            break
        audio.append(payload)
    return np.concatenate(audio), n_dec


def _fresh(model, ap, text, speaker=None, *, chunk=CHUNK, pad=PAD,
           max_steps=MAX, linear=False):
    """The port's tts_stream of one text at the batcher's chunking, trimmed
    to the decoded length (as the batcher trims), and its decoded steps;
    with linear, also the emitted linear frames."""
    cfg, params = model
    chunks = list(streaming.tts_stream(
        params, cfg, ap, en, [text],
        speaker_ids=None if speaker is None else [speaker],
        max_decoder_steps=max_steps, first_chunk=chunk, chunk=chunk,
        gl_context=CTX, pad_to=pad, emit_linear=linear))
    n_dec = int(chunks[-1]["decoded_steps"][0])
    audio = np.concatenate([c["audio"] for c in chunks], axis=1)[0]
    audio = audio[:streaming.decoded_samples(cfg, ap, n_dec)]
    if linear:
        lin = np.concatenate([c["linear"] for c in chunks], axis=1)[0]
        return audio, n_dec, lin
    return audio, n_dec


def _assert_fresh(got, want, bar=0.05):
    (audio, n_dec), (ref_audio, ref_dec) = got, want
    assert n_dec == ref_dec
    assert len(audio) == len(ref_audio)
    scale = max(np.abs(ref_audio).max(), 1e-6)
    assert np.abs(audio - ref_audio).max() <= bar * scale, \
        np.abs(audio - ref_audio).max() / scale


# ---------------------------------------------------------------------------
# B1's serving modes, plain version, against the JAX kernel
# ---------------------------------------------------------------------------


def _row(fi, b):
    """Row b of batched fused-decode inputs, as a batch-1 admission."""
    one = slice(b, b + 1)
    return dict(
        fi, projected_kv=[None if p is None else (p[0][one], p[1][one])
                          for p in fi["projected_kv"]],
        w_query=None if fi["w_query"] is None else fi["w_query"][one],
        speaker_bias=[s[one] for s in fi["speaker_bias"] or []],
        speaker_embed=(None if fi["speaker_embed"] is None
                       else fi["speaker_embed"][one]))


@pytest.mark.parametrize("name", FAMILIES)
def test_slot_decode_matches_jax_per_sample_modes(models, name):
    (cfg_j, pj), (cfg_t, pt) = models[0][name]
    jfam = j_nk if name == "nyanko" else j_dv3
    x, pos, lengths = text_inputs()
    se_j = se_t = None
    if name == "deepvoice3_multispeaker":
        spk = np.asarray([1, 4, 2])
        se_j = j_builder.core.embedding_apply(pj["embed_speakers"],
                                              jnp.asarray(spk))
        se_t = t_builder.embed_speakers(pt, cfg_t, t(spk))
    enc_j = jfam.encoder_apply(pj["encoder"], cfg_j.encoder, jnp.asarray(x),
                               speaker_embed=se_j)
    enc_t = cfg_t.family.encoder_apply(pt["encoder"], cfg_t.encoder, t(x),
                                       speaker_embed=se_t)
    fi_j = jfam.fused_decode_inputs(pj["decoder"], cfg_j.decoder, enc_j,
                                    jnp.asarray(pos), 1, speaker_embed=se_j)
    fi_t = cfg_t.family.fused_decode_inputs(pt["decoder"], cfg_t.decoder,
                                            enc_t, t(pos), 1,
                                            speaker_embed=se_t)
    Tk, steps = x.shape[1], 6
    # one row at the start, one inside, one running past the table's end
    local = np.asarray([0, 9, cfg_t.decoder.max_positions - 4], np.int32)
    scale = [b * math.sqrt(1.0 / b) for b in (12, 16, 64)]

    mask_j = jnp.arange(Tk)[None, :] >= jnp.asarray(lengths)[:, None]
    prep = j_fd._Prepared(pj["decoder"], cfg_j.decoder, fi_j["projected_kv"],
                          mask_j, w_query=fi_j["w_query"],
                          speaker_bias=fi_j["speaker_bias"],
                          fpe_raw=fi_j["fpe_raw"], fpe_per_sample=True,
                          ctx_scale=jnp.asarray(scale, jnp.float32))
    la0, bufs0 = prep.zero_carry()
    table = jnp.asarray(pj["decoder"]["embed_query_positions"]["w"])
    rows = jnp.clip(local[:, None] + np.arange(1, steps + 1), 0,
                    table.shape[0] - 1)
    init = jnp.zeros((3, cfg_j.decoder.in_dim * cfg_j.decoder.r))
    outs_j, (_, la_j, _) = prep.launch(jnp.take(table, rows, axis=0), init,
                                       la0, bufs0, steps, True)

    mask_t = t_core.get_mask_from_lengths(t(lengths), Tk)
    si = t_fd.slot_inputs(_row(fi_t, 0), 3, Tk)
    for b in range(3):
        t_fd.write_slot_row(si, b, _row(fi_t, b), mask_t[b:b + 1], scale[b])
    dec = t_fd.make_slot_decoder(pt["decoder"], cfg_t.decoder, 3, "cpu")
    assert isinstance(dec, t_fd.PlainSlotDecoder)
    carry = dec.zero_carry()
    dec.positions(carry)[:] = torch.from_numpy(local)
    outs_t = dec.new_outputs(steps, Tk)
    with torch.inference_mode():
        dec.launch(si, carry, outs_t, steps)
    for n, a, b in zip(("outputs", "alignments", "done", "decoder_states"),
                       outs_t, outs_j):
        assert maxdiff(a, b) <= TOL, (n, maxdiff(a, b))
    n_att = prep.n_att
    att = dec.att
    la_t = carry["state"]["last_attended"][:, att].numpy()
    assert (la_t == np.asarray(la_j)[:, :n_att]).all()
    assert dec.positions(carry).tolist() == (local + steps).tolist()


# ---------------------------------------------------------------------------
# the port's batcher against JAX's
# ---------------------------------------------------------------------------


STREAM_TINY = ("text_embed_dim=64,encoder_channels=32,decoder_channels=32,"
               "converter_channels=32,outputs_per_step=4,downsample_step=1,"
               "max_decoder_steps=48")
STREAM_TEXTS = ("this is the first streaming test sentence.",
                "a second one, a little longer than the first one was.")


def test_batcher_matches_jax_batcher():
    """The same schedule in both packages: the first text alone for one
    step, then the second admitted mid-stream."""
    hj, ht = j_hparams(), default_hparams()
    hj.parse(STREAM_TINY)
    ht.parse(STREAM_TINY)
    cfg_j, pj = j_build(hj, j_en.n_vocab)
    cfg_t = build_config(ht, en.n_vocab)
    pt = port_params(jax.tree_util.tree_map(np.asarray, pj), cfg_t)
    ap_j, ap_t = JAP(hj), TAP(ht)
    kw = dict(n_slots=3, text_pad=PAD, chunk=CHUNK, max_decoder_steps=MAX,
              gl_context=CTX)
    jb = j_serving.ContinuousBatcher(pj, cfg_j, ap_j, j_en, **kw)
    tb = serving.ContinuousBatcher(pt, cfg_t, ap_t, en, **kw)
    got = {}
    texts = STREAM_TEXTS
    for name, b in (("jax", jb), ("port", tb)):
        qa = b.submit(texts[0])
        assert b.step() == 1
        qb = b.submit(texts[1])
        _run(b)
        got[name] = [_drain(qa), _drain(qb)]
    for (a_t, d_t), (a_j, d_j), text in zip(got["port"], got["jax"], texts):
        assert d_t == d_j and len(a_t) == len(a_j)
        assert maxdiff(a_t, a_j) <= 0.12 * np.abs(a_j).max()
        # magnitudes of the port's own stream of the text (its linear
        # frames, the decoded length of them)
        _, n_dec, lin = _fresh((cfg_t, pt), ap_t, text, linear=True)
        lin = lin[:len(a_t) // ap_t.hop_size]
        S = ap_t._denorm_pow(torch.from_numpy(lin)).numpy()
        sc = [ref.spectral_convergence(
            ref._preemphasis(a.astype(np.float64), ap_t.preemphasis_coef),
            S, ap_t.fft_size, ap_t.hop_size) for a in (a_t, a_j)]
        assert sc[0] <= 1.05 * sc[1], sc


# ---------------------------------------------------------------------------
# counterparts of tests/test_serving.py, against the port's own streams
# ---------------------------------------------------------------------------


def test_mid_stream_admission_matches_fresh_streams(models, monkeypatch):
    """B, admitted while A runs, decodes like a fresh stream; the pipelined
    retire rewound a slot at least once."""
    model, ap = models[0]["deepvoice3"][1], models[2]
    rewinds = []
    orig = serving._restore_rows

    def counting(*a):
        rewinds.append(1)
        return orig(*a)

    monkeypatch.setattr(serving, "_restore_rows", counting)
    b = _batcher(model, ap)
    qa = b.submit(TEXT_A)
    assert b.step() == 1
    qb = b.submit(TEXT_B)
    _run(b)
    _assert_fresh(_drain(qa), _fresh(model, ap, TEXT_A))
    _assert_fresh(_drain(qb), _fresh(model, ap, TEXT_B))
    assert rewinds
    timing = b.timing()
    assert timing["n_steps"] >= 3 and set(timing) >= {
        "admit", "decode_dispatch", "emit_dispatch", "done_fetch",
        "complete", "retire"}


def test_slot_reuse_after_retirement(models):
    model, ap = models[0]["deepvoice3"][1], models[2]
    b = _batcher(model, ap, n_slots=1, max_decoder_steps=16)
    qa = b.submit(TEXT_A)
    qc = b.submit(TEXT_C)               # waits for the single slot
    _run(b)
    audio_a, _ = _drain(qa)
    assert audio_a.shape[0] > 0
    cfg, params = model
    chunks = list(streaming.tts_stream(params, cfg, ap, en, [TEXT_C],
                                       max_decoder_steps=16,
                                       first_chunk=CHUNK, chunk=CHUNK,
                                       gl_context=CTX, pad_to=PAD))
    n_dec = int(chunks[-1]["decoded_steps"][0])
    ref_c = np.concatenate([c["audio"] for c in chunks], axis=1)[0]
    _assert_fresh(_drain(qc), (
        ref_c[:streaming.decoded_samples(cfg, ap, n_dec)], n_dec))


def test_multispeaker_admission_matches_fresh_stream(models):
    model, ap = models[0]["deepvoice3_multispeaker"][1], models[2]
    b = _batcher(model, ap, n_slots=2)
    qa = b.submit(TEXT_A, speaker_id=1)
    assert b.step() == 1
    qb = b.submit(TEXT_B, speaker_id=3)     # mid-stream, another speaker
    _run(b)
    _assert_fresh(_drain(qa), _fresh(model, ap, TEXT_A, 1))
    _assert_fresh(_drain(qb), _fresh(model, ap, TEXT_B, 3))


def test_nyanko_admission_matches_fresh_stream(models):
    """Finished position encodings read per slot; nyanko's converter
    context bumps the chunk, and the fresh stream uses the bumped one (and
    a step cap of whole chunks, so its last chunk is not a shorter one)."""
    model, ap = models[0]["nyanko"][1], models[2]
    b = _batcher(model, ap, n_slots=2)
    assert b.chunk > CHUNK
    b.max_decoder_steps = 2 * b.chunk
    qa = b.submit(TEXT_A)
    assert b.step() == 1
    qb = b.submit(TEXT_B)
    _run(b)
    _drain(qa)
    _assert_fresh(_drain(qb), _fresh(model, ap, TEXT_B, chunk=b.chunk,
                                     max_steps=2 * b.chunk))


def test_long_text_grows_bucket_and_matches(models):
    """A text longer than the bucket grows the text dimension while A
    decodes; A's stream is unchanged (its context scale stays the one of
    its bucket) and the long text decodes like a fresh stream."""
    model, ap = models[0]["deepvoice3"][1], models[2]
    pad = 16
    assert len(en.text_to_sequence(TEXT_C)) <= pad < \
        len(en.text_to_sequence(TEXT_LONG))
    b = _batcher(model, ap, n_slots=2, text_pad=pad)
    qa = b.submit(TEXT_C)
    assert b.step() == 1
    assert b._tk == pad
    qb = b.submit(TEXT_LONG)
    _run(b)
    assert b._tk > pad
    _assert_fresh(_drain(qa), _fresh(model, ap, TEXT_C, pad=pad))
    _assert_fresh(_drain(qb), _fresh(model, ap, TEXT_LONG, pad=pad))
    with pytest.raises(ValueError):
        b.submit("word " * 20)              # beyond max_positions - 1


def test_speaker_policy_enforced_at_submit(models):
    single = _batcher(models[0]["deepvoice3"][1], models[2], n_slots=1)
    with pytest.raises(ValueError):
        single.submit(TEXT_C, speaker_id=0)
    multi = _batcher(models[0]["deepvoice3_multispeaker"][1], models[2],
                     n_slots=1)
    for bad in (None, -1, 5):
        with pytest.raises(ValueError):
            multi.submit(TEXT_C, speaker_id=bad)
    assert multi.waiting() == 0


def test_backlog_admission_control(models):
    b = _batcher(models[0]["deepvoice3"][1], models[2], n_slots=1,
                 max_backlog=2)
    b.submit(TEXT_A)
    b.submit(TEXT_B)
    with pytest.raises(serving.BacklogFull):
        b.submit(TEXT_C)
    assert b.waiting() == 2 and b.pending() == 2
    assert _batcher(models[0]["deepvoice3"][1], models[2],
                    n_slots=2).max_backlog == 16


def test_text_beyond_max_positions_rejected(models):
    model = models[0]["deepvoice3"][1]
    b = _batcher(model, models[2], n_slots=1, text_pad=8)
    with pytest.raises(ValueError):
        b.submit("word " * (model[0].decoder.max_positions + 8))
    cap = model[0].decoder.max_positions - 1
    fits = next(x for x in ("x" * n for n in range(cap, 0, -1))
                if len(en.text_to_sequence(x)) == cap)
    b.submit(fits)


def _count(monkeypatch, obj, name, counts, key):
    orig = getattr(obj, name)

    def counting(*a, **kw):
        counts[key] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(obj, name, counting)


def test_steady_state_launch_contract(models, monkeypatch):
    """Four slots admitted together share one emission phase: a step of
    them is one decoder launch, one emission group (one converter call and
    one Griffin-Lim window) and one copy to the host, whose harvest is the
    step's one wait."""
    b = _batcher(models[0]["deepvoice3"][1], models[2], n_slots=4)
    counts = dict(decode=0, emit=0, fetch=0, wait=0, gl=0)
    _count(monkeypatch, b.dec, "launch", counts, "decode")
    _count(monkeypatch, b.emit, "dispatch", counts, "emit")
    _count(monkeypatch, b._fetch, "start", counts, "fetch")
    _count(monkeypatch, b._fetch, "wait", counts, "wait")
    _count(monkeypatch, streaming, "gl_window", counts, "gl")
    queues = [b.submit(x) for x in (TEXT_A, TEXT_B, TEXT_C, TEXT_D)]
    steady = 0
    while True:
        before = dict(counts)
        n = b.step()
        if n == 0:
            break
        if n == 4 and b.active_slots() == 4 and b._steps_run > 1:
            # no admission, no retirement: the steady state
            d = {k: counts[k] - before[k] for k in counts}
            assert d == dict(decode=1, emit=1, fetch=1, wait=1, gl=d["gl"])
            assert d["gl"] <= 1
            steady += 1
        assert b._steps_run < 50
    assert steady >= 1
    for q in queues:
        audio, n_dec = _drain(q)
        assert audio.shape[0] > 0 and n_dec > 0


def test_step_accumulator_single_fetch_under_staggered_phases(models,
                                                              monkeypatch):
    """Slots admitted one chunk apart sit at different phases, so a step
    launches several emission groups; every group's samples go into the
    step's raw_buf and the step still makes one copy to the host."""
    b = _batcher(models[0]["deepvoice3"][1], models[2])
    stats = {"max_groups": 0, "direct": 0}
    orig = b._complete_jobs

    def counting(jobs, raw_host):
        emitting = [j[2] for j in jobs if j[2] is not None]
        stats["max_groups"] = max(stats["max_groups"], len(emitting))
        stats["direct"] += sum(not isinstance(r, str) for r in emitting)
        return orig(jobs, raw_host)

    monkeypatch.setattr(b, "_complete_jobs", counting)
    counts = dict(fetch=0)
    _count(monkeypatch, b._fetch, "start", counts, "fetch")
    queues = [b.submit(TEXT_A)]
    b.step()
    queues.append(b.submit(TEXT_B))
    b.step()
    queues.append(b.submit(TEXT_C))
    _run(b)
    assert stats["max_groups"] >= 2, stats
    assert stats["direct"] == 0, stats
    assert counts["fetch"] == b._steps_run
    for q in queues:
        audio, n_dec = _drain(q)
        assert audio.shape[0] > 0 and n_dec > 0


def test_engine_error_fails_requests_and_loop_goes_on(models, monkeypatch):
    """An exception inside a step delivers ("error", exc) to the active and
    waiting requests; the next request is served."""
    import threading

    b = _batcher(models[0]["deepvoice3"][1], models[2], n_slots=1)
    orig = b.dec.launch
    calls = []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected")
        return orig(*a, **kw)

    monkeypatch.setattr(b.dec, "launch", failing)
    stop = threading.Event()
    qa, qb = b.submit(TEXT_A), b.submit(TEXT_B)
    worker = threading.Thread(target=b.run_loop, args=(stop,), daemon=True)
    worker.start()
    try:
        for q in (qa, qb):
            kind, payload = q.get(timeout=60)
            assert kind == "error" and "injected" in str(payload)
        qc = b.submit(TEXT_C)
        items = []
        while not items or items[-1][0] not in ("end", "error"):
            items.append(qc.get(timeout=120))
        assert items[-1][0] == "end" and items[0][0] == "audio"
    finally:
        stop.set()
        worker.join(timeout=60)
    assert not worker.is_alive()


def test_concurrent_submits_never_pass_max_backlog(models):
    """Many threads submitting at once, with the interpreter switching
    threads as often as it can: exactly max_backlog requests are queued
    and every other submit is shed (a check-then-put without the admission
    lock would let some through)."""
    import sys
    import threading

    b = _batcher(models[0]["deepvoice3"][1], models[2], n_slots=1,
                 max_backlog=5)
    outcome = []
    start = threading.Barrier(32)

    def submit():
        start.wait(timeout=30)
        try:
            b.submit(TEXT_C)
            outcome.append("queued")
        except serving.BacklogFull:
            outcome.append("shed")

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submit) for _ in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(saved)
    assert not any(th.is_alive() for th in threads)
    assert outcome.count("queued") == 5 == b.waiting()
    assert outcome.count("shed") == 27
