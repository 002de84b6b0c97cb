# coding: utf-8
"""The multi-speaker DeepVoice3 builder of the PyTorch port against the JAX
package on the CPU, at narrow widths with 5 speakers
(tests/torch_port_common.py:TINY_MULTISPEAKER), with the JAX parameters
loaded into the port:

  * a GLU layer with a speaker projection, full-sequence and one frame at
    a time: <= 1e-6 of the output's scale (tests/test_torch_ops.py's bar);
  * `model_forward` with speaker ids, JAX under `strict_numerics`: <= 1e-5
    (the speaker embedding reaches the encoder's softsign biases, every GLU
    layer, the per-sample key and query position rates, and the converter,
    which expands it again after each upsampling);
  * `decoder_decode` against the fused Pallas decoder in interpret mode,
    with its speaker biases and per-sample query rates: frames, alignments,
    done and decoder states <= 2e-5; lengths, num_steps and last_attended
    exact (tests/test_torch_fused_decode.py's bars);
  * `tts_batch` with speaker ids against JAX's: the bars of
    tests/test_torch_synthesis.py;
  * `tts_stream` with speaker ids against JAX's stream: the bars of
    tests/test_torch_streaming.py but one (see the test).
"""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import builder as jb
from deepvoice3_pytorch_tpu import streaming as j_stream
from deepvoice3_pytorch_tpu import synthesis as j_syn
from deepvoice3_pytorch_tpu.dsp import reference_model as ref
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAP
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
from deepvoice3_pytorch_tpu.models import decode as j_decode
from deepvoice3_pytorch_tpu.models import deepvoice3 as j_dv3
from deepvoice3_pytorch_tpu.ops import conv_blocks as j_cb
from deepvoice3_pytorch_tpu.ops import core as j_core
from deepvoice3_pytorch_tpu.ops import fused_decode as j_fd
from deepvoice3_pytorch_tpu_torch import builder as tb
from deepvoice3_pytorch_tpu_torch import streaming as t_stream
from deepvoice3_pytorch_tpu_torch import synthesis as t_syn
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAP
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams as t_hparams
from deepvoice3_pytorch_tpu_torch.models import decode as t_decode
from deepvoice3_pytorch_tpu_torch.models import deepvoice3 as t_dv3
from deepvoice3_pytorch_tpu_torch.ops import conv_blocks as t_cb
from deepvoice3_pytorch_tpu_torch.ops import core as t_core
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as t_fd

from torch_port_common import (jax_params, maxdiff, port_params, t,
                               text_inputs, tiny_configs)

TOL = 2e-5
SPK = np.asarray([1, 4, 2])
TEXTS = ["Hello world.", "Printing, in the only sense.", "A test."]


def _close(got, want, tol=1e-6):
    scale = max(1.0, float(np.abs(np.asarray(want, np.float64)).max()))
    return maxdiff(got, want) <= tol * scale


@pytest.mark.parametrize("kw,dilation,causal,residual", [
    (3, 1, True, False), (3, 9, True, True), (3, 3, False, True)])
def test_speaker_glu_block_matches_jax(kw, dilation, causal, residual):
    """softsign(speaker_proj(embed)) added to the value half before the
    gate: full sequence with a (B, T, D) embedding, and for causal layers
    frame by frame with a (B, D) one against ring buffers."""
    rs = np.random.RandomState(8)
    C, D = 16, 8
    sj = j_cb.glu_spec(C, C, kw, dilation, causal, residual, 4.0, 0.05,
                       multispeaker=True)
    st = t_cb.glu_spec(C, C, kw, dilation, causal, residual, 4.0, 0.05,
                       multispeaker=True)
    assert dataclasses.asdict(sj) == dataclasses.asdict(st)
    raw = {"conv": {"v": rs.randn(kw, C, 2 * C).astype(np.float32) * 0.3,
                    "g": (rs.rand(2 * C) + 0.5).astype(np.float32),
                    "b": rs.randn(2 * C).astype(np.float32) * 0.1},
           "speaker_proj": {"v": rs.randn(D, C).astype(np.float32),
                            "g": (rs.rand(C) + 0.5).astype(np.float32),
                            "b": rs.randn(C).astype(np.float32)}}
    pj = {k: {kk: jnp.asarray(v) for kk, v in d.items()}
          for k, d in raw.items()}
    pt = {k: {kk: t(v) for kk, v in d.items()} for k, d in raw.items()}
    B, T = 2, 9
    xs = rs.randn(B, T, C).astype(np.float32)
    se = rs.randn(B, D).astype(np.float32)
    se_btc = np.broadcast_to(se[:, None], (B, T, D))
    full_t = t_cb.spec_apply(pt, st, t(xs), speaker_embed_btc=t(se_btc))
    assert _close(full_t, j_cb.spec_apply(pj, sj, jnp.asarray(xs),
                                          speaker_embed_btc=jnp.asarray(
                                              se_btc)))
    # the bias moves the output: without the embedding it differs
    assert maxdiff(t_cb.spec_apply(pt, st, t(xs)), full_t) > 1e-3
    if not causal:
        return
    state_j = j_cb.spec_init_state(sj, B)
    state_t = t_cb.spec_init_state(st, B)
    outs = []
    for i in range(T):
        state_j, yj = j_cb.spec_step(pj, sj, state_j, jnp.asarray(xs[:, i]),
                                     speaker_embed=jnp.asarray(se))
        state_t, yt = t_cb.spec_step(pt, st, state_t, t(xs[:, i]),
                                     speaker_embed=t(se))
        assert _close(yt, yj)
        assert maxdiff(state_t, state_j) == 0.0
        outs.append(yt)
    assert _close(torch.stack(outs, 1), full_t)


def test_model_forward_matches_jax():
    cfg_j, cfg_t = tiny_configs("deepvoice3_multispeaker")
    pj = jax_params(cfg_j, seed=5)
    pt = port_params(pj, cfg_t)
    x, pos, lengths = text_inputs()
    rs = np.random.RandomState(1)
    mel = rs.rand(3, 10, cfg_j.mel_dim).astype(np.float32)
    fpos = np.tile(np.arange(1, 11), (3, 1))
    with j_core.strict_numerics():
        out_j = jb.model_forward(
            pj, cfg_j, jnp.asarray(x), jnp.asarray(mel),
            speaker_ids=jnp.asarray(SPK), text_positions=jnp.asarray(pos),
            frame_positions=jnp.asarray(fpos),
            input_lengths=jnp.asarray(lengths))
    out_t = tb.model_forward(pt, cfg_t, t(x), t(mel), speaker_ids=t(SPK),
                             text_positions=t(pos), frame_positions=t(fpos),
                             input_lengths=t(lengths))
    for name, a, b in zip(("mel", "linear", "alignments", "done"), out_t,
                          out_j):
        assert tuple(a.shape) == tuple(b.shape), name
        assert maxdiff(a, b) <= 1e-5, name
    # another speaker gives another output
    other = tb.model_forward(pt, cfg_t, t(x), t(mel),
                             speaker_ids=t(SPK[::-1].copy()),
                             text_positions=t(pos), frame_positions=t(fpos),
                             input_lengths=t(lengths))
    assert maxdiff(other[0], out_t[0]) > 1e-4


def test_speaker_ids_need_a_multi_speaker_model():
    _, cfg_t = tiny_configs()
    with pytest.raises(ValueError):
        tb.embed_speakers({}, cfg_t, t(SPK))
    assert tb.embed_speakers({}, cfg_t, None) is None


@pytest.mark.parametrize("ids", [[0, 5], [-1], [1, 2, 99]])
def test_speaker_ids_out_of_range_raise(ids):
    """An id outside [0, n_speakers) raises on the host, before it can
    index the speaker table on the card (an HTTP request's speaker_id
    reaches tts_stream this way)."""
    _, cfg_t = tiny_configs("deepvoice3_multispeaker")
    with pytest.raises(ValueError):
        t_syn.speaker_id_tensor(cfg_t, ids, "cpu")
    got = t_syn.speaker_id_tensor(cfg_t, [0, 4], "cpu")
    assert got.dtype == torch.int64 and got.tolist() == [0, 4]


def _setup(fc_bias=0.0, **kw):
    cfg_j, cfg_t = tiny_configs("deepvoice3_multispeaker", **kw)
    pj = jax_params(cfg_j)
    pj["decoder"]["fc"]["b"] = pj["decoder"]["fc"]["b"] + fc_bias
    pt = port_params(pj, cfg_t)
    x, pos, lengths = text_inputs()
    se_j = jb.core.embedding_apply(pj["embed_speakers"], jnp.asarray(SPK))
    se_t = tb.embed_speakers(pt, cfg_t, t(SPK))
    enc_j = j_dv3.encoder_apply(pj["encoder"], cfg_j.encoder, jnp.asarray(x),
                                speaker_embed=se_j)
    enc_t = t_dv3.encoder_apply(pt["encoder"], cfg_t.encoder, t(x),
                                speaker_embed=se_t)
    assert maxdiff(enc_t[0], enc_j[0]) <= 1e-5
    return cfg_j, cfg_t, pj, pt, enc_j, enc_t, se_j, se_t, pos, lengths


@pytest.mark.parametrize("monotonic,use_lengths", [
    (True, True), (False, True), (True, False)])
def test_decode_matches_jax_fused(monotonic, use_lengths):
    (cfg_j, cfg_t, pj, pt, enc_j, enc_t, se_j, se_t, pos,
     lengths) = _setup(force_monotonic_attention=monotonic)
    T = 11
    out_j = j_dv3.decoder_decode(
        pj["decoder"], cfg_j.decoder, enc_j, jnp.asarray(pos),
        speaker_embed=se_j,
        lengths=jnp.asarray(lengths) if use_lengths else None,
        max_decoder_steps=T, early_exit=False, fused=True)
    out_t = t_dv3.decoder_decode(
        pt["decoder"], cfg_t.decoder, enc_t, t(pos), speaker_embed=se_t,
        lengths=t(lengths) if use_lengths else None,
        max_decoder_steps=T, early_exit=False)
    for name in ("outputs", "alignments", "done", "decoder_states"):
        d = maxdiff(getattr(out_t, name), getattr(out_j, name))
        assert d <= TOL, (name, d)
    assert (out_t.lengths.numpy() == np.asarray(out_j.lengths)).all()
    assert out_t.num_steps == int(out_j.num_steps) == T


def test_fused_decode_inputs_and_last_attended_match_jax():
    """The launch inputs (per-sample query rates, the six speaker biases in
    plan order, raw angle rows) equal JAX's, and the decode's last_attended
    equals the JAX kernel's carry-out exactly."""
    (cfg_j, cfg_t, pj, pt, enc_j, enc_t, se_j, se_t, pos,
     lengths) = _setup()
    T = 11
    fi_j = j_dv3.fused_decode_inputs(pj["decoder"], cfg_j.decoder, enc_j,
                                     jnp.asarray(pos), T, speaker_embed=se_j)
    fi_t = t_dv3.fused_decode_inputs(pt["decoder"], cfg_t.decoder, enc_t,
                                     t(pos), T, speaker_embed=se_t)
    assert fi_t["fpe_raw"] and len(fi_t["speaker_bias"]) == 6
    assert _close(fi_t["w_query"], fi_j["w_query"])
    assert maxdiff(fi_t["fpe_table"], fi_j["fpe_table"]) == 0.0
    for a, b in zip(fi_t["speaker_bias"], fi_j["speaker_bias"]):
        assert _close(a, b)
    plan = t_fd.build_plan(pt["decoder"], cfg_t.decoder)
    assert plan.sp_widths == (32,) * 6

    mask_j = jnp.arange(12)[None, :] >= jnp.asarray(lengths)[:, None]
    prep = j_fd._Prepared(pj["decoder"], cfg_j.decoder, fi_j["projected_kv"],
                          mask_j, w_query=fi_j["w_query"],
                          speaker_bias=fi_j["speaker_bias"], fpe_raw=True)
    la0, bufs0 = prep.zero_carry()
    init = jnp.zeros((3, cfg_j.decoder.in_dim), jnp.float32)
    (o_j, _, _, _), (_, la_j, _) = prep.launch(fi_j["fpe_table"], init, la0,
                                               bufs0, T, True)
    out = t_fd.fused_decode(
        pt["decoder"], cfg_t.decoder, fi_t,
        t_core.get_mask_from_lengths(t(lengths), 12),
        torch.zeros(3, cfg_t.decoder.in_dim), T,
        cfg_t.decoder.min_decoder_steps, early_exit=False)
    assert maxdiff(out.outputs, o_j) <= TOL
    assert (out.last_attended.numpy() == np.asarray(la_j)).all()


@pytest.mark.parametrize("chunk,fc_bias", [(4, 0.0), (5, 0.0), (4, 100.0),
                                           (3, -2.0)])
def test_chunked_early_exit_matches_jax(chunk, fc_bias):
    """Against `fused_decode_chunked` with the speaker biases and rates:
    same frames, the same number of computed steps, exact lengths."""
    (cfg_j, cfg_t, pj, pt, enc_j, enc_t, se_j, se_t, pos,
     lengths) = _setup(fc_bias=fc_bias)
    T, min_steps = 23, 2
    fi_j = j_dv3.fused_decode_inputs(pj["decoder"], cfg_j.decoder, enc_j,
                                     jnp.asarray(pos), T, speaker_embed=se_j)
    mask_j = jnp.arange(12)[None, :] >= jnp.asarray(lengths)[:, None]
    o_j, a_j, d_j, s_j, n_j = j_fd.fused_decode_chunked(
        pj["decoder"], cfg_j.decoder, fi_j["projected_kv"],
        fi_j["fpe_table"], mask_j,
        jnp.zeros((3, cfg_j.decoder.in_dim), jnp.float32), T, min_steps,
        chunk=chunk, w_query=fi_j["w_query"],
        speaker_bias=fi_j["speaker_bias"], fpe_raw=True, interpret=True)
    fi_t = t_dv3.fused_decode_inputs(pt["decoder"], cfg_t.decoder, enc_t,
                                     t(pos), T, speaker_embed=se_t)
    out = t_fd.fused_decode(
        pt["decoder"], cfg_t.decoder, fi_t,
        t_core.get_mask_from_lengths(t(lengths), 12),
        torch.zeros(3, cfg_t.decoder.in_dim), T, min_steps,
        early_exit=True, chunk=chunk)
    assert out.num_steps == int(n_j)
    if fc_bias > 0:
        assert out.num_steps < T
    for name, a, b in (("outputs", out.outputs, o_j),
                       ("alignments", out.alignments, a_j),
                       ("done", out.done, d_j),
                       ("decoder_states", out.decoder_states, s_j)):
        d = maxdiff(a, b)
        assert d <= TOL, (name, d)
    len_j = j_decode._length_from_done(d_j, min_steps, n_j)
    len_t = t_decode._length_from_done(out.done, min_steps, out.num_steps)
    assert (len_t.numpy() == np.asarray(len_j)).all()


# ---------------------------------------------------------------------------
# synthesis and streaming
# ---------------------------------------------------------------------------


def _hp(lib):
    hp = lib()
    hp.fft_size, hp.hop_size, hp.num_mels = 128, 32, 16
    return hp


@pytest.fixture(scope="module")
def batches():
    cfg_j, cfg_t = tiny_configs("deepvoice3_multispeaker")
    pj = jax_params(cfg_j, seed=3)
    pt = port_params(pj, cfg_t)
    mp = pytest.MonkeyPatch()
    mp.setenv("DV3_PALLAS_GL", "1")
    try:
        res_j = j_syn.tts_batch(pj, cfg_j, JAP(_hp(j_hparams)), j_en, TEXTS,
                                speaker_ids=list(SPK), max_decoder_steps=11,
                                fused=True)
    finally:
        mp.undo()
    res_t = t_syn.tts_batch(pt, cfg_t, TAP(_hp(t_hparams)), t_en, TEXTS,
                            speaker_ids=list(SPK), max_decoder_steps=11)
    return res_j, res_t, pt, cfg_t


@pytest.mark.parametrize("key,unit", [("mel", 100.0), ("linear", 100.0),
                                      ("alignment", 1.0)])
def test_tts_batch_features_match_jax(batches, key, unit):
    res_j, res_t, _, _ = batches
    for rj, rt in zip(res_j, res_t):
        assert rt["num_decoder_steps"] == rj["num_decoder_steps"]
        assert maxdiff(rt[key], rj[key]) / unit <= 2e-5, key


def test_tts_batch_waveforms_match_jax(batches):
    res_j, res_t, _, _ = batches
    ap = TAP(_hp(t_hparams))
    for rj, rt in zip(res_j, res_t):
        wj, wt = rj["waveform"], rt["waveform"]
        assert wt.shape == wj.shape == (rj["num_decoder_steps"] * 4 * 32,)
        assert np.isfinite(wt).all()
        assert maxdiff(wt, wj) < 0.12 * np.abs(wj).max()
        S = ap._denorm_pow(torch.from_numpy(
            (rj["linear"] - ap.min_level_db) / -ap.min_level_db)).numpy()
        sc_t, sc_j = (ref.spectral_convergence(
            ref._preemphasis(w, ap.preemphasis_coef), S, 128, 32)
            for w in (wt, wj))
        assert sc_t <= 1.05 * sc_j, (sc_t, sc_j)


def test_tts_single_speaker_id_equals_batch_of_one(batches):
    _, _, pt, cfg_t = batches
    ap = TAP(_hp(t_hparams))
    wav, align, lin, mel = t_syn.tts(pt, cfg_t, ap, t_en, TEXTS[1],
                                     speaker_id=4, max_decoder_steps=11)
    rt = t_syn.tts_batch(pt, cfg_t, ap, t_en, TEXTS[1:2], speaker_ids=[4],
                         max_decoder_steps=11)[0]
    for a, key in ((wav, "waveform"), (align, "alignment"), (lin, "linear"),
                   (mel, "mel")):
        assert np.array_equal(a, rt[key]), key


def test_stream_matches_jax_stream():
    """tts_stream with speaker ids against JAX's stream of the same model
    at the default audio configuration (fft 1024, hop 256), as
    tests/test_torch_streaming.py runs it: per-chunk sample counts and
    decoded steps exact, linear frames 1e-4, spectral convergence of the
    audio within 1.05x of JAX's (that file's bars). That file's further
    bar of 0.12 of the peak sample by sample does not hold for this input
    (0.156 measured): JAX's CPU stream vocodes with f32 carries, the port
    with the kernel's bf16 schedule, and 32 iterations a window amplify
    the rounding apart; B2's stream modes are held tightly, per window, in
    tests/test_torch_streaming.py."""
    cfg_j, cfg_t = tiny_configs("deepvoice3_multispeaker", mel_dim=80,
                                linear_dim=513)
    pj = jax_params(cfg_j, seed=3)
    pt = port_params(pj, cfg_t)
    kw = dict(speaker_ids=list(SPK), max_decoder_steps=24, first_chunk=8,
              chunk=8, gl_context=8, emit_linear=True)
    js = list(j_stream.tts_stream(pj, cfg_j, JAP(j_hparams()), j_en,
                                  TEXTS, **kw))
    ap = TAP(t_hparams())
    ts = list(t_stream.tts_stream(pt, cfg_t, ap, t_en, TEXTS, **kw))
    assert [c["audio"].shape for c in ts] == [c["audio"].shape for c in js]
    np.testing.assert_array_equal(ts[-1]["decoded_steps"],
                                  js[-1]["decoded_steps"])
    lin_t = np.concatenate([c["linear"] for c in ts], axis=1)
    lin_j = np.concatenate([c["linear"] for c in js], axis=1)
    assert maxdiff(lin_t, lin_j) <= 1e-4
    at = np.concatenate([c["audio"] for c in ts], axis=1)
    aj = np.concatenate([c["audio"] for c in js], axis=1)
    assert np.isfinite(at).all()
    S = ap._denorm_pow(torch.from_numpy(lin_j)).numpy()
    for i in range(len(TEXTS)):
        coef = ap.preemphasis_coef
        sc_t = ref.spectral_convergence(
            ref._preemphasis(at[i].astype(np.float64), coef), S[i], 1024,
            256)
        sc_j = ref.spectral_convergence(
            ref._preemphasis(aj[i].astype(np.float64), coef), S[i], 1024,
            256)
        assert sc_t <= 1.05 * sc_j, (i, sc_t, sc_j)
