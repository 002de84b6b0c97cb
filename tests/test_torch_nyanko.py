# coding: utf-8
"""The nyanko builder of the PyTorch port against the JAX package on the
CPU, at narrow widths (tests/torch_port_common.py:TINY_NYANKO), with the
JAX parameters loaded into the port:

  * highway blocks, full-sequence and one frame at a time against ring
    buffers: <= 1e-6 of the output's scale (tests/test_torch_ops.py's bar);
  * `model_forward`, JAX under `strict_numerics`: <= 1e-5;
  * `decoder_decode` against the fused Pallas decoder in interpret mode
    (whole and chunked with early exit): frames, alignments, done and
    decoder states <= 2e-5, lengths, num_steps and last_attended exact
    (tests/test_torch_fused_decode.py's bars). On the CPU the port runs the
    plain version of kernel B1, the eager nyanko step, so this pins what
    the CUDA kernel's highway / save_q / linear2 ops and finished position
    encodings are held to on the card;
  * `tts_batch` against JAX's with the Pallas Griffin-Lim: the bars of
    tests/test_torch_synthesis.py;
  * `tts_stream`'s linear frames against one decode + `model_postnet`:
    2e-4 (tests/test_streaming.py:151);
  * `params_from_jax` for all three builders: keys and shapes exact, a
    wrong shape raises.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import builder as jb
from deepvoice3_pytorch_tpu import streaming as j_stream
from deepvoice3_pytorch_tpu import synthesis as j_syn
from deepvoice3_pytorch_tpu.dsp import reference_model as ref
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAP
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
from deepvoice3_pytorch_tpu.model_builder import build_config as j_config
from deepvoice3_pytorch_tpu.models import decode as j_decode
from deepvoice3_pytorch_tpu.models import nyanko as j_nk
from deepvoice3_pytorch_tpu.ops import conv_blocks as j_cb
from deepvoice3_pytorch_tpu.ops import core as j_core
from deepvoice3_pytorch_tpu.ops import fused_decode as j_fd
from deepvoice3_pytorch_tpu_torch import builder as tb
from deepvoice3_pytorch_tpu_torch import streaming as t_stream
from deepvoice3_pytorch_tpu_torch import synthesis as t_syn
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAP
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams as t_hparams
from deepvoice3_pytorch_tpu_torch.model_builder import build_config as t_config
from deepvoice3_pytorch_tpu_torch.models import decode as t_decode
from deepvoice3_pytorch_tpu_torch.models import nyanko as t_nk
from deepvoice3_pytorch_tpu_torch.ops import conv_blocks as t_cb
from deepvoice3_pytorch_tpu_torch.ops import core as t_core
from deepvoice3_pytorch_tpu_torch.ops import fused_decode as t_fd
from deepvoice3_pytorch_tpu_torch.params import (flatten_tree, model_init,
                                                 params_from_jax)

from torch_port_common import (jax_params, maxdiff, port_params, t,
                               text_inputs, tiny_configs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
TEXTS = ["Hello world.", "Printing, in the only sense.", "A test."]


def _close(got, want, tol=1e-6):
    scale = max(1.0, float(np.abs(np.asarray(want, np.float64)).max()))
    return maxdiff(got, want) <= tol * scale


# ---------------------------------------------------------------------------
# highway blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("glu,kw,dilation,causal", [
    (False, 3, 1, False), (False, 3, 3, False), (False, 1, 1, False),
    (True, 3, 1, True), (True, 3, 9, True)])
def test_highway_block_matches_jax(glu, kw, dilation, causal):
    """Full sequence against JAX; for causal layers also frame by frame
    against ring buffers (outputs and buffers), and the frames against the
    full sequence."""
    rs = np.random.RandomState(7)
    C = 16
    sj = j_cb.highway_spec(C, C, kw, dilation, causal, 0.05, glu=glu)
    st = t_cb.highway_spec(C, C, kw, dilation, causal, 0.05, glu=glu)
    assert dataclasses.asdict(sj) == dataclasses.asdict(st)
    conv = {"v": rs.randn(kw, C, 2 * C).astype(np.float32) * 0.3,
            "g": (rs.rand(2 * C) + 0.5).astype(np.float32),
            "b": rs.randn(2 * C).astype(np.float32) * 0.1}
    pj = {"conv": {k: jnp.asarray(v) for k, v in conv.items()}}
    pt = {"conv": {k: t(v) for k, v in conv.items()}}
    B, T = 2, 9
    xs = rs.randn(B, T, C).astype(np.float32)
    full_t = t_cb.spec_apply(pt, st, t(xs))
    assert _close(full_t, j_cb.spec_apply(pj, sj, jnp.asarray(xs)))
    if not causal:
        return
    state_j = j_cb.spec_init_state(sj, B)
    state_t = t_cb.spec_init_state(st, B)
    outs = []
    for i in range(T):
        state_j, yj = j_cb.spec_step(pj, sj, state_j, jnp.asarray(xs[:, i]))
        state_t, yt = t_cb.spec_step(pt, st, state_t, t(xs[:, i]))
        assert _close(yt, yj)
        assert maxdiff(state_t, state_j) == 0.0
        outs.append(yt)
    assert _close(torch.stack(outs, 1), full_t)


# ---------------------------------------------------------------------------
# model_forward and the decode
# ---------------------------------------------------------------------------


def _setup(fc_bias=0.0, **kw):
    cfg_j, cfg_t = tiny_configs("nyanko", **kw)
    pj = jax_params(cfg_j)
    pj["decoder"]["fc"]["b"] = pj["decoder"]["fc"]["b"] + fc_bias
    pt = port_params(pj, cfg_t)
    x, pos, lengths = text_inputs()
    enc_j = j_nk.encoder_apply(pj["encoder"], cfg_j.encoder, jnp.asarray(x))
    enc_t = t_nk.encoder_apply(pt["encoder"], cfg_t.encoder, t(x))
    assert maxdiff(enc_t[0], enc_j[0]) <= 1e-5
    assert maxdiff(enc_t[1], enc_j[1]) <= 1e-5
    return cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths


def test_model_forward_matches_jax():
    cfg_j, cfg_t = tiny_configs("nyanko")
    pj = jax_params(cfg_j, seed=5)
    pt = port_params(pj, cfg_t)
    x, pos, lengths = text_inputs()
    rs = np.random.RandomState(1)
    mel = rs.rand(3, 10, cfg_j.mel_dim).astype(np.float32)
    fpos = np.tile(np.arange(1, 11), (3, 1))
    with j_core.strict_numerics():
        out_j = jb.model_forward(
            pj, cfg_j, jnp.asarray(x), jnp.asarray(mel),
            text_positions=jnp.asarray(pos),
            frame_positions=jnp.asarray(fpos),
            input_lengths=jnp.asarray(lengths))
    out_t = tb.model_forward(pt, cfg_t, t(x), t(mel), text_positions=t(pos),
                             frame_positions=t(fpos), input_lengths=t(lengths))
    for name, a, b in zip(("mel", "linear", "alignments", "done"), out_t,
                          out_j):
        assert tuple(a.shape) == tuple(b.shape), name
        assert maxdiff(a, b) <= 1e-5, name
    assert tuple(out_t[1].shape) == (3, 40, cfg_t.linear_dim)


@pytest.mark.parametrize("monotonic,use_lengths", [
    (True, True), (False, True), (True, False)])
def test_decode_matches_jax_fused(monotonic, use_lengths):
    cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths = _setup(
        force_monotonic_attention=monotonic)
    T = 11
    out_j = j_nk.decoder_decode(
        pj["decoder"], cfg_j.decoder, enc_j, jnp.asarray(pos),
        lengths=jnp.asarray(lengths) if use_lengths else None,
        max_decoder_steps=T, early_exit=False, fused=True)
    out_t = t_nk.decoder_decode(
        pt["decoder"], cfg_t.decoder, enc_t, t(pos),
        lengths=t(lengths) if use_lengths else None,
        max_decoder_steps=T, early_exit=False)
    for name in ("outputs", "alignments", "done", "decoder_states"):
        d = maxdiff(getattr(out_t, name), getattr(out_j, name))
        assert d <= TOL, (name, d)
    assert (out_t.lengths.numpy() == np.asarray(out_j.lengths)).all()
    assert out_t.num_steps == int(out_j.num_steps) == T


def test_last_attended_carry_exact():
    cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths = _setup()
    T = 11
    fi_j = j_nk.fused_decode_inputs(pj["decoder"], cfg_j.decoder, enc_j,
                                    jnp.asarray(pos), T)
    mask_j = jnp.arange(12)[None, :] >= jnp.asarray(lengths)[:, None]
    prep = j_fd._Prepared(pj["decoder"], cfg_j.decoder, fi_j["projected_kv"],
                          mask_j, w_query=None, speaker_bias=None,
                          fpe_raw=False)
    la0, bufs0 = prep.zero_carry()
    init = jnp.zeros((3, cfg_j.decoder.in_dim), jnp.float32)
    (o_j, _, _, _), (_, la_j, _) = prep.launch(fi_j["fpe_table"], init, la0,
                                               bufs0, T, True)
    fi_t = t_nk.fused_decode_inputs(pt["decoder"], cfg_t.decoder, enc_t,
                                    t(pos), T)
    assert not fi_t["fpe_raw"]
    assert maxdiff(fi_t["fpe_table"], fi_j["fpe_table"]) == 0.0
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
    """Against `fused_decode_chunked`: same frames, the same number of
    computed steps and exact per-sample lengths. fc_bias +100 makes every
    done flag fire at once."""
    cfg_j, cfg_t, pj, pt, enc_j, enc_t, pos, lengths = _setup(fc_bias=fc_bias)
    T, min_steps = 23, 2
    fi_j = j_nk.fused_decode_inputs(pj["decoder"], cfg_j.decoder, enc_j,
                                    jnp.asarray(pos), T)
    mask_j = jnp.arange(12)[None, :] >= jnp.asarray(lengths)[:, None]
    o_j, a_j, d_j, s_j, n_j = j_fd.fused_decode_chunked(
        pj["decoder"], cfg_j.decoder, fi_j["projected_kv"],
        fi_j["fpe_table"], mask_j,
        jnp.zeros((3, cfg_j.decoder.in_dim), jnp.float32), T, min_steps,
        chunk=chunk, interpret=True)
    fi_t = t_nk.fused_decode_inputs(pt["decoder"], cfg_t.decoder, enc_t,
                                    t(pos), T)
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


def test_plan_ops_and_ring_placement():
    """The nyanko plan: highway ops with their ring buffers, SAVE_Q before
    the attention and LINEAR2 after it. Kernel B1 keeps every row's ring
    buffers in device memory (at the preset's widths they take 256 rows x
    256 a row, more than a block's shared memory): each highway stage reads
    its own buffer, the attention reads Q plus the position rows, and
    LINEAR2 reads [R, Q]."""
    _, cfg_t = tiny_configs("nyanko")
    params = model_init(cfg_t, torch.Generator().manual_seed(0),
                        device="cpu")
    plan = t_fd.build_plan(params["decoder"], cfg_t.decoder)
    kinds = plan.ops[:, 0].tolist()
    i_att = kinds.index(t_fd.OP_ATTN)
    assert kinds[i_att - 1] == t_fd.OP_SAVE_Q
    assert kinds[i_att + 1] == t_fd.OP_LINEAR2
    assert kinds.count(t_fd.OP_HIGHWAY) == 16 and plan.n_att == 1
    assert [r for r, _, _ in plan.buffers] == [
        2, 6, 18, 54, 2, 6, 18, 54, 6, 6, 2, 6, 18, 54, 2, 2]

    C = cfg_t.decoder.channels
    stages, widths = t_fd.b1_stages(plan, C,
                                    cfg_t.decoder.in_dim * cfg_t.decoder.r)
    words = [st.words for st in stages]
    hw = [w for w in words if w[t_fd.S_EPI] == t_fd.E_HW
          and w[t_fd.S_KIND] == t_fd.K_MV]
    assert [w[t_fd.S_RING] for w in hw] == list(range(16))
    # ring buffers tile the carry row without overlap, in buffer order
    spans = [(off, off + r * c) for r, c, off in plan.buffers]
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    i_q = next(i for i, w in enumerate(words) if w[t_fd.S_KIND] == t_fd.K_ATT)
    l2 = next(w for w in words if w[t_fd.S_IN2] >= 0)
    # the stage before the attention writes Q and Q + the position rows
    assert words[i_q - 1][t_fd.S_QOUT] == words[i_q][t_fd.S_IN]
    assert words[i_q - 1][t_fd.S_OUT] == l2[t_fd.S_IN2]
    assert l2[t_fd.S_K] == 2 * C and widths[l2[t_fd.S_IN]] == C
    # the preset's 16 buffers of 256 channels: 256 KiB a row
    assert 4 * 256 * sum(r for r, _, _ in plan.buffers) == 256 * 1024


# ---------------------------------------------------------------------------
# synthesis and streaming
# ---------------------------------------------------------------------------


def _hp(lib):
    hp = lib()
    hp.fft_size, hp.hop_size, hp.num_mels = 128, 32, 16
    return hp


@pytest.fixture(scope="module")
def batches():
    cfg_j, cfg_t = tiny_configs("nyanko")
    pj = jax_params(cfg_j, seed=3)
    pt = port_params(pj, cfg_t)
    mp = pytest.MonkeyPatch()
    mp.setenv("DV3_PALLAS_GL", "1")
    try:
        res_j = j_syn.tts_batch(pj, cfg_j, JAP(_hp(j_hparams)), j_en, TEXTS,
                                max_decoder_steps=11, fused=True)
    finally:
        mp.undo()
    res_t = t_syn.tts_batch(pt, cfg_t, TAP(_hp(t_hparams)), t_en, TEXTS,
                            max_decoder_steps=11)
    return res_j, res_t


@pytest.mark.parametrize("key,unit", [("mel", 100.0), ("linear", 100.0),
                                      ("alignment", 1.0)])
def test_tts_batch_features_match_jax(batches, key, unit):
    res_j, res_t = batches
    for rj, rt in zip(res_j, res_t):
        assert rt["num_decoder_steps"] == rj["num_decoder_steps"]
        assert maxdiff(rt[key], rj[key]) / unit <= 2e-5, key


def spectral_convergences(ap, res_t, res_j):
    """Spectral convergence of each port and JAX waveform against the
    magnitudes Griffin-Lim was given (the JAX linear output, before the
    inverse pre-emphasis), lws framing at the test's fft 128, hop 32."""
    out = []
    for rt, rj in zip(res_t, res_j):
        S = ap._denorm_pow(torch.from_numpy(
            (rj["linear"] - ap.min_level_db) / -ap.min_level_db)).numpy()
        out.append([ref.spectral_convergence(
            ref._preemphasis(r["waveform"], ap.preemphasis_coef), S, 128, 32)
            for r in (rt, rj)])
    return out


def test_tts_batch_waveforms_match_jax(batches):
    """Waveforms of the decoded length, finite, and as good a phase
    retrieval as JAX's: spectral convergence within 1.05x (the quality bar
    of tests/test_torch_streaming.py). Not 0.12 of the peak sample by
    sample: this tiny random nyanko makes nearly flat spectra, on which 16
    bf16 Griffin-Lim iterations turn rounding flips of two correct
    implementations into 4-54 % of the peak (seeds 3-5 on this input),
    while their spectral convergences agree to 0.3 %."""
    res_j, res_t = batches
    for rj, rt in zip(res_j, res_t):
        wj, wt = rj["waveform"], rt["waveform"]
        assert wt.shape == wj.shape == (rj["num_decoder_steps"] * 4 * 32,)
        assert np.isfinite(wt).all()
    for sc_t, sc_j in spectral_convergences(TAP(_hp(t_hparams)), res_t,
                                            res_j):
        assert sc_t <= 1.05 * sc_j, (sc_t, sc_j)


def test_stream_matches_decode_and_postnet():
    """Streamed linear frames equal one decode of the same length followed
    by model_postnet (the JAX test's contract, tests/test_streaming.py:151),
    and the converter's context equals JAX's for the highway converter."""
    cfg_j, cfg_t = tiny_configs("nyanko")
    assert t_stream.converter_context(cfg_t.converter) == \
        j_stream.converter_context(cfg_j.converter)
    pt = port_params(jax_params(cfg_j, seed=3), cfg_t)
    ap = TAP(_hp(t_hparams))
    texts = TEXTS
    chunks = list(t_stream.tts_stream(pt, cfg_t, ap, t_en, texts,
                                      max_decoder_steps=32, first_chunk=16,
                                      chunk=8, gl_context=8,
                                      emit_linear=True))
    assert chunks[-1]["final"]
    dec_steps = sum(c["linear"].shape[1] for c in chunks) // 4
    lin = np.concatenate([c["linear"] for c in chunks], axis=1)
    x, pos, lengths = (torch.from_numpy(a) for a in
                       t_syn._prepare_batch(t_en, texts, 0.0, 8))
    with torch.inference_mode():
        _, pin, _, _, dec_len = tb.model_decode(
            pt, cfg_t, x, pos, input_lengths=lengths,
            max_decoder_steps=dec_steps, early_exit=False)
        full = tb.model_postnet(pt, cfg_t, pin)
    assert lin.shape == tuple(full.shape)
    assert maxdiff(lin, full) <= 2e-4
    audio = np.concatenate([c["audio"] for c in chunks], axis=1)
    assert audio.shape == (3, lin.shape[1] * ap.hop_size)
    assert np.isfinite(audio).all()
    assert (chunks[-1]["decoded_steps"] <= dec_steps).all()


# ---------------------------------------------------------------------------
# parameters and presets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("builder", ["deepvoice3", "nyanko",
                                     "deepvoice3_multispeaker"])
def test_params_from_jax_keys_and_shapes(builder):
    """params_from_jax carries every builder's JAX parameters across with
    the key and shape check; model_init's keys and shapes equal JAX's; a
    wrong shape raises."""
    cfg_j, cfg_t = tiny_configs(builder)
    pj = jax_params(cfg_j)
    want = {k: tuple(np.shape(v)) for k, v in flatten_tree(pj).items()}
    sd = params_from_jax(pj, cfg_t)
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    init = model_init(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in init.state_dict().items()} == want
    bad = dict(pj, decoder=dict(pj["decoder"]))
    bad["decoder"]["fc"] = dict(pj["decoder"]["fc"],
                                b=np.zeros(2, np.float32))
    with pytest.raises(ValueError):
        params_from_jax(bad, cfg_t)


@pytest.mark.parametrize("preset", ["nyanko_ljspeech",
                                    "deepvoice3_vctk"])
def test_preset_configs_equal_jax(preset):
    """build_config gives the JAX package's configuration for both presets,
    and model_init's shapes at full width equal the ones JAX's init would
    give (param_shapes from the same configs)."""
    with open(os.path.join(REPO, "presets", preset + ".json")) as f:
        text = f.read()
    hj, ht = j_hparams(), t_hparams()
    hj.parse_json(text)
    ht.parse_json(text)
    cj, ct = j_config(hj, j_en.n_vocab), t_config(ht, t_en.n_vocab)
    assert ct.builder == cj.builder
    for part in ("encoder", "decoder", "converter"):
        assert dataclasses.asdict(getattr(ct, part)) == \
            dataclasses.asdict(getattr(cj, part)), part
    shapes_j = jax.eval_shape(lambda: jb.model_init(jax.random.PRNGKey(0),
                                                    cj))
    want = {k: tuple(v.shape) for k, v in flatten_tree(shapes_j).items()}
    from deepvoice3_pytorch_tpu_torch.params import param_shapes
    assert {k: tuple(v.shape) for k, v in param_shapes(ct).items()} == want
