# coding: utf-8
"""Teacher-forced incremental decode, `model_synthesize` and the general
convolutions of the PyTorch port against the JAX package on the CPU, at
narrow widths (tests/torch_port_common.py), inputs from
np.random.RandomState, the JAX parameters loaded into the port:

  * `decoder_decode(test_inputs=)` of all three builders (deepvoice3 and
    the multi-speaker model at r = 4, nyanko at r = 1) against JAX's
    (`decode_scan` over the teacher's frames): outputs, decoder states,
    done and alignments <= 1e-5, lengths and num_steps exact. On the CPU
    the port runs the plain version of kernel B1, one frame a launch, as
    the kernel runs this route on the card;
  * the same decode against the port's own offline `decoder_apply`, the
    reference's "incremental == offline forward" invariant
    (tests/test_model_parity.py:test_offline_equals_online_decoder),
    monotonic attention off: <= 1e-5;
  * `model_synthesize` against JAX's with the fused Pallas decoder in
    interpret mode, early exit on (the port's host loop and JAX's
    `fused_decode_chunked` stop at the same chunk): 2e-5, the fused ==
    scan bar of tests/test_fused_decode.py; lengths and shapes exact;
  * `conv_transpose1d_apply` with kernel != stride against
    `lax.conv_transpose(..., "VALID")`: 1e-6 of the output's scale;
  * `conv1d_apply(padding=(l, r))` with a length-changing padding against
    JAX's (XLA's conv, its default lowering): 1e-6 of the output's scale,
    in both of the port's conv modes.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import builder as jb
from deepvoice3_pytorch_tpu.ops import core as j_core
from deepvoice3_pytorch_tpu_torch import builder as tb
from deepvoice3_pytorch_tpu_torch.ops import conv_cuda
from deepvoice3_pytorch_tpu_torch.ops import core as t_core

from torch_port_common import (jax_params, maxdiff, port_params, t,
                               text_inputs, tiny_configs)

TOL = 1e-5
SYNTH_TOL = 2e-5
B, T_TEXT, T_DEC = 2, 12, 10
# (builder, r): the deepvoice3 family at r = 4, nyanko at its only r = 1
BUILDERS = [("deepvoice3", 4), ("nyanko", 1), ("deepvoice3_multispeaker", 4)]


def _configs(builder, r, **kw):
    if r != 1:
        kw.update(r=r, downsample_step=r)
    return tiny_configs(builder, **kw)


def _inputs(cfg, seed=3):
    """Text, positions, lengths, speaker ids (None for one speaker) and
    (B, T_DEC, in_dim * r) teacher frames in [0, 1)."""
    x, pos, lengths = text_inputs(B, T_TEXT)
    rs = np.random.RandomState(seed)
    spk = (rs.randint(0, cfg.n_speakers, (B,)).astype(np.int32)
           if cfg.n_speakers > 1 else None)
    frames = rs.rand(B, T_DEC, cfg.mel_dim * cfg.r).astype(np.float32)
    return x, pos, lengths, spk, frames


def _port_encode(pt, cfg_t, x, spk):
    se = tb.embed_speakers(pt, cfg_t, None if spk is None else t(spk))
    enc = cfg_t.family.encoder_apply(pt["encoder"], cfg_t.encoder, t(x),
                                     speaker_embed=se)
    return enc, se


def _jax_encode(pj, cfg_j, x, spk):
    se = (None if spk is None else j_core.embedding_apply(
        pj["embed_speakers"], jnp.asarray(spk)))
    enc = cfg_j.family.encoder_apply(pj["encoder"], cfg_j.encoder,
                                     jnp.asarray(x), speaker_embed=se)
    return enc, se


@pytest.mark.parametrize("builder,r", BUILDERS)
def test_teacher_forced_decode_matches_jax(builder, r):
    cfg_j, cfg_t = _configs(builder, r)
    pj = jax_params(cfg_j)
    pt = port_params(pj, cfg_t)
    x, pos, lengths, spk, frames = _inputs(cfg_t)
    enc_j, se_j = _jax_encode(pj, cfg_j, x, spk)
    enc_t, se_t = _port_encode(pt, cfg_t, x, spk)
    out_j = cfg_j.family.decoder_decode(
        pj["decoder"], cfg_j.decoder, enc_j, jnp.asarray(pos),
        speaker_embed=se_j, lengths=jnp.asarray(lengths),
        test_inputs=jnp.asarray(frames))
    out_t = cfg_t.family.decoder_decode(
        pt["decoder"], cfg_t.decoder, enc_t, t(pos), speaker_embed=se_t,
        lengths=t(lengths), test_inputs=t(frames), max_decoder_steps=3,
        early_exit=True)
    for name in ("outputs", "decoder_states", "done", "alignments"):
        d = maxdiff(getattr(out_t, name), getattr(out_j, name))
        assert d <= TOL, (name, d)
    assert out_t.outputs.shape[1] == T_DEC
    assert (out_t.lengths.numpy() == np.asarray(out_j.lengths)).all()
    assert out_t.num_steps == int(out_j.num_steps) == T_DEC


@pytest.mark.parametrize("builder,r", BUILDERS)
def test_teacher_forced_decode_equals_offline_forward(builder, r):
    """Step t of the teacher-forced decode consumes frame t of the
    teacher, as the offline forward's frame t does, so the two agree."""
    _, cfg_t = _configs(builder, r, force_monotonic_attention=False)
    pt = port_params(jax_params(_configs(
        builder, r, force_monotonic_attention=False)[0]), cfg_t)
    x, pos, lengths, spk, frames = _inputs(cfg_t, seed=5)
    enc, se = _port_encode(pt, cfg_t, x, spk)
    fam, dc = cfg_t.family, cfg_t.decoder
    fpos = torch.arange(1, T_DEC + 1)[None, :].repeat(B, 1)
    off_out, off_align, off_done, off_states = fam.decoder_apply(
        pt["decoder"], dc, enc, t(frames), text_positions=t(pos),
        frame_positions=fpos, speaker_embed=se, lengths=t(lengths))
    on = fam.decoder_decode(pt["decoder"], dc, enc, t(pos),
                            speaker_embed=se, lengths=t(lengths),
                            test_inputs=t(frames))
    for name, a, b in (("outputs", on.outputs, off_out),
                       ("decoder_states", on.decoder_states, off_states),
                       ("done", on.done, off_done[..., 0]),
                       ("alignments", on.alignments, off_align.mean(0))):
        d = maxdiff(a, b)
        assert d <= TOL, (name, d)


@pytest.mark.parametrize("builder,r", BUILDERS)
@pytest.mark.parametrize("fc_bias", [0.0, 100.0])
def test_model_synthesize_matches_jax(builder, r, fc_bias):
    """Early exit on. fc_bias +100 makes every done flag fire, so both
    stop after the first 32-frame chunk of 40 frames."""
    cfg_j, cfg_t = _configs(builder, r)
    pj = jax_params(cfg_j)
    pj["decoder"]["fc"]["b"] = pj["decoder"]["fc"]["b"] + fc_bias
    pt = port_params(pj, cfg_t)
    x, pos, lengths, spk, _ = _inputs(cfg_t)
    steps = 40
    got = tb.model_synthesize(
        pt, cfg_t, t(x), t(pos), input_lengths=t(lengths),
        speaker_ids=None if spk is None else t(spk),
        max_decoder_steps=steps, early_exit=True)
    want = jb.model_synthesize(
        pj, cfg_j, jnp.asarray(x), jnp.asarray(pos),
        input_lengths=jnp.asarray(lengths),
        speaker_ids=None if spk is None else jnp.asarray(spk),
        max_decoder_steps=steps, early_exit=True, fused=True)
    for name, a, b in zip(("mel", "linear", "alignments", "done"), got,
                          want):
        d = maxdiff(a, b)
        assert d <= SYNTH_TOL, (name, d)
    assert (got[4].numpy() == np.asarray(want[4])).all()
    if fc_bias > 0:
        assert (got[4].numpy() == cfg_t.decoder.min_decoder_steps + 1).all()


def test_model_synthesize_teacher_forced_is_decode_then_postnet():
    cfg_j, cfg_t = _configs("deepvoice3", 4)
    pt = port_params(jax_params(cfg_j), cfg_t)
    x, pos, lengths, _, frames = _inputs(cfg_t)
    mel, lin, align, done, lens = tb.model_synthesize(
        pt, cfg_t, t(x), t(pos), input_lengths=t(lengths),
        test_inputs=t(frames))
    mel_d, post, align_d, done_d, lens_d = tb.model_decode(
        pt, cfg_t, t(x), t(pos), input_lengths=t(lengths),
        test_inputs=t(frames))
    assert mel.shape == (B, T_DEC * cfg_t.r, cfg_t.mel_dim)
    assert maxdiff(mel, mel_d) == maxdiff(done, done_d) == 0.0
    assert maxdiff(align, align_d) == 0.0
    assert maxdiff(lin, tb.model_postnet(pt, cfg_t, post)) == 0.0
    assert (lens == lens_d).all()


def _wn_params(rs, kw, cin, cout):
    return {"v": rs.randn(kw, cin, cout).astype(np.float32),
            "g": (rs.rand(cout) + 0.5).astype(np.float32),
            "b": rs.randn(cout).astype(np.float32)}


def _scale_close(got, want, tol=1e-6):
    scale = max(1.0, float(np.abs(np.asarray(want, np.float64)).max()))
    return maxdiff(got, want) <= tol * scale


@pytest.mark.parametrize("kw,stride,T", [(3, 2, 5), (4, 2, 7), (5, 3, 4),
                                         (1, 2, 6), (2, 2, 5)])
def test_conv_transpose1d_matches_jax(kw, stride, T):
    rs = np.random.RandomState(kw * 10 + stride)
    cin, cout = 6, 5
    p = {"v": rs.randn(kw, cin, cout).astype(np.float32),
         "g": (rs.rand(cin) + 0.5).astype(np.float32),
         "b": rs.randn(cout).astype(np.float32)}
    x = rs.randn(2, T, cin).astype(np.float32)
    want = j_core.conv_transpose1d_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        stride=stride)
    got = t_core.conv_transpose1d_apply({k: t(v) for k, v in p.items()},
                                        t(x), stride=stride)
    assert got.shape[1] == (T - 1) * stride + kw if kw >= stride \
        else T * stride
    assert _scale_close(got, want)


@pytest.mark.parametrize("kw,dilation,padding", [
    (3, 1, (0, 0)), (3, 2, (3, 1)), (5, 1, (4, 4)), (3, 3, (1, 0)),
    (3, 1, (1, 1))])
@pytest.mark.parametrize("mode", ["library", "kernel"])
def test_conv1d_explicit_padding_matches_jax(kw, dilation, padding, mode):
    """Explicit (l, r) padding; all but (1, 1) change the length, and
    under conv_mode("kernel") those take F.conv1d and are counted."""
    rs = np.random.RandomState(kw + dilation)
    p = _wn_params(rs, kw, 6, 4)
    x = rs.randn(2, 9, 6).astype(np.float32)
    want = j_core.conv1d_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), dilation=dilation,
                               padding=padding)
    before = conv_cuda.LIBRARY_CALLS["fwd_length_changing"]
    with t_core.conv_mode(mode):
        got = t_core.conv1d_apply({k: t(v) for k, v in p.items()}, t(x),
                                  dilation=dilation, padding=padding)
    assert got.shape[1] == 9 + sum(padding) - (kw - 1) * dilation
    assert _scale_close(got, want)
    changes = sum(padding) != (kw - 1) * dilation
    assert (conv_cuda.LIBRARY_CALLS["fwd_length_changing"] - before
            == int(mode == "kernel" and changes))
