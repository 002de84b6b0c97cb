# coding: utf-8
"""The port's training slice (deepvoice3_pytorch_tpu_torch/training, the
teacher-forced forward, the synthetic corpus and feature extraction) against
the JAX package on the CPU. Inputs come from numpy seeds; the JAX
parameters are loaded into the port through params_from_jax.

Bars:
  * losses 1e-6 relative; learning-rate schedules two f32 ulp (XLA's and
    torch's pow / rsqrt each round once, and the product rounds again);
  * model_forward 1e-5 of the output's scale, the JAX side under
    strict_numerics (full-f32 products, tapsum);
  * one train step against JAX's make_train_step(conv_mode="pallas"): loss
    rtol 1e-5, grad_norm rtol 1e-4, every updated parameter atol 5e-5 (the
    bars of tests/test_training.py's pallas-vs-tapsum step); ten steps of
    loss at 1e-4 relative;
  * bf16 step against the f32 step: 5 % per step over 30 steps, as the JAX
    package's own bf16 parity test.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import builder as jb
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAudio
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.ops import core as j_core
from deepvoice3_pytorch_tpu.training import dataset as j_ds
from deepvoice3_pytorch_tpu.training import losses as j_losses
from deepvoice3_pytorch_tpu.training import lrschedule as j_lrs
from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu.utils import synthcorpus as j_sc
from deepvoice3_pytorch_tpu_torch import builder as tb
from deepvoice3_pytorch_tpu_torch import hparams as t_hparams
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAudio
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.ops import core as t_core
from deepvoice3_pytorch_tpu_torch.params import flatten_tree
from deepvoice3_pytorch_tpu_torch.training import dataset as t_ds
from deepvoice3_pytorch_tpu_torch.training import losses as t_losses
from deepvoice3_pytorch_tpu_torch.training import lrschedule as t_lrs
from deepvoice3_pytorch_tpu_torch.training import trainer as tt
from deepvoice3_pytorch_tpu_torch.utils import synthcorpus as t_sc

from torch_port_common import (jax_params, maxdiff, port_params, t,
                               text_inputs, tiny_configs)


class _HP:
    outputs_per_step = 4
    downsample_step = 1
    masked_loss_weight = 0.5
    binary_divergence_weight = 0.1
    priority_freq = 3000
    priority_freq_weight = 0.0
    use_guided_attention = True
    guided_attention_sigma = 0.2
    sample_rate = 22050
    fft_size = 256
    adam_beta1 = 0.5
    adam_beta2 = 0.9
    adam_eps = 1e-6
    amsgrad = False
    clip_thresh = 0.1
    weight_decay = 0.0
    initial_learning_rate = 5e-4
    lr_schedule = "noam_learning_rate_decay"
    lr_schedule_kwargs = {}


def _cfg_kwargs(**kw):
    """The JAX package's tiny train-step config (r = 4, downsample_step = 1,
    so the linear loss takes the decoder-domain mask)."""
    args = dict(n_vocab=149, embed_dim=64, encoder_channels=32,
                decoder_channels=32, converter_channels=32, linear_dim=129,
                r=4, dropout=0.0, max_positions=128)
    args.update(kw)
    return args


def _tiny_batch(B=8, T_text=16, T_dec=8, r=4, mel_dim=80, lin_dim=129):
    rs = np.random.RandomState(0)
    return {
        "x": rs.randint(1, 149, (B, T_text)).astype(np.int32),
        "input_lengths": np.full((B,), T_text, np.int32),
        "mel": rs.rand(B, T_dec * r, mel_dim).astype(np.float32),
        "y": rs.rand(B, T_dec * r, lin_dim).astype(np.float32),
        "text_positions": np.tile(np.arange(1, T_text + 1),
                                  (B, 1)).astype(np.int32),
        "frame_positions": np.tile(np.arange(1, T_dec + 1),
                                   (B, 1)).astype(np.int32),
        "done": np.ones((B, T_dec, 1), np.float32),
        "target_lengths": np.full((B,), T_dec * r, np.int32),
    }


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


# ---------------------------------------------------------------------------
# losses and schedules
# ---------------------------------------------------------------------------


def _loss_inputs(seed=0, B=3, T=20, F=33):
    rs = np.random.RandomState(seed)
    y_hat = rs.rand(B, T, F).astype(np.float32)
    y_hat[0, :2, :3] = [0.0, 1.0, 0.5]          # saturated probabilities
    y = rs.rand(B, T, F).astype(np.float32)
    lengths = np.asarray([T, T - 5, 7], np.int32)
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    return y_hat, y, mask[..., None], lengths


LOSS_CASES = {  # fn(losses module, y_hat, y, mask, y in {0, 1})
    "spec_loss": lambda m, a, b, mask, b01: m.spec_loss(a, b, mask),
    "spec_loss_priority": lambda m, a, b, mask, b01: m.spec_loss(
        a, b, mask, priority_bin=9, priority_w=0.3),
    "spec_loss_unmasked": lambda m, a, b, mask, b01: m.spec_loss(
        a, b, mask, masked_loss_weight=0.0),
    "bce_loss": lambda m, a, b, mask, b01: (m.bce_loss(a, b01),),
    "logit": lambda m, a, b, mask, b01: (m.logit(a),),
}


@pytest.mark.parametrize("name", sorted(LOSS_CASES))
def test_losses_match_jax(name):
    y_hat, y, mask, _ = _loss_inputs()
    args = (y_hat, y, mask, (y > 0.5).astype(np.float32))
    want = LOSS_CASES[name](j_losses, *(jnp.asarray(a) for a in args))
    got = LOSS_CASES[name](t_losses, *(t(a) for a in args))
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        g = g.numpy().astype(np.float64)
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-6 * max(1.0, np.abs(w).max())


def test_guided_attention_loss_matches_jax():
    rs = np.random.RandomState(3)
    attn = rs.rand(2, 3, 11, 14).astype(np.float32)
    in_len = np.asarray([14, 9, 5], np.int32)
    dec_len = np.asarray([11, 6, 8], np.int32)
    want = j_losses.guided_attention_loss(jnp.asarray(attn),
                                          jnp.asarray(in_len),
                                          jnp.asarray(dec_len))
    got = t_losses.guided_attention_loss(t(attn), t(in_len), t(dec_len))
    assert _rel(got, want) <= 1e-6


SCHEDULES = [
    ("noam_learning_rate_decay", {}),
    ("noam_learning_rate_decay", {"warmup_steps": 7}),
    ("step_learning_rate_decay", {"anneal_interval": 3}),
    ("cyclic_cosine_annealing", {"T": 100, "M": 3}),
    ("constant_learning_rate", {}),
]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_lr_schedules_match_jax(name, kw):
    """Inside JAX's jitted step the count is a traced int32, so the JAX
    side is jitted here too. Measured: 0, 1 or 2 ulp apart. The cosine
    schedule computes init_lr / 2 * (cos + 1), which cancels near cos = -1,
    so its ulp is taken at init_lr / 2, the scale of the cos term."""
    j_fn = jax.jit(j_lrs.get_schedule(name, 5e-4, **kw))
    t_fn = t_lrs.get_schedule(name, 5e-4, **kw)
    steps = list(range(0, 40)) + [399, 4000, 4001, 123456]
    want = np.asarray([float(j_fn(jnp.int32(s))) for s in steps])
    got = np.asarray([float(t_fn(s)) for s in steps])
    scale = np.abs(want)
    if name == "cyclic_cosine_annealing":
        scale = np.full_like(scale, 5e-4 / 2)
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    assert (np.abs(got - want) <= 2 * ulp).all(), np.abs(got - want) / ulp


# ---------------------------------------------------------------------------
# teacher-forced forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("conv_mode", ["library", "kernel"])
def test_model_forward_matches_jax(conv_mode):
    cfg_j, cfg_t = tiny_configs()
    pj = jax_params(cfg_j)
    pt = port_params(pj, cfg_t)
    x, pos, lengths = text_inputs()
    B, T_dec = x.shape[0], 10
    rs = np.random.RandomState(5)
    mel = rs.rand(B, T_dec * 4, 16).astype(np.float32)   # downsample 4
    fpos = np.tile(np.arange(1, T_dec + 1), (B, 1)).astype(np.int32)
    with j_core.strict_numerics():
        want = jb.model_forward(
            jax.tree_util.tree_map(jnp.asarray, pj), cfg_j, jnp.asarray(x),
            jnp.asarray(mel[:, ::4]), text_positions=jnp.asarray(pos),
            frame_positions=jnp.asarray(fpos),
            input_lengths=jnp.asarray(lengths))
    with t_core.conv_mode(conv_mode), torch.no_grad():
        got = tb.model_forward(pt, cfg_t, t(x), t(mel[:, ::4]),
                               text_positions=t(pos),
                               frame_positions=t(fpos),
                               input_lengths=t(lengths))
    for g, w in zip(got, want):
        scale = max(1.0, float(np.abs(np.asarray(w)).max()))
        assert maxdiff(g, w) <= 1e-5 * scale


def test_grad_multiply_scales_the_gradient_only():
    from deepvoice3_pytorch_tpu_torch.models import deepvoice3 as dv3

    x = torch.randn(3, 4, requires_grad=True)
    y = dv3.grad_multiply(x, 0.25)
    assert torch.equal(y, x)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full_like(x, 0.25))


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------


def _jax_run(cfg_j, lc, mask_kw, n_steps, conv_mode, seed=0):
    hp = _HP()
    params = jb.model_init(jax.random.PRNGKey(seed), cfg_j)
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    mask = jt.trainable_mask(params, cfg_j, **mask_kw)
    step_fn = jt.make_train_step(cfg_j, lc, opt, mask, conv_mode=conv_mode)
    init = jax.tree_util.tree_map(np.asarray, params)
    state = jt.init_train_state(jax.tree.map(jnp.array, params), opt)
    batch = jax.tree.map(jnp.asarray, _tiny_batch())
    metrics, after_first = [], None
    for i in range(n_steps):
        state, m = step_fn(state, batch, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            after_first = flatten_tree(
                jax.tree_util.tree_map(np.asarray, state.params))
    return init, metrics, after_first


def _port_run(cfg_t, init, lc, mask_kw, n_steps, compute_dtype="float32",
              conv_mode="kernel"):
    hp = _HP()
    params = port_params(init, cfg_t)
    opt = tt.make_optimizer(hp, tt.make_lr_fn(hp))
    mask = tt.trainable_mask(params, cfg_t, **mask_kw)
    step_fn = tt.make_train_step(cfg_t, lc, opt, mask,
                                 compute_dtype=compute_dtype,
                                 conv_mode=conv_mode)
    state = tt.init_train_state(params, opt)
    batch = tt.batch_to(_tiny_batch(), "cpu")
    gen = torch.Generator().manual_seed(0)
    metrics, after_first = [], None
    for i in range(n_steps):
        state, m = step_fn(state, batch, gen)
        metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            after_first = {k: v.detach().clone()
                           for k, v in state.params.state_dict().items()}
    assert all(v.dtype == torch.float32 for v in state.params.parameters())
    return metrics, after_first


@pytest.fixture(scope="module")
def pallas_runs():
    """Ten steps of the JAX step with B3's Pallas kernel and of the port's
    step through conv_mode="kernel" (B3's plain version on the CPU), from
    the same parameters and batch, dropout 0."""
    kw = _cfg_kwargs()
    lc_j = jt.loss_config_from_hparams(_HP())
    init, jm, jp = _jax_run(jb.deepvoice3(**kw), lc_j, {}, 10, "pallas")
    lc_t = tt.loss_config_from_hparams(_HP())
    tm, tp = _port_run(tb.deepvoice3(**kw), init, lc_t, {}, 10)
    return jm, jp, tm, tp


def test_train_step_matches_jax_pallas(pallas_runs):
    jm, jp, tm, tp = pallas_runs
    assert _rel(tm[0]["loss"], jm[0]["loss"]) <= 1e-5
    assert _rel(tm[0]["grad_norm"], jm[0]["grad_norm"]) <= 1e-4
    for k in ("mel_loss", "linear_loss", "done_loss", "attn_loss"):
        assert _rel(tm[0][k], jm[0][k]) <= 1e-5, k
    assert tp.keys() == jp.keys()
    for k in jp:
        assert maxdiff(tp[k], jp[k]) <= 5e-5, k


def test_ten_step_loss_trajectory_matches_jax(pallas_runs):
    jm, _, tm, _ = pallas_runs
    want = np.asarray([m["loss"] for m in jm])
    got = np.asarray([m["loss"] for m in tm])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("s2s,pn", [(True, False), (False, True)])
def test_partial_training_step_matches_jax(s2s, pn):
    """seq2seq-only and postnet-only steps (postnet-only feeds the ground-
    truth mel to the converter, so use_decoder_state_for_postnet_input is
    off there). JAX side with its default tapsum lowering."""
    kw = _cfg_kwargs(use_decoder_state_for_postnet_input=s2s)
    mask_kw = dict(train_seq2seq=s2s, train_postnet=pn)
    lc_j = jt.loss_config_from_hparams(_HP())._replace(**{
        "train_seq2seq": s2s, "train_postnet": pn})
    init, jm, jp = _jax_run(jb.deepvoice3(**kw), lc_j, mask_kw, 1, None)
    lc_t = tt.loss_config_from_hparams(_HP())._replace(**{
        "train_seq2seq": s2s, "train_postnet": pn})
    tm, tp = _port_run(tb.deepvoice3(**kw), init, lc_t, mask_kw, 1)
    assert _rel(tm[0]["loss"], jm[0]["loss"]) <= 1e-5
    assert _rel(tm[0]["grad_norm"], jm[0]["grad_norm"]) <= 1e-4
    frozen = "converter." if not pn else "encoder."
    for k in jp:
        assert maxdiff(tp[k], jp[k]) <= 5e-5, k
        if k.startswith(frozen):
            assert np.array_equal(tp[k].numpy(), flatten_tree(init)[k]), k


@pytest.mark.parametrize("mask_kw,cfg_kw", [
    ({}, {}), ({}, {"freeze_embedding": True}),
    ({}, {"trainable_positional_encodings": True}),
    ({"train_seq2seq": False}, {}), ({"train_postnet": False}, {})])
def test_trainable_mask_matches_jax(mask_kw, cfg_kw):
    kw = _cfg_kwargs(**cfg_kw)
    cfg_j, cfg_t = jb.deepvoice3(**kw), tb.deepvoice3(**kw)
    pj = jb.model_init(jax.random.PRNGKey(0), cfg_j)
    want = flatten_tree(jt.trainable_mask(pj, cfg_j, **mask_kw))
    got = tt.trainable_mask(port_params(jax_params(cfg_j), cfg_t), cfg_t,
                            **mask_kw)
    assert got == {k: float(v) for k, v in want.items()}


def test_bf16_step_tracks_f32():
    """compute_dtype=bfloat16: masters stay f32, and the loss trajectory
    tracks the f32 run."""
    kw = _cfg_kwargs()
    cfg_j, cfg_t = jb.deepvoice3(**kw), tb.deepvoice3(**kw)
    init = jax_params(cfg_j, seed=0)
    lc = tt.loss_config_from_hparams(_HP())
    traces = {dt: np.asarray([m["loss"] for m in _port_run(
        cfg_t, init, lc, {}, 30, compute_dtype=dt)[0]])
        for dt in ("float32", "bfloat16")}
    assert np.isfinite(traces["bfloat16"]).all()
    np.testing.assert_allclose(traces["bfloat16"], traces["float32"],
                               rtol=0.05)
    assert traces["bfloat16"][-5:].mean() < traces["bfloat16"][:5].mean()


def test_library_conv_mode_step_matches_kernel_mode():
    """The two lowerings of the step agree (F.conv1d vs B3's plain
    version)."""
    kw = _cfg_kwargs()
    cfg_t = tb.deepvoice3(**kw)
    init = jax_params(jb.deepvoice3(**kw))
    lc = tt.loss_config_from_hparams(_HP())
    a, pa = _port_run(cfg_t, init, lc, {}, 2, conv_mode="kernel")
    b, pb = _port_run(cfg_t, init, lc, {}, 2, conv_mode="library")
    for ma, mb in zip(a, b):
        assert _rel(ma["loss"], mb["loss"]) <= 1e-5
    for k in pa:
        assert maxdiff(pa[k], pb[k]) <= 5e-5, k


@pytest.mark.parametrize("rate", [0.05, 0.5])
def test_dropout_keep_rate_and_scaling(rate):
    """The generators differ from JAX's, so the statistics are compared:
    the kept share is 1 - rate within 5 sigma, kept values are x / keep,
    dropped ones 0; no draw at all when not training."""
    x = torch.full((200, 500), 2.0)
    g = torch.Generator().manual_seed(0)
    y = t_core.dropout(g, x, rate, True)
    keep = 1.0 - rate
    kept = y != 0
    n = x.numel()
    share = float(kept.float().mean())
    assert abs(share - keep) <= 5 * (keep * rate / n) ** 0.5
    assert torch.allclose(y[kept], torch.full_like(y[kept], 2.0 / keep))
    state = g.get_state()
    assert t_core.dropout(g, x, rate, False) is x
    assert t_core.dropout(g, x, 0.0, True) is x
    assert torch.equal(g.get_state(), state)


def test_dropout_in_training_forward_changes_outputs():
    cfg_j, cfg_t = tiny_configs(dropout=0.3)
    pt = port_params(jax_params(cfg_j), cfg_t)
    x, pos, lengths = text_inputs()
    mel = torch.rand(3, 8, 16)
    fpos = torch.arange(1, 9)[None].repeat(3, 1)
    kw = dict(text_positions=t(pos), frame_positions=fpos,
              input_lengths=t(lengths))
    with torch.no_grad():
        a = tb.model_forward(pt, cfg_t, t(x), mel, training=True,
                             generator=torch.Generator().manual_seed(1), **kw)
        b = tb.model_forward(pt, cfg_t, t(x), mel, training=True,
                             generator=torch.Generator().manual_seed(1), **kw)
        c = tb.model_forward(pt, cfg_t, t(x), mel, **kw)
    assert torch.equal(a[1], b[1])
    assert not torch.allclose(a[1], c[1])


# ---------------------------------------------------------------------------
# data: synthetic corpus, features, collate, sampler
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    hp = t_hparams.default_hparams()
    hp.fft_size, hp.hop_size, hp.num_mels = 256, 64, 20
    texts = t_sc.make_sentences(6, seed=3)
    assert texts == j_sc.make_sentences(6, seed=3)
    return hp, texts


def test_synth_wav_equal_jax(corpus):
    hp, texts = corpus
    for i, text in enumerate(texts[:3]):
        sid = None if i < 2 else 1
        np.testing.assert_array_equal(
            t_sc.synth_wav(text, hp.sample_rate, hp.hop_size, speaker_id=sid),
            j_sc.synth_wav(text, hp.sample_rate, hp.hop_size, speaker_id=sid))
    assert (t_sc.mean_frames_per_char(texts, hp.sample_rate, hp.hop_size)
            == j_sc.mean_frames_per_char(texts, hp.sample_rate,
                                         hp.hop_size))


def test_batch_features_match_jax(corpus):
    """Normalised [0, 1] features. Both sides take an f32 FFT (pocketfft
    against XLA's), and the dB scale turns their relative differences in
    quiet bins into absolute ones: the bar is 2e-4 (0.02 dB), the JAX
    package's own bar for batched features against the golden model
    (tests/test_dsp_golden.py)."""
    hp, texts = corpus
    wavs = [t_sc.synth_wav(s, hp.sample_rate, hp.hop_size) for s in texts]
    want = JAudio(hp).batch_features(wavs, bucket_samples=4096)
    got = TAudio(hp).batch_features(wavs, bucket_samples=4096, device="cpu")
    for (gl, gm), (wl, wm) in zip(got, want):
        assert gl.shape == wl.shape and gm.shape == wm.shape
        assert np.abs(gl - wl).max() <= 2e-4
        assert np.abs(gm - wm).max() <= 2e-4
    lin, mel = TAudio(hp).both_spectrograms(wavs[0], device="cpu")
    assert np.abs(lin - got[0][0]).max() <= 1e-6
    assert np.abs(mel - got[0][1]).max() <= 1e-6
    assert TAudio(hp).num_frames(len(wavs[0])) == lin.shape[0]


def test_collate_and_batches_equal_jax(corpus):
    hp, texts = corpus
    wavs = [t_sc.synth_wav(s, hp.sample_rate, hp.hop_size) for s in texts]
    feats = JAudio(hp).batch_features(wavs)
    items = [{"text": np.asarray(j_en.text_to_sequence(s, p=0), np.int32),
              "mel": m, "linear": l} for s, (l, m) in zip(texts, feats)]
    for it, s in zip(items, texts):
        assert list(it["text"]) == t_en.text_to_sequence(s, p=0)
    kw = dict(length_bucket_step=8, frame_bucket_step=4, max_positions=512)
    for r, ds in ((1, 4), (4, 1)):
        want = j_ds.collate(items[:4], r, ds, **kw)
        got = t_ds.collate(items[:4], r, ds, **kw)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    hp.outputs_per_step, hp.downsample_step = 1, 4
    hp.length_bucket_step, hp.frame_bucket_step = 8, 4
    for bw, bg in zip(j_sc.make_batches(items, hp, 2, seed=3),
                      t_sc.make_batches(items, hp, 2, seed=3)):
        for k in bw:
            np.testing.assert_array_equal(bg[k], bw[k])


@pytest.mark.parametrize("bs,permutate", [(4, True), (3, False)])
def test_sampler_equal_jax(bs, permutate):
    lengths = np.random.RandomState(0).randint(10, 200, 37)
    want = list(j_ds.SimilarTimeLengthSampler(lengths, bs,
                                              permutate=permutate, seed=7))
    got = list(t_ds.SimilarTimeLengthSampler(lengths, bs,
                                             permutate=permutate, seed=7))
    assert [list(map(int, b)) for b in got] == \
        [list(map(int, b)) for b in want]


def test_dataset_reads_preprocessed_dir(tmp_path):
    rs = np.random.RandomState(0)
    lines = []
    for i in range(3):
        T = int(rs.randint(20, 40))
        np.save(tmp_path / ("x-mel-%05d.npy" % i),
                rs.rand(T, 80).astype(np.float32))
        np.save(tmp_path / ("x-spec-%05d.npy" % i),
                rs.rand(T, 129).astype(np.float32))
        lines.append("x-spec-%05d.npy|x-mel-%05d.npy|%d|hello world %d."
                     % (i, i, T, i))
    (tmp_path / "train.txt").write_text("\n".join(lines) + "\n")
    want = j_ds.TTSDataset(str(tmp_path), j_en, 0.0)
    got = t_ds.TTSDataset(str(tmp_path), t_en, 0.0)
    assert len(got) == len(want) == 3 and not got.multi_speaker
    assert got.meta.frame_lengths == want.meta.frame_lengths
    for i in range(3):
        for k in ("text", "mel", "linear"):
            np.testing.assert_array_equal(got[i][k], want[i][k])
