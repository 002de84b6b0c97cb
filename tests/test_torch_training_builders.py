# coding: utf-8
"""The port's train step for the other two builders, nyanko and the
multi-speaker DeepVoice3, against the JAX package's `make_train_step` on the
CPU, at narrow widths (tests/torch_port_common.py:TINY_BY_BUILDER, dropout
0), from the same parameters (params_from_jax) and batch.

Bars, those of tests/test_torch_training.py's train-step tests: one step's
loss rtol 1e-5, grad_norm rtol 1e-4, every parameter atol 5e-5; a ten-step
loss trajectory at 1e-4 relative, falling. For nyanko also the seq2seq-only
and postnet-only steps (postnet-only feeds the ground-truth mel to the
converter, whose two deconvolutions upsample it 4x in time, so
use_decoder_state_for_postnet_input is off there), with the frozen half
left exactly as it was.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu_torch.params import flatten_tree
from deepvoice3_pytorch_tpu_torch.training import trainer as tt

from torch_port_common import jax_params, maxdiff, port_params, tiny_configs


class _HP:
    outputs_per_step = 1
    downsample_step = 4
    masked_loss_weight = 0.5
    binary_divergence_weight = 0.1
    priority_freq = 3000
    priority_freq_weight = 0.0
    use_guided_attention = True
    guided_attention_sigma = 0.2
    sample_rate = 22050
    fft_size = 128
    adam_beta1 = 0.5
    adam_beta2 = 0.9
    adam_eps = 1e-6
    amsgrad = False
    clip_thresh = 0.1
    weight_decay = 0.0
    initial_learning_rate = 5e-4
    lr_schedule = "noam_learning_rate_decay"
    lr_schedule_kwargs = {}


def _batch(speakers=False, B=4, T_text=12, T_lin=64):
    """r = 1, downsample_step 4: 16 decoder frames of 16 mel channels, the
    linear target at 4x the frames; texts and targets of several
    lengths."""
    rs = np.random.RandomState(3)
    T_dec = T_lin // 4
    frames = np.asarray([16, 12, 9, 14])
    batch = {
        "x": rs.randint(1, 149, (B, T_text)).astype(np.int32),
        "input_lengths": np.asarray([12, 10, 7, 12], np.int32),
        "mel": rs.rand(B, T_dec, 16).astype(np.float32),
        "y": rs.rand(B, T_lin, 65).astype(np.float32),
        "text_positions": np.tile(np.arange(1, T_text + 1),
                                  (B, 1)).astype(np.int32),
        "frame_positions": np.tile(np.arange(1, T_dec + 1),
                                   (B, 1)).astype(np.int32),
        "done": (np.arange(T_dec)[None, :, None]
                 >= frames[:, None, None] - 1).astype(np.float32),
        "target_lengths": (4 * frames).astype(np.int32),
    }
    if speakers:
        batch["speaker_ids"] = np.asarray([0, 3, 1, 4], np.int32)
    return batch


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _runs(builder, n_steps, s2s=True, pn=True, **cfg_kw):
    """n steps of each package from the same parameters and batch:
    (jax metrics, jax params after step 1, port metrics, port params after
    step 1, initial parameters)."""
    cfg_j, cfg_t = tiny_configs(builder, dropout=0.0, **cfg_kw)
    init = jax_params(cfg_j, seed=0)
    hp = _HP()
    mask_kw = dict(train_seq2seq=s2s, train_postnet=pn)
    batch = _batch(speakers=builder == "deepvoice3_multispeaker")

    lc_j = jt.loss_config_from_hparams(hp)._replace(train_seq2seq=s2s,
                                                    train_postnet=pn)
    opt_j = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    step_j = jt.make_train_step(cfg_j, lc_j, opt_j,
                                jt.trainable_mask(init, cfg_j, **mask_kw))
    state = jt.init_train_state(jax.tree.map(jnp.array, init), opt_j)
    jb = jax.tree.map(jnp.asarray, batch)
    jm, jp = [], None
    for i in range(n_steps):
        state, m = step_j(state, jb, jax.random.PRNGKey(i))
        jm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            jp = flatten_tree(jax.tree_util.tree_map(np.asarray,
                                                     state.params))

    lc_t = tt.loss_config_from_hparams(hp)._replace(train_seq2seq=s2s,
                                                    train_postnet=pn)
    params = port_params(init, cfg_t)
    opt_t = tt.make_optimizer(hp, tt.make_lr_fn(hp))
    step_t = tt.make_train_step(cfg_t, lc_t, opt_t,
                                tt.trainable_mask(params, cfg_t, **mask_kw))
    state_t = tt.init_train_state(params, opt_t)
    tb = tt.batch_to(batch, "cpu")
    gen = torch.Generator().manual_seed(0)
    tm, tp = [], None
    for i in range(n_steps):
        state_t, m = step_t(state_t, tb, gen)
        tm.append({k: float(v) for k, v in m.items()})
        if i == 0:
            tp = {k: v.detach().clone()
                  for k, v in state_t.params.state_dict().items()}
    return jm, jp, tm, tp, flatten_tree(init)


def _assert_step_matches(jm, jp, tm, tp):
    assert _rel(tm[0]["loss"], jm[0]["loss"]) <= 1e-5
    assert _rel(tm[0]["grad_norm"], jm[0]["grad_norm"]) <= 1e-4
    for k in jm[0]:
        if k not in ("loss", "grad_norm"):
            assert _rel(tm[0][k], jm[0][k]) <= 1e-5, k
    assert tp.keys() == jp.keys()
    for k in jp:
        assert maxdiff(tp[k], jp[k]) <= 5e-5, k


@pytest.fixture(scope="module", params=["nyanko", "deepvoice3_multispeaker"])
def ten_steps(request):
    return request.param, _runs(request.param, 10)


def test_one_step_matches_jax(ten_steps):
    _, (jm, jp, tm, tp, _) = ten_steps
    _assert_step_matches(jm, jp, tm, tp)


def test_ten_step_loss_trajectory_matches_jax(ten_steps):
    _, (jm, _, tm, _, _) = ten_steps
    want = np.asarray([m["loss"] for m in jm])
    got = np.asarray([m["loss"] for m in tm])
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("s2s,pn", [(True, False), (False, True)])
def test_nyanko_partial_step_matches_jax(s2s, pn):
    """seq2seq-only and postnet-only nyanko steps; the half not trained
    stays bit for bit as it was."""
    jm, jp, tm, tp, init = _runs(
        "nyanko", 1, s2s=s2s, pn=pn,
        use_decoder_state_for_postnet_input=s2s)
    _assert_step_matches(jm, jp, tm, tp)
    frozen = "converter." if not pn else ("encoder.", "decoder.")
    moved = [k for k in init if k.startswith(frozen)
             and not np.array_equal(tp[k].numpy(), init[k])]
    assert not moved, moved
