# coding: utf-8
"""The port's train step on the multi-speaker DeepVoice3 against the JAX
package's `make_train_step` on the CPU, at narrow widths with 5 speakers
(tests/torch_port_common.py:TINY_MULTISPEAKER, dropout 0), from the same
parameters (params_from_jax) and batch, speaker ids included.

Bars, those of tests/test_torch_training.py's train-step tests: loss rtol
1e-5, grad_norm rtol 1e-4, every updated parameter atol 5e-5. A batch with
other speaker ids must give another loss: a step that dropped the ids would
run every speaker term with no embedding and raise nothing.
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

SPEAKERS = {"ids": np.asarray([0, 3, 1, 4]),
            "other_ids": np.asarray([2, 2, 4, 0])}


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


def _batch(speaker_ids, B=4, T_text=12, T_lin=64):
    """r = 1, downsample_step 4: 16 decoder frames of 16 mel channels, the
    linear target at 4x the frames; texts and targets of several lengths."""
    rs = np.random.RandomState(3)
    T_dec = T_lin // 4
    frames = np.asarray([16, 12, 9, 14])
    return {
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
        "speaker_ids": np.asarray(speaker_ids, np.int32),
    }


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


@pytest.fixture(scope="module")
def runs():
    """One step of each package per speaker-id set, from the same
    parameters: {key: ((jax metrics, jax params), (port metrics, port
    params))}."""
    cfg_j, cfg_t = tiny_configs("deepvoice3_multispeaker", dropout=0.0)
    init = jax_params(cfg_j, seed=0)
    hp = _HP()
    opt_j = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    step_j = jt.make_train_step(cfg_j, jt.loss_config_from_hparams(hp),
                                opt_j, jt.trainable_mask(init, cfg_j))
    out = {}
    for key, ids in SPEAKERS.items():
        batch = _batch(ids)
        state = jt.init_train_state(jax.tree.map(jnp.array, init), opt_j)
        state, m = step_j(state, jax.tree.map(jnp.asarray, batch),
                          jax.random.PRNGKey(0))
        jax_side = ({k: float(v) for k, v in m.items()}, flatten_tree(
            jax.tree_util.tree_map(np.asarray, state.params)))

        params = port_params(init, cfg_t)
        opt_t = tt.make_optimizer(hp, tt.make_lr_fn(hp))
        step_t = tt.make_train_step(cfg_t, tt.loss_config_from_hparams(hp),
                                    opt_t, tt.trainable_mask(params, cfg_t))
        state_t = tt.init_train_state(params, opt_t)
        state_t, m = step_t(state_t, tt.batch_to(batch, "cpu"),
                            torch.Generator().manual_seed(0))
        port_side = ({k: float(v) for k, v in m.items()},
                     {k: v.detach().clone() for k, v in
                      state_t.params.state_dict().items()})
        out[key] = (jax_side, port_side)
    return out


def _assert_step_matches(jax_side, port_side):
    (jm, jp), (tm, tp) = jax_side, port_side
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-4
    assert tp.keys() == jp.keys()
    for k in jp:
        assert maxdiff(tp[k], jp[k]) <= 5e-5, k


def test_multispeaker_step_uses_speaker_ids(runs):
    """One step with speaker ids matches JAX's step, and other ids give
    another loss (in both packages)."""
    _assert_step_matches(*runs["ids"])
    (jm, _), (tm, _) = runs["ids"]
    (jm_o, _), (tm_o, _) = runs["other_ids"]
    assert _rel(jm_o["loss"], jm["loss"]) > 1e-4
    assert _rel(tm_o["loss"], tm["loss"]) > 1e-4


def test_multispeaker_step_matches_jax_for_other_ids(runs):
    _assert_step_matches(*runs["other_ids"])
