# coding: utf-8
"""Shared fixtures for the PyTorch-port parity tests (tests/test_torch_*.py):
one tiny configuration with the LJSpeech structure, built in both packages,
and the JAX parameters loaded into the port."""

import numpy as np

import jax
import torch

from deepvoice3_pytorch_tpu import builder as jb
from deepvoice3_pytorch_tpu_torch import builder as tb
from deepvoice3_pytorch_tpu_torch.params import ParamTree, params_from_jax

# LJSpeech structure (r=1, downsample_step=4 -> two convT layers, memory
# mask, key/value projections, monotonic attention) at narrow widths
TINY = dict(n_vocab=149, embed_dim=32, mel_dim=16, linear_dim=65, r=1,
            downsample_step=4, dropout=0.05, kernel_size=3,
            encoder_channels=32, decoder_channels=32, converter_channels=32,
            use_memory_mask=True, key_projection=True, value_projection=True,
            max_positions=64, key_position_rate=1.385,
            force_monotonic_attention=True)


# the other two builders at the same narrow widths: nyanko (highway stacks,
# finished position encodings, no key/value projections) and the
# multi-speaker DeepVoice3 (speaker embedding, per-sample position rates,
# speaker softsign biases in every GLU layer; the VCTK preset's rates)
TINY_NYANKO = dict(n_vocab=149, embed_dim=32, mel_dim=16, linear_dim=65, r=1,
                   downsample_step=4, dropout=0.05, kernel_size=3,
                   encoder_channels=32, decoder_channels=32,
                   converter_channels=32, use_memory_mask=True,
                   max_positions=64, key_position_rate=1.385,
                   force_monotonic_attention=True,
                   use_decoder_state_for_postnet_input=True)
TINY_MULTISPEAKER = dict(TINY, n_speakers=5, speaker_embed_dim=8,
                         query_position_rate=2.0, key_position_rate=7.6)
TINY_BY_BUILDER = {"deepvoice3": TINY, "nyanko": TINY_NYANKO,
                   "deepvoice3_multispeaker": TINY_MULTISPEAKER}


def tiny_configs(builder="deepvoice3", **kw):
    kwargs = dict(TINY_BY_BUILDER[builder], **kw)
    return getattr(jb, builder)(**kwargs), getattr(tb, builder)(**kwargs)


def jax_params(cfg_j, seed=42):
    return jax.tree_util.tree_map(
        np.asarray, jb.model_init(jax.random.PRNGKey(seed), cfg_j))


def port_params(np_tree, cfg_t=None):
    return ParamTree.from_state_dict(params_from_jax(np_tree, cfg_t))


def text_inputs(B=3, T_text=12, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(1, 149, (B, T_text)).astype(np.int32)
    pos = np.tile(np.arange(1, T_text + 1), (B, 1)).astype(np.int32)
    lengths = np.asarray([T_text, T_text - 3, T_text - 5][:B], np.int32)
    for i, n in enumerate(lengths):
        x[i, n:] = 0
        pos[i, n:] = 0
    return x, pos, lengths


def t(a, dtype=None):
    """numpy -> torch (int arrays become int64)."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.astype(dtype or np.float32))


def maxdiff(a, b):
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float(np.abs(a - b).max()) if a.size else 0.0
