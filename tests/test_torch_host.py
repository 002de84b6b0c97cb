# coding: utf-8
"""Host-side pieces of the PyTorch port: it imports without jax, its copies
of the JAX package's host modules agree with the originals, and parameters
move between the two packages by key path."""

import os
import subprocess
import sys

import numpy as np
import pytest

import torch

from deepvoice3_pytorch_tpu import hparams as j_hparams
from deepvoice3_pytorch_tpu.dsp import stft as j_stft
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu_torch import hparams as t_hparams
from deepvoice3_pytorch_tpu_torch import model_builder
from deepvoice3_pytorch_tpu_torch.dsp import stft as t_stft
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.params import (ParamTree, flatten_tree,
                                                 model_init, params_from_jax)

from torch_port_common import jax_params, tiny_configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SENTENCES = [
    "Hello world.",
    "Printing, in the only sense with which we are at present concerned.",
    "The quick brown fox jumps over the lazy dog!",
    "Mr. Smith paid $3.50 for 2 apples on the 21st of May, 1999.",
    "Is it (really) 10:30? Yes; it's late -- isn't it.",
]


def test_port_imports_without_jax():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "import deepvoice3_pytorch_tpu_torch.synthesis\n"
            "import deepvoice3_pytorch_tpu_torch.model_builder\n"
            "import deepvoice3_pytorch_tpu_torch.training.trainer\n"
            "import deepvoice3_pytorch_tpu_torch.training.dataset\n"
            "import deepvoice3_pytorch_tpu_torch.utils.synthcorpus\n"
            "import deepvoice3_pytorch_tpu_torch.ops.conv_cuda\n"
            "bad = [m for m in sys.modules if m == 'jax' and sys.modules[m]\n"
            "       or m.startswith('deepvoice3_pytorch_tpu.')\n"
            "       or m == 'deepvoice3_pytorch_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_hparams_defaults_equal_jax():
    assert (t_hparams.default_hparams().values()
            == j_hparams.default_hparams().values())


@pytest.mark.parametrize("text", SENTENCES)
def test_en_frontend_ids_equal_jax(text):
    assert t_en.text_to_sequence(text, p=0) == j_en.text_to_sequence(text,
                                                                     p=0)
    assert t_en.n_vocab == j_en.n_vocab


def test_dsp_constants_equal_jax():
    for a, b in zip(t_stft.dft_mats(1024), j_stft.dft_mats(1024)):
        assert np.array_equal(a, b)
    assert np.array_equal(t_stft.lws_hann_window(1024, 256),
                          j_stft.lws_hann_window(1024, 256))
    assert np.array_equal(t_stft.mel_basis(22050, 1024, 80, 125, 7600),
                          j_stft.mel_basis(22050, 1024, 80, 125, 7600))


def test_params_from_jax_round_trip_and_strict_check():
    cfg_j, cfg_t = tiny_configs()
    pj = jax_params(cfg_j)
    sd = params_from_jax(pj, cfg_t)
    flat = flatten_tree(pj)
    assert list(sd) == list(flat)
    tree = ParamTree.from_state_dict(sd)
    assert list(tree.state_dict()) == list(flat)
    for k, v in tree.state_dict().items():
        assert np.array_equal(v.numpy(), flat[k]), k
    # the JAX package's empty attention entries survive as empty nodes
    assert len(tree["decoder"]["attention"]) == 5
    assert "query_proj" not in tree["decoder"]["attention"][1]

    bad = dict(pj, encoder=dict(pj["encoder"]))
    bad["encoder"]["embed_tokens"] = {"w": pj["encoder"]["embed_tokens"]["w"][:5]}
    with pytest.raises(ValueError):
        params_from_jax(bad, cfg_t)
    del bad["encoder"]["embed_tokens"]
    with pytest.raises(KeyError):
        params_from_jax(bad, cfg_t)


def test_model_init_shapes_equal_jax():
    cfg_j, cfg_t = tiny_configs()
    want = {k: v.shape for k, v in flatten_tree(jax_params(cfg_j)).items()}
    p1 = model_init(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    p2 = model_init(cfg_t, torch.Generator().manual_seed(0), device="cpu")
    got = {k: tuple(v.shape) for k, v in p1.state_dict().items()}
    assert got == want
    for (k, a), b in zip(p1.state_dict().items(), p2.state_dict().values()):
        assert torch.equal(a, b), k
    assert not any(p.requires_grad for p in p1.parameters())


@pytest.mark.parametrize("fn", [model_init, model_builder.build_model])
def test_entry_points_default_to_the_card(fn):
    """Parameters land on the card unless the caller asks for the CPU."""
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_build_model_ljspeech_preset():
    hp = t_hparams.default_hparams()
    with open(os.path.join(REPO, "presets", "deepvoice3_ljspeech.json")) as f:
        hp.parse_json(f.read())
    cfg, params = model_builder.build_model(hp, t_en.n_vocab, seed=0,
                                            device="cpu")
    assert cfg.decoder.convolutions[0][0] == 256
    assert cfg.encoder.convolutions[0][0] == 512
    assert cfg.converter.time_upsampling == 4
    w = params["decoder"]["convs"][3]["conv"]["v"]
    assert tuple(w.shape) == (3, 256, 512)
