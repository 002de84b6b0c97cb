# coding: utf-8
"""The batch-synthesis slice as a whole: the port's `tts_batch` (plain
versions of both kernels on the CPU) against the JAX package's `tts_batch`
with the fused Pallas decoder and the Pallas Griffin-Lim (DV3_PALLAS_GL=1,
interpret mode), on the same texts and the same parameters.

Bars: mel, linear and alignment <= 2e-5 and num_decoder_steps exact (the
decoder/converter bars of tests/test_fused_decode.py). mel and linear come
back denormalized to dB (-min_level_db = 100 dB per unit of the model's
[0, 1] output), so they are compared on the model's scale, divided by
100 dB. Waveforms are held to the
Griffin-Lim cross-implementation bar of tests/test_torch_gl.py (0.12 of the
peak: two bf16 rounding schedules amplified by 16 iterations).

The `cuda` test holds the card's copies of the results into page-locked
memory to the plain `.cpu()` copies of the same tensors. The card's
machine has no JAX, so this module imports the JAX package (and
torch_port_common, which imports it) only inside the tests that compare
with it: `python -m pytest tests/test_torch_synthesis.py -m cuda
--noconftest -q`."""

import copy

import numpy as np
import pytest
import torch

from deepvoice3_pytorch_tpu_torch import model_builder
from deepvoice3_pytorch_tpu_torch import synthesis as t_syn
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAP
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams

TEXTS = ["Hello world.", "Printing, in the only sense.", "A test."]


def _hp(defaults=default_hparams):
    hp = defaults()
    hp.fft_size = 128
    hp.hop_size = 32
    hp.num_mels = 16
    return hp


@pytest.fixture(scope="module")
def outputs():
    from deepvoice3_pytorch_tpu import synthesis as j_syn
    from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAP
    from deepvoice3_pytorch_tpu.frontend import en as j_en
    from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
    from torch_port_common import jax_params, port_params, tiny_configs

    cfg_j, cfg_t = tiny_configs()
    pj = jax_params(cfg_j, seed=3)
    pt = port_params(pj, cfg_t)
    mp = pytest.MonkeyPatch()
    mp.setenv("DV3_PALLAS_GL", "1")
    try:
        res_j = j_syn.tts_batch(pj, cfg_j, JAP(_hp(j_hparams)), j_en, TEXTS,
                                max_decoder_steps=11, fused=True)
    finally:
        mp.undo()
    res_t = t_syn.tts_batch(pt, cfg_t, TAP(_hp()), t_en, TEXTS,
                            max_decoder_steps=11)
    return res_j, res_t


@pytest.mark.parametrize("key,unit", [("mel", 100.0), ("linear", 100.0),
                                      ("alignment", 1.0)])
def test_features_match_jax(outputs, key, unit):
    from torch_port_common import maxdiff

    res_j, res_t = outputs
    for rj, rt in zip(res_j, res_t):
        assert rt["num_decoder_steps"] == rj["num_decoder_steps"]
        assert maxdiff(rt[key], rj[key]) / unit <= 2e-5, key


def test_waveforms_match_jax(outputs):
    from torch_port_common import maxdiff

    res_j, res_t = outputs
    for rj, rt in zip(res_j, res_t):
        wj, wt = rj["waveform"], rt["waveform"]
        assert wt.shape == wj.shape == (rj["num_decoder_steps"] * 4 * 32,)
        assert np.isfinite(wt).all()
        assert maxdiff(wt, wj) < 0.12 * np.abs(wj).max()


def test_tts_single_equals_batch_of_one():
    from torch_port_common import jax_params, port_params, tiny_configs

    cfg_j, cfg_t = tiny_configs()
    pt = port_params(jax_params(cfg_j, seed=3), cfg_t)
    ap = TAP(_hp())
    wav, align, lin, mel = t_syn.tts(pt, cfg_t, ap, t_en, TEXTS[1],
                                     max_decoder_steps=11)
    rt = t_syn.tts_batch(pt, cfg_t, ap, t_en, TEXTS[1:2],
                         max_decoder_steps=11)[0]
    for a, key in ((wav, "waveform"), (align, "alignment"), (lin, "linear"),
                   (mel, "mel")):
        assert np.array_equal(a, rt[key]), key


def _watched(seen):
    """`_pinned_to_host` that keeps the device tensors it was given and
    the arrays it returned in `seen`."""
    pinned_to_host = t_syn._pinned_to_host

    def watched(tensors):
        out = pinned_to_host(tensors)
        seen.append((tensors, out))
        return out
    return watched


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.cuda
def test_card_results_land_in_page_locked_memory(monkeypatch):
    """tts_batch on the card: the six results equal, bit for bit, the plain
    `.cpu().numpy()` of the device tensors the pinned copies read; every
    returned array is backed by page-locked memory; a first call's results
    are unchanged after a second call of another shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    hp = default_hparams().parse(
        "text_embed_dim=32,encoder_channels=32,decoder_channels=32,"
        "converter_channels=32,fft_size=256,hop_size=64")
    cfg, params = model_builder.build_model(hp, t_en.n_vocab, seed=3,
                                            device="cpu")
    gpu = copy.deepcopy(params).to("cuda")
    ap = TAP(hp)
    seen = []
    monkeypatch.setattr(t_syn, "_pinned_to_host", _watched(seen))

    first = t_syn.tts_batch(gpu, cfg, ap, t_en, TEXTS, max_decoder_steps=11)
    (tensors, landed), = seen
    assert len(tensors) == len(landed) == 6
    for t, a in zip(tensors, landed):
        assert t.is_cuda and a.shape == tuple(t.shape)
        assert np.array_equal(_bits(a), _bits(t.cpu().numpy()))
        assert torch.from_numpy(a).is_pinned()
    wav, mel, linear, align, lengths, dec_lengths = landed
    up = cfg.r * cfg.converter.time_upsampling
    for i, r in enumerate(first):
        n = int(dec_lengths[i])
        assert r["num_decoder_steps"] == n
        assert np.array_equal(r["waveform"], wav[i][:n * up * hp.hop_size])
        assert np.array_equal(r["mel"], mel[i][:n * cfg.r])
        assert np.array_equal(r["linear"], linear[i][:n * up])
        assert np.array_equal(r["alignment"], align[i][:n, :lengths[i]])
        for k in ("waveform", "mel", "linear", "alignment"):
            assert torch.from_numpy(r[k]).is_pinned(), k
    kept = [{k: np.copy(r[k]) for k in ("waveform", "mel", "linear",
                                        "alignment")} for r in first]

    second = t_syn.tts_batch(gpu, cfg, ap, t_en, TEXTS[1:] + [TEXTS[1]],
                             max_decoder_steps=17)
    assert len(seen) == 2
    assert seen[1][1][1].shape != mel.shape   # 17 steps, not 11
    for r, k_ in zip(first, kept):
        for k, a in k_.items():
            assert np.array_equal(_bits(r[k]), _bits(a)), k
            assert not any(np.shares_memory(r[k], s[k]) for s in second)
