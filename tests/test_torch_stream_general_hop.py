# coding: utf-8
"""Streams and continuous batching at a hop that does not divide the FFT
size (16 kHz, hop 240, fft 1024: the configuration of the JAX package's
16 kHz goldens and tests/test_end_to_end.py), on the CPU against the JAX
package. There the JAX stream vocoder falls back from its Pallas kernel to
its XLA loop with an explicit start, the context frames pinned and the
retrieved spectrum returned, all in f32 (no carry or matmul dtype); the
port's `streaming.gl_window` takes dsp/stft.py's `griffin_lim` with the
same arguments and carry="f32".

Tolerances, each with its reason:
  * the loop with init_spec / pinned_prefix / return_spec, f32: both run
    the same f32 operations with sums in different orders. One iteration:
    waveform 1e-5 of the peak, returned spectrum 1e-5 in relative L2 norm;
    32 iterations (a stream window's count) from a random start, which the
    fixed point amplifies: waveform 1e-5 of the peak, spectrum 1e-3
    (measured 1.1e-6 and 9.8e-5). Pinned frames exact. The bf16 carry with
    the same arguments, one iteration: waveform 1e-3 of the peak, spectrum
    2^-8 (bf16's precision; tests/test_torch_streaming.py's bars).
  * tts_stream and the ContinuousBatcher against JAX's: per-chunk sample
    counts and decoded steps exact, linear frames 1e-4 (two frameworks' f32
    decoders), audio 0.12 of the peak with spectral convergence no worse
    than 1.05x JAX's: the bars of tests/test_torch_streaming.py and
    tests/test_torch_serving.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import serving as j_serving
from deepvoice3_pytorch_tpu import streaming as j_stream
from deepvoice3_pytorch_tpu.dsp import reference_model as ref
from deepvoice3_pytorch_tpu.dsp import stft as j_dsp
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAP
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
from deepvoice3_pytorch_tpu.model_builder import build_model as j_build
from deepvoice3_pytorch_tpu_torch import serving as t_serving
from deepvoice3_pytorch_tpu_torch import streaming as t_stream
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp import stft as t_dsp
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAP
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams as t_hparams
from deepvoice3_pytorch_tpu_torch.model_builder import build_config

from torch_port_common import maxdiff, port_params

FFT, HOP = 1024, 240
TINY = ("text_embed_dim=64,encoder_channels=32,decoder_channels=32,"
        "converter_channels=32,outputs_per_step=4,downsample_step=1,"
        "max_decoder_steps=48,sample_rate=16000,hop_size=240")
TEXTS = ["this is the first streaming test sentence.",
         "a second one, a little longer than the first one was.",
         "short third."]
STREAM_KW = dict(max_decoder_steps=24, first_chunk=8, chunk=8, gl_context=8,
                 emit_linear=True)
BF16_EPS = 2.0 ** -8


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# the loop with the stream's arguments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("carry,n_iters", [("f32", 1), ("f32", 32),
                                           ("bf16", 1)])
def test_general_loop_stream_arguments_match_jax(carry, n_iters):
    rs = np.random.RandomState(0)
    B, n, F, n_pin = 2, 24, FFT // 2 + 1, 6
    S = (rs.rand(B, n, F) ** 2).astype(np.float32)
    init = [rs.randn(B, n, F).astype(np.float32) for _ in range(2)]
    pin = [rs.randn(B, n_pin, F).astype(np.float32) for _ in range(2)]
    win = t_dsp.lws_hann_window(FFT, HOP)
    jkw = dict(carry_dtype="bfloat16") if carry == "bf16" else {}
    wj, sj = j_dsp.griffin_lim(
        jnp.asarray(S), FFT, HOP, jnp.asarray(win), n_iters=n_iters,
        momentum=0.9, mats=tuple(jnp.asarray(m) for m in j_dsp.dft_mats(FFT)),
        center=False, init_spec=tuple(jnp.asarray(a) for a in init),
        return_spec=True, pinned_prefix=tuple(jnp.asarray(a) for a in pin),
        **jkw)
    wt, st = t_dsp.griffin_lim(
        torch.from_numpy(S), FFT, HOP, win, n_iters=n_iters, momentum=0.9,
        init_spec=tuple(torch.from_numpy(a) for a in init),
        pinned_prefix=tuple(torch.from_numpy(a) for a in pin),
        return_spec=True, carry=carry)
    assert wt.shape == (B, n * HOP) and st[0].shape == (B, n, F)
    cj = np.asarray(sj[0]) + 1j * np.asarray(sj[1])
    ct = st[0].numpy() + 1j * st[1].numpy()
    if carry == "f32":
        assert _rel(wt.numpy(), wj) <= 1e-5
        assert _l2(ct, cj) <= (1e-5 if n_iters == 1 else 1e-3)
        assert np.array_equal(ct[:, :n_pin], pin[0] + 1j * pin[1])
    else:
        assert _rel(wt.numpy(), wj) <= 1e-3
        assert _l2(ct, cj) <= BF16_EPS
    assert np.array_equal(ct[:, :n_pin], cj[:, :n_pin])


def test_general_loop_refuses_bf16_mats_for_the_f32_carry():
    S = torch.rand(1, 4, FFT // 2 + 1)
    win = t_dsp.lws_hann_window(FFT, HOP)
    with pytest.raises(ValueError, match="f32"):
        t_dsp.griffin_lim(S, FFT, HOP, win, carry="f32",
                          mats=t_dsp.griffin_lim_mats(FFT, win))
    with pytest.raises(ValueError, match="carry"):
        t_dsp.griffin_lim(S, FFT, HOP, win, carry="f16")


# ---------------------------------------------------------------------------
# the stream and the batcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    hj, ht = j_hparams(), t_hparams()
    hj.parse(TINY)
    ht.parse(TINY)
    cfg_j, pj = j_build(hj, j_en.n_vocab)
    cfg_t = build_config(ht, t_en.n_vocab)
    pt = port_params(jax.tree_util.tree_map(np.asarray, pj), cfg_t)
    return (cfg_j, pj, hj), (cfg_t, pt, ht)


def _sc(audio, lin, ap):
    """Spectral convergence of a stream's audio (pre-emphasised back)
    against the magnitudes of its linear frames."""
    S = ap._denorm_pow(torch.from_numpy(lin)).numpy()
    x = ref._preemphasis(np.asarray(audio, np.float64), ap.preemphasis_coef)
    return float(ref.spectral_convergence(x, S, FFT, HOP))


def test_stream_at_hop_240_matches_jax_stream(tiny):
    (cfg_j, pj, hj), (cfg_t, pt, ht) = tiny
    ap_t = TAP(ht)
    assert ap_t.window_route == "general"
    js = list(j_stream.tts_stream(pj, cfg_j, JAP(hj), j_en, TEXTS,
                                  **STREAM_KW))
    gl_cuda.KERNEL.reset_counts()
    ts = list(t_stream.tts_stream(pt, cfg_t, ap_t, t_en, TEXTS,
                                  **STREAM_KW))
    windows = len([c for c in ts if c["audio"].shape[1]]) + 1
    assert set(ap_t.routes) == {"general"} and \
        ap_t.routes["general"] >= windows - 1
    assert gl_cuda.KERNEL.launches == 0
    assert [c["audio"].shape for c in ts] == [c["audio"].shape for c in js]
    assert [c["sample_start"] for c in ts] == [c["sample_start"] for c in js]
    np.testing.assert_array_equal(ts[-1]["decoded_steps"],
                                  js[-1]["decoded_steps"])
    lin_t = np.concatenate([c["linear"] for c in ts], axis=1)
    lin_j = np.concatenate([c["linear"] for c in js], axis=1)
    assert maxdiff(lin_t, lin_j) <= 1e-4
    at = np.concatenate([c["audio"] for c in ts], axis=1)
    aj = np.concatenate([c["audio"] for c in js], axis=1)
    assert at.shape == (len(TEXTS), lin_t.shape[1] * HOP)
    assert maxdiff(at, aj) <= 0.12 * np.abs(aj).max()
    for i in range(len(TEXTS)):
        sc_t, sc_j = _sc(at[i], lin_j[i], ap_t), _sc(aj[i], lin_j[i], ap_t)
        assert sc_t <= 1.05 * sc_j, (i, sc_t, sc_j)


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


def test_batcher_at_hop_240_matches_jax_batcher(tiny):
    """One schedule in both packages: the first text alone for one step,
    then the other two admitted together (one emission group of two at
    the same Griffin-Lim phase, one batched general-route call)."""
    (cfg_j, pj, hj), (cfg_t, pt, ht) = tiny
    ap_t = TAP(ht)
    kw = dict(n_slots=3, text_pad=40, chunk=8, max_decoder_steps=24,
              gl_context=8)
    jb = j_serving.ContinuousBatcher(pj, cfg_j, JAP(hj), j_en, **kw)
    tb = t_serving.ContinuousBatcher(pt, cfg_t, ap_t, t_en, **kw)
    got = {}
    for name, b in (("jax", jb), ("port", tb)):
        qa = b.submit(TEXTS[0])
        assert b.step() == 1
        qs = [qa] + [b.submit(t) for t in TEXTS[1:]]
        n = 0
        while b.step():
            n += 1
            assert n < 80
        got[name] = [_drain(q) for q in qs]
    assert set(ap_t.routes) == {"general"}
    for i, ((a_t, d_t), (a_j, d_j)) in enumerate(zip(got["port"],
                                                     got["jax"])):
        assert d_t == d_j and len(a_t) == len(a_j)
        assert maxdiff(a_t, a_j) <= 0.12 * np.abs(a_j).max()
        # the magnitudes: the port's own stream of the text
        chunks = list(t_stream.tts_stream(
            pt, cfg_t, ap_t, t_en, [TEXTS[i]], max_decoder_steps=24,
            first_chunk=8, chunk=8, gl_context=8, pad_to=40,
            emit_linear=True))
        lin = np.concatenate([c["linear"] for c in chunks], axis=1)[0]
        lin = lin[:len(a_t) // HOP]
        sc_t, sc_j = _sc(a_t, lin, ap_t), _sc(a_j, lin, ap_t)
        assert sc_t <= 1.05 * sc_j, (i, sc_t, sc_j)
