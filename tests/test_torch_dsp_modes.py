# coding: utf-8
"""The port's DSP breadth against the JAX package on the CPU: the centred
framing (stft_mode="center"), hops that do not divide the FFT size (16 kHz /
hop 240, with the committed goldens tests/data/dsp_golden16k_*.npy), the
general-hop Griffin-Lim loop, kernel B2's centred trim, local-weighted-sums
phase retrieval and load_wav.

Tolerances. Features against JAX's AudioProcessor: the two packages take
different f32 FFTs (pocketfft against XLA's), and the dB scale turns their
relative differences in quiet bins into absolute ones, so a bin may part
by more than 1e-5 (1.7e-5 seen); the bar is the repo's bar for the same
comparison in the lws framing, 2e-4 at most (tests/test_torch_training.py
`test_batch_features_match_jax`), and 1e-6 on average. The goldens' bars
of tests/test_dsp_golden.py (5e-5 single, 2e-4 batched). The general-hop
Griffin-Lim keeps a bf16 carry whose roundings flip where the two packages
sum in another order and grow over the iterations: one iteration is held to
2 bf16 ulps of the peak, 16 to spectral convergence within 1.02x of JAX's.
B2's plain version in centred mode is held to JAX's Pallas kernel
(interpret mode) at tests/test_torch_gl.py's bars. consistency_kernels is
the same numpy float64 code: bit for bit. lws_run: 3 iterations at 1e-4
relative, 30 by spectral convergence."""

import os

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax.numpy as jnp

from deepvoice3_pytorch_tpu.dsp import audio as j_audio
from deepvoice3_pytorch_tpu.dsp import lws_phase as j_lws
from deepvoice3_pytorch_tpu.dsp import reference_model as j_ref
from deepvoice3_pytorch_tpu.dsp import stft as j_dsp
from deepvoice3_pytorch_tpu.dsp.gl_pallas import griffin_lim_pallas
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
from deepvoice3_pytorch_tpu_torch import streaming
from deepvoice3_pytorch_tpu_torch.dsp import audio as t_audio
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp import lws_phase as t_lws
from deepvoice3_pytorch_tpu_torch.dsp import reference_model as t_ref
from deepvoice3_pytorch_tpu_torch.dsp import stft as t_dsp
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams as t_hparams

import torch_port_common  # noqa: F401  (one torch thread a worker)

DATA = os.path.join(os.path.dirname(__file__), "data")
BF16_ULP = 2.0 ** -8      # of a value in [0.5, 1): the peak's scale

# (stft_mode, sample_rate, hop_size): the centred framing, the 16 kHz hop
# that does not divide 1024, and both
CONFIGS = [("center", 22050, 256), ("lws", 16000, 240),
           ("center", 16000, 240)]


def _hps(stft_mode="lws", sample_rate=22050, hop_size=256, **kw):
    """The same hparams in both packages."""
    out = []
    for make in (j_hparams, t_hparams):
        hp = make()
        hp.stft_mode, hp.sample_rate, hp.hop_size = (stft_mode, sample_rate,
                                                     hop_size)
        for k, v in kw.items():
            setattr(hp, k, v)
        out.append(hp)
    return out


def _aps(**kw):
    hj, ht = _hps(**kw)
    return j_audio.AudioProcessor(hj), t_audio.AudioProcessor(ht)


def _wav(n, seed=0):
    rs = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.3 * rs.randn(n))
            ).astype(np.float32)


def _golden16k(name):
    return np.load(os.path.join(DATA, "dsp_golden16k_%s.npy" % name))


def _spec_conv(wav_out, lin_norm, hp):
    """tests/test_dsp_golden.py's metric: spectral convergence of a
    reconstruction against the power-raised magnitudes it was given (lws
    framing, float64 reference model)."""
    e = j_ref._preemphasis(wav_out, hp.preemphasis)
    db = np.clip(lin_norm, 0, 1) * -hp.min_level_db + hp.min_level_db
    S = np.power(10.0, (db + hp.ref_level_db) * 0.05) ** hp.power
    return j_ref.spectral_convergence(e, S.T, hp.fft_size, hp.hop_size)


def _spec_conv_center(wav, S, fft, hop):
    """Spectral convergence of a centred-framing waveform against the
    magnitudes it was retrieved from (float64, the port's centred STFT)."""
    x = torch.from_numpy(np.asarray(wav, np.float64))
    win = torch.from_numpy(t_dsp.sqrt_hann_window(fft, np.float64))
    M = torch.abs(t_dsp.stft(x, fft, hop, win, center=True)).numpy()
    n = min(M.shape[-2], S.shape[-2])
    return float(np.linalg.norm(M[..., :n, :] - S[..., :n, :])
                 / np.linalg.norm(S[..., :n, :]))


# ---------------------------------------------------------------------------
# framing and features
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("T,pad", [(1, 4), (2, 7), (5, 5), (5, 13),
                                   (300, 512), (2000, 512)])
def test_reflect_pad_matches_numpy_at_any_length(T, pad):
    x = np.random.RandomState(T).randn(2, T).astype(np.float32)
    want = np.pad(x, [(0, 0), (pad, pad)], mode="reflect")
    got = t_dsp.reflect_pad(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, want)


def _close_features(got, want):
    d = np.abs(got - want)
    assert d.max() <= 2e-4 and d.mean() <= 1e-6, (d.max(), d.mean())


@pytest.mark.parametrize("stft_mode,sr,hop", CONFIGS)
def test_features_match_jax(stft_mode, sr, hop):
    ap_j, ap_t = _aps(stft_mode=stft_mode, sample_rate=sr, hop_size=hop)
    assert np.array_equal(ap_t.window_np, ap_j.window_np)
    for n in (7000, 300):              # 300 < fft // 2: reflected twice
        wav = _wav(n, seed=n)
        lin_j, mel_j = ap_j.both_spectrograms(wav)
        lin_t, mel_t = ap_t.both_spectrograms(wav, device="cpu")
        assert lin_t.shape == lin_j.shape == (ap_t.num_frames(n), 513)
        assert ap_t.num_frames(n) == ap_j.num_frames(n)
        _close_features(lin_t, lin_j)
        _close_features(mel_t, mel_j)
    wavs = [_wav(n, seed=n) for n in (9000, 300, 4100)]
    for (lt, mt), (lj, mj) in zip(ap_t.batch_features(wavs, device="cpu"),
                                  ap_j.batch_features(wavs)):
        assert lt.shape == lj.shape and mt.shape == mj.shape
        _close_features(lt, lj)
        _close_features(mt, mj)


def test_features16k_match_goldens():
    """The bars of tests/test_dsp_golden.py's 16 kHz tests: features 5e-5
    bin for bin, batched 2e-4, ceil(T / hop) frames."""
    _, ht = _hps(sample_rate=16000, hop_size=240)
    ap = t_audio.AudioProcessor(ht)
    wav = _golden16k("wav")
    np.testing.assert_allclose(ap.window_np, _golden16k("window"), atol=1e-6)
    np.testing.assert_allclose(ap.mel_filters_np, _golden16k("melfb"),
                               atol=1e-6)
    lin = ap.spectrogram(wav, device="cpu")
    assert lin.shape == _golden16k("linear").shape
    assert lin.shape[1] == -(-len(wav) // 240)
    np.testing.assert_allclose(lin, _golden16k("linear"), atol=5e-5)
    np.testing.assert_allclose(ap.melspectrogram(wav, device="cpu"),
                               _golden16k("mel"), atol=5e-5)
    (lin0, mel0), (lin1, _) = ap.batch_features([wav, wav[:9000]],
                                                device="cpu")
    np.testing.assert_allclose(lin0.T, _golden16k("linear"), atol=2e-4)
    np.testing.assert_allclose(mel0.T, _golden16k("mel"), atol=2e-4)
    assert lin1.shape[0] == j_ref.stft(wav[:9000], 1024, 240).shape[0]


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("hop", [256, 240])
def test_istft_round_trip_both_framings(center, hop):
    """stft -> istft gives the signal back (away from the unweighted
    edges), and equals JAX's istft on the same spectrum."""
    x = _golden16k("wav").astype(np.float32)[:8000]
    win_np = (t_dsp.sqrt_hann_window(1024) if center
              else t_dsp.lws_hann_window(1024, hop))
    win = torch.from_numpy(win_np)
    xt = torch.from_numpy(x)[None]
    if not center:
        xt = t_dsp.lws_pad(xt, 1024, hop)
    S = t_dsp.stft(xt, 1024, hop, win, center=center)
    assert S.shape[-2] == (1 + len(x) // hop if center
                           else -(-len(x) // hop))
    y = t_dsp.istft(S, 1024, hop, win, length=len(x), center=center)[0]
    edge = 8 if center else 1024
    np.testing.assert_allclose(y[edge:-1024].numpy(), x[edge:-1024],
                               atol=1e-4)
    yj = np.asarray(j_dsp.istft(jnp.asarray(S.numpy()), 1024, hop,
                                jnp.asarray(win_np), length=len(x),
                                center=center))[0]
    np.testing.assert_allclose(y.numpy(), yj, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the general-hop Griffin-Lim (JAX's XLA loop, bf16 carry)
# ---------------------------------------------------------------------------


def _general_both(S, fft, hop, win, n_iters, center):
    wj = np.asarray(j_dsp.griffin_lim(
        jnp.asarray(S), fft, hop, jnp.asarray(win), n_iters=n_iters,
        momentum=0.9, center=center, phase_init="spsi",
        carry_dtype="bfloat16"))
    wt = t_dsp.griffin_lim(torch.from_numpy(S), fft, hop, win,
                           n_iters=n_iters, momentum=0.9,
                           center=center).numpy()
    assert wt.shape == wj.shape == (S.shape[0], S.shape[1] * hop)
    return wt, wj


@pytest.mark.parametrize("center", [False, True])
def test_general_griffin_lim_one_iteration(center):
    rs = np.random.RandomState(1)
    S = (rs.rand(2, 40, 513) ** 2).astype(np.float32)
    win = (t_dsp.sqrt_hann_window(1024) if center
           else t_dsp.lws_hann_window(1024, 240))
    wt, wj = _general_both(S, 1024, 240, win, 1, center)
    assert np.abs(wt - wj).max() <= 2 * BF16_ULP * np.abs(wj).max()


def test_general_griffin_lim_16_iterations_on_golden16k():
    """16 iterations at the shipped defaults on the 16 kHz golden: spectral
    convergence within 1.02x of JAX's loop and under the golden bar 0.15,
    through both packages' AudioProcessor (the "general" route)."""
    hj, ht = _hps(sample_rate=16000, hop_size=240)
    ap_j, ap_t = j_audio.AudioProcessor(hj), t_audio.AudioProcessor(ht)
    assert ap_j.gl_carry_dtype == "bfloat16"
    assert ap_t.inversion_route == "general"
    lin = _golden16k("linear")
    wt = ap_t.inv_spectrogram(lin)
    assert ap_t.routes == {"general": 1}
    wj = np.asarray(ap_j.inv_spectrogram(lin))
    assert wt.shape == wj.shape and np.isfinite(wt).all()
    sc_t, sc_j = _spec_conv(wt, lin, ht), _spec_conv(wj, lin, hj)
    assert sc_t < 0.15 and sc_t <= 1.02 * sc_j, (sc_t, sc_j)


# ---------------------------------------------------------------------------
# kernel B2's centred mode (its plain version on the CPU)
# ---------------------------------------------------------------------------


def _b2_center_both(S, fft, hop, n_iters, phase_init="spsi"):
    win = t_dsp.sqrt_hann_window(fft)
    wj = np.asarray(griffin_lim_pallas(
        jnp.asarray(S), fft, hop, jnp.asarray(win), n_iters=n_iters,
        momentum=0.9, phase_init=phase_init, center=True, interpret=True))
    wt = gl_cuda.griffin_lim(torch.from_numpy(S), fft, hop, win,
                             n_iters=n_iters, momentum=0.9,
                             phase_init=phase_init, center=True).numpy()
    assert wt.shape == wj.shape == (S.shape[0], S.shape[1] * hop)
    return wt, wj


@pytest.mark.parametrize("n_iters,phase_init", [(0, "spsi"), (1, "spsi"),
                                                (1, "zero")])
def test_b2_center_schedule_matches_kernel(n_iters, phase_init):
    S = (np.random.RandomState(0).rand(2, 24, 513) ** 2).astype(np.float32)
    wt, wj = _b2_center_both(S, 1024, 256, n_iters, phase_init)
    assert np.abs(wt - wj).max() <= 1e-3 * np.abs(wj).max()


def test_b2_center_16_iterations_matches_kernel():
    S = (np.random.RandomState(0).rand(2, 40, 65) ** 2).astype(np.float32)
    wt, wj = _b2_center_both(S, 128, 32, 16)
    assert np.isfinite(wt).all()
    assert np.abs(wt - wj).max() < 0.12 * np.abs(wj).max()
    err_t = _spec_conv_center(wt, S, 128, 32)
    err_j = _spec_conv_center(wj, S, 128, 32)
    assert err_t <= 1.05 * err_j, (err_t, err_j)


def test_b2_center_trim_drops_the_analysis_padding():
    """center=True is the lws call's untrimmed signal from fft // 2 on."""
    S = torch.from_numpy((np.random.RandomState(3).rand(1, 10, 65) ** 2)
                         .astype(np.float32))
    win = t_dsp.sqrt_hann_window(128)
    full = gl_cuda.griffin_lim_plain(S, 128, 32, win, n_iters=2)
    got = gl_cuda.griffin_lim(S, 128, 32, win, n_iters=2, center=True)
    assert torch.equal(got, full[:, 64:64 + 320])


# ---------------------------------------------------------------------------
# local weighted sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("window", ["lws", "sqrt_hann"])
def test_consistency_kernels_bit_equal(window):
    w = (j_ref.analysis_window(1024, 256) if window == "lws"
         else j_dsp.sqrt_hann_window(1024).astype(np.float64))
    got = t_ref.consistency_kernels(1024, 256, w)
    want = j_ref.consistency_kernels(1024, 256, w)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(t_ref.analysis_window(1024, 256),
                          j_ref.analysis_window(1024, 256))


@pytest.mark.parametrize("center", [False, True])
def test_lws_run_three_iterations(center):
    wav = _wav(6000, seed=5)
    win = (t_dsp.sqrt_hann_window(1024) if center
           else t_dsp.lws_hann_window(1024, 256))
    x = torch.from_numpy(wav)
    S = torch.abs(t_dsp.stft(
        x if center else t_dsp.lws_pad(x, 1024, 256), 1024, 256,
        torch.from_numpy(win), center=center))[None]
    got = t_lws.lws_run(S, 1024, 256, win, n_iters=3, center=center).numpy()
    want = np.asarray(j_lws.lws_run(jnp.asarray(S.numpy()), 1024, 256, win,
                                    n_iters=3, center=center))
    assert got.shape == want.shape == (1, S.shape[1] * 256)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_lws_phase_retrieval_30_iterations_on_golden():
    """tests/test_dsp_golden.py's lws option test in both packages:
    spectral convergence < 0.2 and within 1.02x of JAX's."""
    hj, ht = _hps(phase_retrieval="lws", griffin_lim_iters=30)
    ap_j, ap_t = j_audio.AudioProcessor(hj), t_audio.AudioProcessor(ht)
    assert ap_t.inversion_route == "lws"
    lin = np.load(os.path.join(DATA, "dsp_golden_linear.npy"))
    wt = ap_t.inv_spectrogram(lin)
    wj = np.asarray(ap_j.inv_spectrogram(lin))
    assert wt.shape == wj.shape and np.isfinite(wt).all()
    sc_t, sc_j = _spec_conv(wt, lin, ht), _spec_conv(wj, lin, hj)
    assert sc_t < 0.2 and sc_t <= 1.02 * sc_j, (sc_t, sc_j)


# ---------------------------------------------------------------------------
# construction, routes, load_wav
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,route", [
    (dict(), "b2"), (dict(stft_mode="center"), "b2"),
    (dict(sample_rate=16000, hop_size=240), "general"),
    (dict(phase_retrieval="lws"), "lws"),
    (dict(phase_retrieval="lws", stft_mode="center"), "lws")])
def test_routes_follow_the_configuration(kw, route):
    _, ht = _hps(**kw)
    assert t_audio.AudioProcessor(ht).inversion_route == route


@pytest.mark.parametrize("kw", [
    dict(phase_retrieval="lws", sample_rate=16000, hop_size=240),
    dict(stft_mode="librosa")])
def test_constructor_raises_where_jax_raises(kw):
    hj, ht = _hps(**kw)
    with pytest.raises((ValueError, AssertionError)):
        j_audio.AudioProcessor(hj)
    with pytest.raises(ValueError):
        t_audio.AudioProcessor(ht)


def test_streaming_refuses_the_centred_framing():
    _, ht = _hps(stft_mode="center")
    with pytest.raises(ValueError, match="lws"):
        streaming.StreamingVocoder(t_audio.AudioProcessor(ht))


def test_scalar_helpers_match_jax():
    ap_j, ap_t = _aps()
    x = np.random.RandomState(2).rand(3, 50).astype(np.float32)
    for name in ("_normalize", "_denormalize", "preemphasis",
                 "inv_preemphasis"):
        got, want = getattr(ap_t, name)(x), getattr(ap_j, name)(x)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        assert torch.is_tensor(getattr(ap_t, name)(torch.from_numpy(x)))


def _write(path, sr, data):
    wavfile.write(str(path), sr, data)
    return str(path)


def test_load_wav_matches_jax(tmp_path):
    ap_j, ap_t = _aps()
    rs = np.random.RandomState(4)
    f = (0.5 * np.sin(np.arange(4000) * 0.05)).astype(np.float32)
    files = {
        "int16": _write(tmp_path / "a.wav", 22050, (f * 32767).astype(
            np.int16)),
        "int32": _write(tmp_path / "b.wav", 22050, (f * 2 ** 31).astype(
            np.int32)),
        "uint8": _write(tmp_path / "c.wav", 22050, (f * 127 + 128).astype(
            np.uint8)),
        "float32": _write(tmp_path / "d.wav", 22050, f),
        "stereo": _write(tmp_path / "e.wav", 22050, np.stack(
            [f, rs.rand(4000).astype(np.float32)], axis=1)),
        "resampled": _write(tmp_path / "f.wav", 16000, (f * 32767).astype(
            np.int16)),
    }
    for kind, path in files.items():
        got, want = ap_t.load_wav(path), ap_j.load_wav(path)
        assert got.dtype == want.dtype == np.float32, kind
        assert np.array_equal(got, want), kind
    assert len(ap_t.load_wav(files["resampled"])) == -(-4000 * 441 // 320)
