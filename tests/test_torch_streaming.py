# coding: utf-8
"""The streaming slice of the PyTorch port against the JAX package on the
CPU: kernel B2's streaming modes (init_spec, n_pinned, return_spec) and
its unfolded-window mode (the probe kernel of tools/gl_pallas2_probe.py),
the carried inverse pre-emphasis, the windowed converter, `tts_stream`
against the port's own batch path and against JAX's stream, and the HTTP
engine. The configuration is the tiny one of tests/test_streaming.py, with
the JAX parameters loaded into the port.

Tolerances, each with its reason:
  * Griffin-Lim modes, <= 4 iterations: waveform 1e-3 of the peak (the
    bar of tests/test_torch_gl.py: the same bf16 schedule, f32 sums in
    another order, so a value near a bf16 rounding boundary can round the
    other way, and iterations amplify it). The returned spectrum is the
    bf16 carry itself: one flip moves a value by a bf16 ulp (2^-8 to 2^-7
    of the peak), and a bin whose projection is ill-conditioned turns its
    phase by more, so it is held in relative L2 norm to bf16's own
    precision, 2^-8. Pinned frames: bit-equal to their bf16 start, which is
    their definition.
  * 16 iterations of the unfolded mode on the golden fixture: spectral
    convergence no worse than 1.05x the JAX kernel's
    (tests/test_gl_pallas.py:47).
  * inverse pre-emphasis with carry: 1e-5 (tests/test_streaming.py:47).
  * windowed converter == full converter: 1e-5 (one f32 network on
    different lengths; tests/test_streaming.py:51 allows 2e-4).
  * stream vs the port's tts_batch: decoded steps exact, linear frames 1e-5
    (the same plain step and converter on the same device).
  * stream vs JAX's stream: per-chunk sample counts and decoded steps exact,
    linear frames 1e-4 (two frameworks' f32 decoders), audio 0.12 of the
    peak with spectral convergence no worse than 1.05x JAX's: JAX's CPU
    stream vocodes through the XLA loop with f32 carries, the port through
    the kernel's bf16 schedule; the tight per-window check is the
    Griffin-Lim mode test above.
"""

import os
import struct
import sys
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deepvoice3_pytorch_tpu import streaming as j_stream
from deepvoice3_pytorch_tpu.builder import model_postnet as j_postnet
from deepvoice3_pytorch_tpu.dsp import reference_model as ref
from deepvoice3_pytorch_tpu.dsp import stft as j_dsp
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAP
from deepvoice3_pytorch_tpu.dsp.gl_pallas import griffin_lim_pallas
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
from deepvoice3_pytorch_tpu.model_builder import build_model as j_build
from deepvoice3_pytorch_tpu_torch import serve as t_serve
from deepvoice3_pytorch_tpu_torch import streaming as t_stream
from deepvoice3_pytorch_tpu_torch import synthesis as t_syn
from deepvoice3_pytorch_tpu_torch.builder import model_postnet as t_postnet
from deepvoice3_pytorch_tpu_torch.dsp import gl_cuda
from deepvoice3_pytorch_tpu_torch.dsp import stft as t_dsp
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAP
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams as t_hparams
from deepvoice3_pytorch_tpu_torch.model_builder import build_config

from torch_port_common import maxdiff, port_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import gl_pallas2_probe  # noqa: E402

DATA = os.path.join(REPO, "tests", "data")
TINY = ("text_embed_dim=64,encoder_channels=32,decoder_channels=32,"
        "converter_channels=32,outputs_per_step=4,downsample_step=1,"
        "max_decoder_steps=48")
TEXTS = ["this is the first streaming test sentence.",
         "a second one, a little longer than the first one was.",
         "short third."]
STREAM_KW = dict(max_decoder_steps=24, first_chunk=8, chunk=8, gl_context=8,
                 emit_linear=True)
FFT, HOP = 1024, 256
BF16_EPS = 2.0 ** -8       # bf16's relative precision


class GoldenHP:
    sample_rate = 22050
    fft_size = 1024
    hop_size = 256
    num_mels = 80
    fmin = 125
    fmax = 7600
    preemphasis = 0.97
    min_level_db = -100
    ref_level_db = 20
    power = 1.4
    griffin_lim_iters = 16
    griffin_lim_phase_init = "spsi"
    griffin_lim_momentum = 0.9


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, params, ap), (port cfg, params, ap): one model, both
    packages."""
    hj, ht = j_hparams(), t_hparams()
    hj.parse(TINY)
    ht.parse(TINY)
    cfg_j, pj = j_build(hj, j_en.n_vocab)
    cfg_t = build_config(ht, t_en.n_vocab)
    pt = port_params(jax.tree_util.tree_map(np.asarray, pj), cfg_t)
    return (cfg_j, pj, JAP(hj)), (cfg_t, pt, TAP(ht))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _mags(n, B=2, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.rand(B, n, FFT // 2 + 1) ** 2).astype(np.float32)


def _golden_mags():
    hp = GoldenHP()
    lin = np.load(os.path.join(DATA, "dsp_golden_linear.npy"))   # (F, n)
    db = np.clip(lin, 0, 1) * -hp.min_level_db + hp.min_level_db
    return (np.power(10.0, (db + hp.ref_level_db) * 0.05) ** hp.power
            ).T.astype(np.float32)                               # (n, F)


def _sc(wav, S):
    """Spectral convergence of a Griffin-Lim output against the magnitudes
    it was given (lws framing)."""
    return float(ref.spectral_convergence(np.asarray(wav, np.float64), S,
                                          FFT, HOP))


# ---------------------------------------------------------------------------
# kernel B2's streaming modes and the unfolded-window mode (plain versions)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_iters,n_pinned,fold", [
    (0, 8, True), (1, 0, True), (1, 8, True), (4, 8, True), (4, 24, True),
    (4, 8, False)])
def test_gl_stream_modes_match_kernel(n_iters, n_pinned, fold):
    """init_spec + n_pinned + return_spec against the Pallas kernel, with
    the windows folded into the DFT matrices and (the probe's schedule)
    not."""
    n = 24
    S = _mags(n)
    rs = np.random.RandomState(1)
    i_re, i_im = (rs.randn(*S.shape).astype(np.float32) for _ in range(2))
    win = t_dsp.lws_hann_window(FFT, HOP)
    wj, (sj_re, sj_im) = griffin_lim_pallas(
        jnp.asarray(S), FFT, HOP, jnp.asarray(win), n_iters=n_iters,
        momentum=0.9, center=False, init_spec=(jnp.asarray(i_re),
                                               jnp.asarray(i_im)),
        n_pinned=n_pinned, return_spec=True, fold_windows=fold,
        interpret=True)
    ti = (torch.from_numpy(i_re), torch.from_numpy(i_im))
    St = torch.from_numpy(S)
    gl_cuda.KERNEL.reset_counts()
    wt, (st_re, st_im) = gl_cuda.griffin_lim(
        St, FFT, HOP, win, n_iters=n_iters, momentum=0.9, init_spec=ti,
        n_pinned=n_pinned, return_spec=True, fold_windows=fold)
    assert gl_cuda.KERNEL.launches == 0          # CPU: the plain version
    assert wt.shape == (2, n * HOP) and st_re.shape == S.shape
    assert _rel(wt, wj) <= 1e-3
    cj = np.asarray(sj_re) + 1j * np.asarray(sj_im)
    ct = st_re.numpy() + 1j * st_im.numpy()
    assert np.linalg.norm(ct - cj) <= BF16_EPS * np.linalg.norm(cj)
    # pinned frames: exactly their bf16 start
    scale = St * torch.rsqrt(ti[0] ** 2 + ti[1] ** 2 + 1e-30)
    for got, i in ((st_re, ti[0]), (st_im, ti[1])):
        start = (i * scale).to(torch.bfloat16).float()
        assert torch.equal(got[:, :n_pinned], start[:, :n_pinned])


def test_gl_modes_reject_bad_arguments():
    S = torch.from_numpy(_mags(6))
    win = t_dsp.lws_hann_window(FFT, HOP)
    init = (S, torch.zeros_like(S))
    with pytest.raises(ValueError):       # pinning needs a given start
        gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=1, n_pinned=2)
    with pytest.raises(ValueError):       # more pinned frames than frames
        gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=1, init_spec=init,
                            n_pinned=7)
    with pytest.raises(ValueError):       # start shaped unlike S
        gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=1,
                            init_spec=(S[:, :3], S[:, :3]))


def test_gl_stream_modes_squeeze_and_zero_start():
    """(n, F) input gives (n*hop,) and (n, F) spectra; a start of zeros is
    guarded by the 1e-30 (a zero spectrum, no NaN)."""
    S = torch.from_numpy(_mags(10)[0])
    win = t_dsp.lws_hann_window(FFT, HOP)
    z = torch.zeros_like(S)
    wav, (sre, sim) = gl_cuda.griffin_lim(S, FFT, HOP, win, n_iters=2,
                                          init_spec=(z, z), n_pinned=10,
                                          return_spec=True)
    assert wav.shape == (10 * HOP,) and sre.shape == S.shape
    assert torch.equal(sre, z) and torch.equal(sim, z)
    assert torch.equal(wav, torch.zeros_like(wav))


@pytest.mark.parametrize("n_iters", [0, 1])
def test_gl_unfolded_matches_probe_and_kernel(n_iters):
    """fold_windows=False (the probe kernel P, SPSI start) against the
    probe's own Pallas kernel and against griffin_lim_pallas's unfolded
    mode, both in interpret mode, on the magnitudes of
    tests/test_torch_gl.py. The SPSI start's phase cumsum is a sequential
    sum here and a triangular matmul there, so its bf16 start values flip
    now and then; with 2-4 iterations such flips reach 1e-3 of the peak on
    some inputs, so more iterations are held above with a given start."""
    n = 24
    S = _mags(n)
    win = t_dsp.lws_hann_window(FFT, HOP)
    mats = tuple(jnp.asarray(m) for m in j_dsp.dft_mats(FFT))
    w_probe = np.asarray(gl_pallas2_probe.gl2(
        jnp.asarray(S), FFT, HOP, jnp.asarray(win), n_iters=n_iters,
        momentum=0.9, mats=mats, interpret=True))
    w_kernel = np.asarray(griffin_lim_pallas(
        jnp.asarray(S), FFT, HOP, jnp.asarray(win), n_iters=n_iters,
        momentum=0.9, mats=mats, center=False, phase_init="spsi",
        fold_windows=False, interpret=True))
    wt = gl_cuda.griffin_lim(torch.from_numpy(S), FFT, HOP, win,
                             n_iters=n_iters, momentum=0.9,
                             fold_windows=False).numpy()
    assert wt.shape == w_probe.shape == w_kernel.shape == (2, n * HOP)
    assert _rel(wt, w_probe) <= 1e-3
    assert _rel(wt, w_kernel) <= 1e-3


def test_gl_unfolded_golden_quality():
    """16 iterations of the unfolded mode on the golden fixture: spectral
    convergence within 1.05x of the JAX kernel's unfolded mode."""
    S = _golden_mags()[None]
    win = t_dsp.lws_hann_window(FFT, HOP)
    wj = np.asarray(griffin_lim_pallas(
        jnp.asarray(S), FFT, HOP, jnp.asarray(win), n_iters=16,
        momentum=0.9, center=False, phase_init="spsi", fold_windows=False,
        interpret=True))[0]
    wt = gl_cuda.griffin_lim(torch.from_numpy(S), FFT, HOP, win, n_iters=16,
                             momentum=0.9, fold_windows=False).numpy()[0]
    sc_t, sc_j = _sc(wt, S[0]), _sc(wj, S[0])
    assert np.isfinite(wt).all()
    assert sc_t <= 1.05 * sc_j, (sc_t, sc_j)


# ---------------------------------------------------------------------------
# inverse pre-emphasis with carry, converter context
# ---------------------------------------------------------------------------


def test_inv_preemphasis_carry_matches_jax():
    rs = np.random.RandomState(0)
    x = rs.randn(2, 1000).astype(np.float32)
    yj, yt = jnp.zeros((2,), jnp.float32), torch.zeros(2)
    for lo, hi in ((0, 300), (300, 301), (301, 1000)):
        oj, yj = j_dsp.inv_preemphasis_carry(jnp.asarray(x[:, lo:hi]), 0.97,
                                             yj)
        ot, yt = t_dsp.inv_preemphasis_carry(torch.from_numpy(x[:, lo:hi]),
                                             0.97, yt)
        assert maxdiff(ot, np.asarray(oj)) <= 1e-5 * max(
            1.0, float(np.abs(np.asarray(oj)).max()))
    full = t_dsp.inv_preemphasis(torch.from_numpy(x), 0.97)
    assert maxdiff(yt, full[:, -1]) <= 1e-5 * float(full.abs().max())


def test_converter_context_and_windows(tiny):
    """converter_context equals JAX's; every emitted frame of a windowed
    converter equals the full converter's."""
    (cfg_j, pj, _), (cfg_t, pt, _) = tiny
    ctx_l, ctx_r = t_stream.converter_context(cfg_t.converter)
    assert (ctx_l, ctx_r) == j_stream.converter_context(cfg_j.converter)
    rs = np.random.RandomState(1)
    X = torch.from_numpy(rs.rand(2, 64, cfg_t.converter.in_dim)
                         .astype(np.float32))
    up = cfg_t.converter.time_upsampling
    with torch.inference_mode():
        full = t_postnet(pt, cfg_t, X)
        assert maxdiff(full, np.asarray(j_postnet(pj, cfg_j, X.numpy()))) \
            <= 1e-5
        for ws, we, s, e in ((0, 40, 0, 40 - ctx_r),
                             (8, 48, 8 + ctx_l, 48 - ctx_r),
                             (24, 64, 24 + ctx_l, 64)):
            win = t_postnet(pt, cfg_t, X[:, ws:we])
            assert maxdiff(win[:, (s - ws) * up:(e - ws) * up],
                           full[:, s * up:e * up]) <= 1e-5


def test_decoded_samples_matches_jax(tiny):
    (cfg_j, _, ap_j), (cfg_t, _, ap_t) = tiny
    for steps in (0, 7, 24):
        assert t_stream.decoded_samples(cfg_t, ap_t, steps) == \
            j_stream.decoded_samples(cfg_j, ap_j, steps)


# ---------------------------------------------------------------------------
# the stream
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def streams(tiny):
    (cfg_j, pj, ap_j), (cfg_t, pt, ap_t) = tiny
    js = list(j_stream.tts_stream(pj, cfg_j, ap_j, j_en, TEXTS, **STREAM_KW))
    ts = list(t_stream.tts_stream(pt, cfg_t, ap_t, t_en, TEXTS, **STREAM_KW))
    return js, ts


def test_stream_matches_port_batch(tiny, streams):
    """Streamed linear frames and decoded lengths equal the port's batch
    path on the same device."""
    _, (cfg_t, pt, ap_t) = tiny
    _, ts = streams
    assert ts[-1]["final"] and not any(c["final"] for c in ts[:-1])
    dec = ts[-1]["decoded_steps"]
    lin = np.concatenate([c["linear"] for c in ts], axis=1)
    res = t_syn.tts_batch(pt, cfg_t, ap_t, t_en, TEXTS,
                          max_decoder_steps=STREAM_KW["max_decoder_steps"])
    for i, r in enumerate(res):
        assert dec[i] == r["num_decoder_steps"]
        n_lin = r["linear"].shape[0]
        batch_lin = (r["linear"] - ap_t.min_level_db) / -ap_t.min_level_db
        assert maxdiff(lin[i, :n_lin], batch_lin) <= 1e-5
    audio = np.concatenate([c["audio"] for c in ts], axis=1)
    assert audio.shape == (len(TEXTS), lin.shape[1] * ap_t.hop_size)
    starts = [c["sample_start"] for c in ts]
    sizes = [c["audio"].shape[1] for c in ts]
    assert starts == list(np.cumsum([0] + sizes[:-1]))
    assert np.isfinite(audio).all()


def test_stream_matches_jax_stream(tiny, streams):
    _, (cfg_t, _, ap_t) = tiny
    js, ts = streams
    assert [c["audio"].shape for c in ts] == [c["audio"].shape for c in js]
    assert [c["sample_start"] for c in ts] == [c["sample_start"] for c in js]
    np.testing.assert_array_equal(ts[-1]["decoded_steps"],
                                  js[-1]["decoded_steps"])
    lin_t = np.concatenate([c["linear"] for c in ts], axis=1)
    lin_j = np.concatenate([c["linear"] for c in js], axis=1)
    assert maxdiff(lin_t, lin_j) <= 1e-4
    at = np.concatenate([c["audio"] for c in ts], axis=1)
    aj = np.concatenate([c["audio"] for c in js], axis=1)
    assert maxdiff(at, aj) <= 0.12 * np.abs(aj).max()
    S = ap_t._denorm_pow(torch.from_numpy(lin_j)).numpy()
    for i in range(len(TEXTS)):
        coef = ap_t.preemphasis_coef
        sc_t = _sc(ref._preemphasis(at[i].astype(np.float64), coef), S[i])
        sc_j = _sc(ref._preemphasis(aj[i].astype(np.float64), coef), S[i])
        assert sc_t <= 1.05 * sc_j, (i, sc_t, sc_j)


def test_stream_alignment_and_single_chunk(tiny):
    """emit_alignment hands back the whole decode's attention on the last
    chunk; a stream of one chunk is final at once; speaker ids given to a
    single-speaker model raise."""
    _, (cfg_t, pt, ap_t) = tiny
    chunks = list(t_stream.tts_stream(pt, cfg_t, ap_t, t_en, TEXTS[2:],
                                      max_decoder_steps=8, first_chunk=8,
                                      gl_context=8, emit_alignment=True))
    assert len(chunks) == 1 and chunks[0]["final"]
    al = chunks[0]["alignment"]
    assert al.shape[:2] == (1, 8) and np.allclose(al.sum(-1), 1.0, atol=1e-4)
    with pytest.raises(ValueError):
        next(t_stream.tts_stream(pt, cfg_t, ap_t, t_en, TEXTS[:1],
                                 speaker_ids=[0]))


def test_streaming_vocoder_xfade_zero(tiny):
    """xfade=0 (no crossfade) emits every sample exactly once."""
    _, (_, _, ap_t) = tiny
    rs = np.random.RandomState(0)
    spec = torch.from_numpy(rs.rand(2, 24, FFT // 2 + 1).astype(np.float32))
    voc = t_stream.StreamingVocoder(ap_t, gl_context=8, gl_lookahead=0,
                                    xfade=0)
    parts = [voc.push(spec[:, :10]), voc.push(spec[:, 10:])]
    tail = voc.flush()
    if tail is not None:
        parts.append(tail)
    audio = np.concatenate(parts, axis=1)
    assert audio.shape == (2, 24 * HOP) and np.isfinite(audio).all()


# ---------------------------------------------------------------------------
# the HTTP engine
# ---------------------------------------------------------------------------


def test_serve_http_streaming(tiny):
    """Chunked WAV over HTTP from the tiny model: header, PCM trimmed to the
    decoded length, /healthz, /stats, JSON errors."""
    _, (cfg_t, pt, ap_t) = tiny
    engine = t_serve.TTSEngine(pt, cfg_t, ap_t, t_en, max_decoder_steps=24)
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 t_serve.make_handler(engine))
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = "http://127.0.0.1:%d" % port
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
            assert r.read() == b"ok"
        text = "hello streaming world."
        with urllib.request.urlopen(
                base + "/tts?text=hello%20streaming%20world.",
                timeout=300) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            body = r.read()
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        assert struct.unpack("<I", body[24:28])[0] == ap_t.sample_rate
        pcm = np.frombuffer(body[44:], "<i2")
        final = list(t_stream.tts_stream(pt, cfg_t, ap_t, t_en, [text],
                                         max_decoder_steps=24))[-1]
        assert len(pcm) == t_stream.decoded_samples(
            cfg_t, ap_t, final["decoded_steps"][0])
        for path, code in (("/tts", 400), ("/nowhere", 404)):
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(base + path, timeout=60)
            assert e.value.code == code
        with urllib.request.urlopen(base + "/stats", timeout=60) as r:
            import json
            stats = json.loads(r.read())
        assert stats["requests_total"] == 1 and stats["requests_failed"] == 0
        assert stats["ttfa_ms"]["count"] == 1 and stats["active_streams"] == 0
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    # slots > 0 is continuous batching (tests/test_torch_serving_http.py)
    engine = t_serve.TTSEngine(pt, cfg_t, ap_t, t_en, 24, slots=2)
    try:
        assert engine.stats()["slots"] == 2 and engine.batcher is not None
    finally:
        engine.shutdown()


def test_wav_helpers_match_root_serve():
    import serve as j_serve

    assert t_serve.wav_stream_header(22050) == j_serve.wav_stream_header(22050)
    x = np.linspace(-1.5, 1.5, 101).astype(np.float32)
    assert t_serve.pcm16(x) == j_serve.pcm16(x)
