# coding: utf-8
"""The port's corpus adapters (deepvoice3_pytorch_tpu_torch/datasets/)
against the JAX package's on the tiny corpora of tests/test_datasets.py:
the same metadata (so the same train.txt) and the same features.

Both packages run each adapter on each backend: "native" (the host C++
library, the same code in both: the .npy files are equal bit for bit) and
"device" (each package's batched features on the CPU). The two device
routes take different f32 FFTs (pocketfft against XLA's), whose errors are
~1e-7 of the spectrum's peak; the 16-bit tones here leave most bins 70-100
dB below it, where that is a relative error of up to ~1e-3, and the dB
scale makes it absolute: up to 4.1e-4 (0.04 dB) on [0, 1] features, more
than 1e-5 in ~10 % of the bins, 5e-6 on average. So the device route is
held to 1e-3 (0.1 dB) at most and 1e-5 on average."""

import json
import os
import warnings

import numpy as np
import pytest
from scipy.io import wavfile

from deepvoice3_pytorch_tpu import datasets as j_datasets
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAudio
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_hparams
from deepvoice3_pytorch_tpu.training import dataset as j_dataset
from deepvoice3_pytorch_tpu_torch import datasets as t_datasets
from deepvoice3_pytorch_tpu_torch.datasets import common as t_common
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor as TAudio
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams as t_hparams
from deepvoice3_pytorch_tpu_torch.training import dataset as t_dataset

import torch_port_common  # noqa: F401  (one torch thread a worker)

TEXT = "This is a synthetic sentence long enough to pass the filter."


def _hps(**kw):
    out = []
    for make in (j_hparams, t_hparams):
        hp = make()
        for k, v in kw.items():
            setattr(hp, k, v)
        out.append(hp)
    return out


def _wav(path, n=9000, f=300.0, sr=22050):
    t = np.arange(n) / sr
    w = (0.4 * np.sin(2 * np.pi * f * t)
         * (1.0 + 0.3 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)
    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    wavfile.write(str(path), sr, (w * 32767).astype(np.int16))


def _ljspeech(root):
    lines = []
    for i in range(3):
        _wav(root / "wavs" / ("LJ-%d.wav" % i), n=7000 + 1500 * i)
        lines.append("LJ-%d|x|%s" % (i, TEXT))
    lines.append("LJ-9|x|short")                     # dropped by min_text
    (root / "metadata.csv").write_text("\n".join(lines))
    return str(root), {}


def _vctk(root):
    for spk in ("p225", "p226"):
        for j in range(2):
            _wav(root / "wav48" / spk / ("%s_%03d.wav" % (spk, j)),
                 f=250.0 + 40 * j)
            p = root / "txt" / spk / ("%s_%03d.txt" % (spk, j))
            os.makedirs(p.parent, exist_ok=True)
            p.write_text(TEXT)
    lab = root / "lab" / "p225" / "p225_000.lab"
    os.makedirs(lab.parent, exist_ok=True)
    lab.write_text("0 1000000 pau\n1000000 3000000 ah\n3000000 4000000 pau\n")
    return str(root), {}


def _jsut(root):
    sub = root / "basic5000"
    lines = []
    for i in range(2):
        _wav(sub / "wav" / ("BASIC_%d.wav" % i), n=8000 + 500 * i)
        lines.append("BASIC_%d:%s" % (i, TEXT))
    (sub / "transcript_utf8.txt").write_text("\n".join(lines))
    lab = sub / "lab" / "BASIC_0.lab"
    os.makedirs(lab.parent, exist_ok=True)
    lab.write_text("0 500000 silB\n500000 3000000 a\n3000000 4000000 silE\n")
    return str(root), dict(frontend="en")


def _nikl(root, speaker_file, contents):
    os.makedirs(root, exist_ok=True)
    lines = []
    for spk in ("fv01", "fv02"):
        for j in range(1, 3):
            p = root / ("%s_t%02d.wav" % (spk, j))
            _wav(p, n=7000 + 700 * j)
            lines.append("%s|%s" % (p, TEXT))
    (root / speaker_file).write_text(contents)
    (root / "metadata.txt").write_text("\n".join(lines))
    return str(root), {}


def _json_meta(root):
    os.makedirs(root, exist_ok=True)
    for i in range(3):
        _wav(root / ("u%d.wav" % i), n=6000 + 1000 * i)
    info = {str(root / "u0.wav"): TEXT,
            str(root / "u1.wav"): [TEXT + " x", TEXT],
            str(root / "u2.wav"): [TEXT]}
    (root / "meta.json").write_text(json.dumps(info))
    return str(root / "meta.json"), dict(ignore_recognition_level=0)


CORPORA = {
    "ljspeech": _ljspeech,
    "vctk": _vctk,
    "jsut": _jsut,
    "nikl_s": lambda r: _nikl(r, "speaker.sid", "fv02\n"),
    "nikl_m": lambda r: _nikl(r, "speaker.mid", "fv01\nfv02\n"),
    "json_meta": _json_meta,
}
COUNTS = {"ljspeech": (3, 4), "vctk": (4, 5), "jsut": (2, 4), "nikl_s": (2, 4),
          "nikl_m": (4, 5), "json_meta": (3, 4)}


def _close_npy(a, b, exact):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    if exact:
        assert np.array_equal(a, b)
    else:
        d = np.abs(a - b)
        assert d.max() <= 1e-3 and d.mean() <= 1e-5, (d.max(), d.mean())


@pytest.mark.parametrize("backend", ["native", "device"])
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_adapter_matches_jax(tmp_path, monkeypatch, name, backend):
    monkeypatch.setenv("DV3_PREPROCESS_BACKEND", backend)
    in_dir, overrides = CORPORA[name](tmp_path / "corpus")
    hj, ht = _hps(**overrides)
    out_j, out_t = str(tmp_path / "jax"), str(tmp_path / "port")
    meta_j = j_datasets.get_preprocessor(name).build_from_path(
        in_dir, out_j, JAudio(hj), hj, num_workers=2)
    meta_t = t_datasets.get_preprocessor(name).build_from_path(
        in_dir, out_t, TAudio(ht), ht, num_workers=2, device="cpu")
    assert meta_t == meta_j                 # train.txt lines, in order
    n, cols = COUNTS[name]
    assert len(meta_t) == n and all(len(m) == cols for m in meta_t)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for m in meta_t:
        for f in m[:2]:
            _close_npy(np.load(os.path.join(out_t, f)),
                       np.load(os.path.join(out_j, f)),
                       exact=backend == "native")
        assert np.load(os.path.join(out_t, m[0])).shape == (m[2], 513)
        assert np.load(os.path.join(out_t, m[1])).shape == (m[2], 80)


def test_center_mode_native_warns_and_takes_the_device_route(tmp_path,
                                                             monkeypatch):
    """The C++ library knows only the lws framing: asked for it with
    stft_mode='center', process_utterances warns and computes centred
    features on the device route, equal to batch_features'."""
    monkeypatch.setenv("DV3_PREPROCESS_BACKEND", "native")
    in_dir, _ = _ljspeech(tmp_path / "corpus")
    hj, ht = _hps(stft_mode="center")
    ap = TAudio(ht)
    out = str(tmp_path / "out")
    with pytest.warns(UserWarning, match="stft_mode"):
        meta = t_datasets.ljspeech.build_from_path(in_dir, out, ap, ht,
                                                   device="cpu")
    utts = t_datasets.ljspeech.collect(in_dir, ht)
    wavs = [t_common.load_and_trim(ap, ht, u) for u in utts]
    for m, w, (lin, mel) in zip(meta, wavs,
                                ap.batch_features(wavs, device="cpu")):
        assert m[2] == ap.num_frames(len(w)) == 1 + len(w) // 256
        assert np.array_equal(np.load(os.path.join(out, m[0])), lin)
        assert np.array_equal(np.load(os.path.join(out, m[1])), mel)
    meta_j = j_datasets.ljspeech.build_from_path(
        in_dir, str(tmp_path / "jax"), JAudio(hj), hj)
    assert meta == meta_j


def test_unknown_backend_raises(tmp_path):
    in_dir, _ = _ljspeech(tmp_path / "corpus")
    _, ht = _hps()
    utts = t_datasets.ljspeech.collect(in_dir, ht)
    with pytest.raises(ValueError, match="backend"):
        t_common.process_utterances(utts, str(tmp_path / "o"), TAudio(ht),
                                    ht, "x", backend="gpu")


def test_trim_helpers_match_jax():
    from deepvoice3_pytorch_tpu.datasets import common as j_common
    rs = np.random.RandomState(0)
    wav = np.concatenate([1e-4 * rs.randn(3000), np.sin(np.arange(9000)),
                          1e-4 * rs.randn(4000)]).astype(np.float32)
    for top_db in (15, 25, 60):
        got, span = t_common.trim_silence(wav, top_db=top_db)
        want, span_j = j_common.trim_silence(wav, top_db=top_db)
        assert span == span_j and np.array_equal(got, want)
    labels = [(0, 10, "pau"), (10, 20, "a"), (20, 30, "b"), (30, 40, "pau")]
    assert t_common.lab_trim_bounds_pau(labels) == \
        j_common.lab_trim_bounds_pau(labels) == (10, 30)


def test_dsp_stamp_roundtrip_and_mismatch(tmp_path):
    """The stamp the port writes is the JAX package's file; each package
    accepts the other's for the same hparams and refuses a changed
    framing."""
    hj, ht = _hps()
    t_dataset.write_dsp_stamp(str(tmp_path), ht)
    with open(tmp_path / "dsp_config.json") as f:
        port_bytes = f.read()
    j_dataset.write_dsp_stamp(str(tmp_path), hj)
    with open(tmp_path / "dsp_config.json") as f:
        assert f.read() == port_bytes
    t_dataset.check_dsp_stamp(str(tmp_path), ht)
    j_dataset.check_dsp_stamp(str(tmp_path), hj)
    _, ht2 = _hps(stft_mode="center")
    with pytest.raises(SystemExit, match="stft_mode"):
        t_dataset.check_dsp_stamp(str(tmp_path), ht2)
    os.remove(tmp_path / "dsp_config.json")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        t_dataset.check_dsp_stamp(str(tmp_path), ht)
    assert any("dsp_config" in str(x.message) for x in w)
