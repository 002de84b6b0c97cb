# coding: utf-8
"""`python -m deepvoice3_pytorch_tpu_torch.cli.preprocess` against the root
preprocess.py (the JAX package) on one LJSpeech-layout corpus of synthetic
speech (utils/synthcorpus, 16-bit wavs), both with --device cpu /
JAX_PLATFORMS=cpu, on both backends: the same train.txt and dsp_config.json
bytes, and the same features (the native backend: bit for bit, the same C++
code; the device backend: each package's own FFT, held to the cross-FFT bar
of tests/test_torch_datasets.py). Then `cli.train --device cpu` takes two
steps on the port's corpus through the C++ loader. The other five corpus
layouts (tests/test_torch_datasets.py's tiny corpora) go through both
command lines on the native backend: the same train.txt bytes and
features bit for bit."""

import json
import os
import subprocess
import sys
from os.path import join

import numpy as np
import pytest
from scipy.io import wavfile

from deepvoice3_pytorch_tpu_torch.cli import preprocess as t_preprocess
from deepvoice3_pytorch_tpu_torch.utils import synthcorpus

from test_torch_datasets import CORPORA, COUNTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DSP_HP = "fft_size=128,hop_size=32,num_mels=16"
TRAIN_HP = DSP_HP + (",text_embed_dim=32,encoder_channels=32,"
                     "decoder_channels=32,converter_channels=32,"
                     "key_projection=true,value_projection=true,"
                     "max_positions=512,batch_size=4,checkpoint_interval=100,"
                     "eval_interval=100")
ENV = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


def _start(cmd, backend):
    env = dict(ENV, DV3_PREPROCESS_BACKEND=backend)
    return subprocess.Popen([sys.executable] + [str(a) for a in cmd],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


def _finish(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return out


OTHERS = ("vctk", "jsut", "nikl_s", "nikl_m", "json_meta")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The command lines this module reads, all started at once: the
    LJSpeech corpus through each package on each backend ({(who,
    backend): out}), and each other layout through the root script on the
    native backend ({name: (in_dir, hparams, out)})."""
    procs = []
    outs = _ljspeech_runs(tmp_path_factory, procs)
    others = {}
    for name in OTHERS:
        in_dir, overrides = CORPORA[name](tmp_path_factory.mktemp(name))
        hp = ",".join("%s=%s" % kv for kv in overrides.items())
        out = tmp_path_factory.mktemp(name + "-root")
        others[name] = (in_dir, hp, out)
        procs.append(_start([join(REPO, "preprocess.py"), name, in_dir, out,
                             "--num_workers", 2, "--hparams", hp], "native"))
    for p in procs:
        _finish(p)
    return outs, others


@pytest.fixture(scope="module")
def corpora(runs):
    return runs[0]


@pytest.fixture(scope="module")
def other_layouts(runs):
    return runs[1]


def _ljspeech_runs(tmp_path_factory, procs):
    root = tmp_path_factory.mktemp("ljspeech")
    os.makedirs(root / "wavs")
    texts = synthcorpus.make_sentences(10, seed=3, min_words=5)
    lines = []
    for i, text in enumerate(texts):
        wav = synthcorpus.synth_wav(text, 22050, 32)
        wavfile.write(str(root / "wavs" / ("LJ%03d.wav" % i)), 22050,
                      (wav * 32767).astype(np.int16))
        lines.append("LJ%03d|%s|%s" % (i, text.upper(), text))
    (root / "metadata.csv").write_text("\n".join(lines) + "\n",
                                       encoding="utf-8")
    outs = {}
    for backend in ("native", "device"):
        for who in ("port", "root"):
            out = tmp_path_factory.mktemp("%s-%s" % (who, backend))
            outs[who, backend] = out
            if who == "port":
                cmd = ["-m", "deepvoice3_pytorch_tpu_torch.cli.preprocess",
                       "ljspeech", root, out, "--device", "cpu",
                       "--num_workers", 2, "--hparams", DSP_HP,
                       "--summary-json", out / "summary.json"]
            else:
                cmd = [join(REPO, "preprocess.py"), "ljspeech", root, out,
                       "--num_workers", 2, "--hparams", DSP_HP]
            procs.append(_start(cmd, backend))
    return outs


@pytest.mark.parametrize("backend", ["native", "device"])
def test_preprocess_matches_root_script(corpora, backend):
    port, root = corpora["port", backend], corpora["root", backend]
    for name in ("train.txt", "dsp_config.json"):
        assert (port / name).read_bytes() == (root / name).read_bytes(), name
    lines = (port / "train.txt").read_text(encoding="utf-8").splitlines()
    assert len(lines) >= 8
    for line in lines:
        spec, mel, n, _ = line.split("|")
        for f in (spec, mel):
            a, b = np.load(port / f), np.load(root / f)
            assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
            assert a.shape[0] == int(n)
            if backend == "native":
                assert np.array_equal(a, b), f
            else:
                d = np.abs(a - b)
                assert d.max() <= 1e-3 and d.mean() <= 1e-5, (f, d.max())
    summary = json.loads((port / "summary.json").read_text())
    assert summary["utterances"] == len(lines)
    assert summary["backend"] == backend and summary["device"] == "cpu"
    assert summary["audio_s"] > 0 and summary["wall_s"] > 0


def test_train_two_steps_on_the_ports_corpus(corpora, tmp_path):
    data = corpora["port", "device"]
    ck = tmp_path / "ck"
    proc = _start(["-m", "deepvoice3_pytorch_tpu_torch.cli.train",
                   "--device", "cpu", "--data-root", data,
                   "--checkpoint-dir", ck, "--hparams", TRAIN_HP,
                   "--max-steps", 2, "--summary-json", tmp_path / "s.json"],
                  "device")
    _finish(proc)
    summary = json.loads((tmp_path / "s.json").read_text())
    assert summary["last_step"] == 2 and len(summary["losses"]) == 2
    assert all(np.isfinite(summary["losses"]))
    assert summary["loader_batches"]["native"] >= 2
    assert summary["loader_batches"]["numpy"] == 0


@pytest.mark.parametrize("name", OTHERS)
def test_other_layouts_match_root_script(other_layouts, name, tmp_path,
                                         monkeypatch):
    monkeypatch.setenv("DV3_PREPROCESS_BACKEND", "native")
    in_dir, hp, root = other_layouts[name]
    port = tmp_path / "port"
    t_preprocess.main([name, in_dir, str(port), "--device", "cpu",
                       "--num_workers", "2", "--hparams", hp])
    for f in ("train.txt", "dsp_config.json"):
        assert (port / f).read_bytes() == (root / f).read_bytes(), f
    lines = (port / "train.txt").read_text(encoding="utf-8").splitlines()
    n, cols = COUNTS[name]
    assert len(lines) == n and all(len(ln.split("|")) == cols
                                   for ln in lines)
    assert sorted(os.listdir(port)) == sorted(os.listdir(root))
    for f in os.listdir(port):
        if f.endswith(".npy"):
            assert np.array_equal(np.load(port / f), np.load(root / f)), f
