# coding: utf-8
"""The port's command lines (deepvoice3_pytorch_tpu_torch/cli) run as
subprocesses with --device cpu on a tiny preprocessed corpus made here
(random features, 8 utterances, the DSP stamp of the active hparams),
against the JAX package:

  * cli.train writes checkpoints that JAX's load_checkpoint accepts
    (optimizer fingerprint included); --checkpoint resumes one of them to
    the same losses and the same file bytes as the uninterrupted run; a
    corpus with another DSP stamp is refused;
  * cli.synthesis on a checkpoint the JAX package wrote writes wavs that
    match JAX's tts_batch on the same file at tests/test_torch_synthesis.py's
    bars (decoded steps exact, waveform 0.12 of the peak);
  * cli.serve's build_engine answers a /tts request;
  * cli.convert_checkpoint on a reference-layout state dict built from a
    JAX tree equals JAX's import_state_dict;
  * cli.dump_hparams_to_json and cli.compute_timestamp_ratio print and
    write what the root scripts do.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
from os.path import join

import numpy as np
import pytest
import torch
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from deepvoice3_pytorch_tpu import synthesis as j_syn
from deepvoice3_pytorch_tpu.dsp.audio import AudioProcessor as JAP
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_default
from deepvoice3_pytorch_tpu.model_builder import build_model as j_build
from deepvoice3_pytorch_tpu.training import checkpoint as jck
from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu.utils import torch_import as j_import
from deepvoice3_pytorch_tpu_torch import serve
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams
from deepvoice3_pytorch_tpu_torch.params import flatten_tree
from deepvoice3_pytorch_tpu_torch.training import dataset
from deepvoice3_pytorch_tpu_torch.cli.serve import build_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the tiny LJSpeech structure of tests/torch_port_common.py:TINY
HP = ("text_embed_dim=32,encoder_channels=32,decoder_channels=32,"
      "converter_channels=32,fft_size=128,hop_size=32,num_mels=16,"
      "key_projection=true,value_projection=true,max_positions=128,"
      "batch_size=4")
TRAIN_HP = HP + (",checkpoint_interval=2,eval_interval=4,"
                 "max_decoder_steps=12")
TEXTS = ["Hello world.", "Printing, in the only sense.", "A test."]
ENV = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")


def _hp(overrides=HP):
    return default_hparams().parse(overrides)


def start(cmd):
    """A subprocess of this repo's command line `cmd`; finish() waits."""
    return subprocess.Popen([sys.executable] + [str(a) for a in cmd],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=ENV, cwd=REPO)


def finish(proc, check=True):
    out, err = proc.communicate(timeout=600)
    if check:
        assert proc.returncode == 0, out[-3000:] + err[-3000:]
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def cli(module, *args):
    return start(["-m", "deepvoice3_pytorch_tpu_torch.cli." + module]
                 + list(args))


def run(module, *args, check=True):
    return finish(cli(module, *args), check)


def root_script(name, *args):
    return start([join(REPO, name)] + list(args))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    rs = np.random.RandomState(0)
    lines = []
    for i in range(8):
        T = int(rs.randint(40, 80))
        np.save(root / ("x-mel-%05d.npy" % i),
                rs.rand(T, 16).astype(np.float32))
        np.save(root / ("x-spec-%05d.npy" % i),
                rs.rand(T, 65).astype(np.float32))
        lines.append("|".join(["x-spec-%05d.npy" % i, "x-mel-%05d.npy" % i,
                               str(T), "hello world number %d." % i]))
    (root / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    dataset.write_dsp_stamp(str(root), _hp())
    return root


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """Four steps, checkpoints at steps 2 and 4, an eval at step 4, a
    profiler trace of steps 1 and 2."""
    out = tmp_path_factory.mktemp("train")
    run("train", "--device", "cpu", "--data-root", corpus,
        "--checkpoint-dir", out / "ck", "--hparams", TRAIN_HP,
        "--max-steps", 4, "--summary-json", out / "a.json",
        "--log-event-path", out / "log", "--profile-dir", out / "trace",
        "--profile-start", 1, "--profile-steps", 2)
    return out


def test_train_writes_what_jax_loads(trained):
    summary = json.loads((trained / "a.json").read_text())
    assert len(summary["losses"]) == 4
    assert np.isfinite(summary["losses"]).all()
    assert len(os.listdir(trained / "ck" / "eval")) == 6
    with open(trained / "trace" / "trace_steps1-2.json") as f:
        assert json.load(f)["traceEvents"]
    path = str(trained / "ck" / "checkpoint_step000000004.ckpt")
    hp = j_default().parse(TRAIN_HP)
    _, template = j_build(hp, j_en.n_vocab, seed=7)
    template = jax.tree.map(jnp.asarray, template)
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    params, opt_state, step, epoch = jck.load_checkpoint(
        path, template, opt.init(template))
    # max-steps ends the run inside its second epoch: one epoch counted
    assert (step, epoch) == (4, 1)
    assert int(jax.tree_util.tree_leaves(opt_state)[0]) == 4
    blob = jck._load_blob(path)
    want = flatten_tree(blob["params"])
    got = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    assert want.keys() == got.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_train_resumes_to_the_same_steps(trained, corpus):
    """Resumed from step 2 (the end of the first epoch), steps 3 and 4 take
    the same batches and dropout draws: equal losses, equal files."""
    run("train", "--device", "cpu", "--data-root", corpus,
        "--checkpoint-dir", trained / "ck_resume", "--hparams", TRAIN_HP,
        "--max-steps", 4, "--summary-json", trained / "b.json",
        "--checkpoint", trained / "ck" / "checkpoint_step000000002.ckpt",
        "--log-event-path", trained / "log")
    a = json.loads((trained / "a.json").read_text())
    b = json.loads((trained / "b.json").read_text())
    assert b["first_step"] == 3 and b["load_ms"] > 0
    assert b["losses"] == a["losses"][2:]
    name = "checkpoint_step000000004.ckpt"
    assert (trained / "ck_resume" / name).read_bytes() == \
        (trained / "ck" / name).read_bytes()


def test_train_refuses_a_corpus_of_other_dsp(corpus, tmp_path):
    other = tmp_path / "corpus"
    shutil.copytree(corpus, other)
    dataset.write_dsp_stamp(str(other), _hp(HP + ",hop_size=16"))
    r = run("train", "--device", "cpu", "--data-root", other,
            "--checkpoint-dir", tmp_path / "ck", "--hparams", TRAIN_HP,
            "--max-steps", 1, check=False)
    assert r.returncode != 0
    assert "DSP convention mismatch" in r.stderr


def test_synthesis_matches_jax_on_a_jax_checkpoint(tmp_path, monkeypatch):
    hp = j_default().parse(HP)
    cfg, params = j_build(hp, j_en.n_vocab, seed=3)
    path = str(tmp_path / "checkpoint_step000000010.ckpt")
    jck.save_checkpoint_file(path, params, None, 10, 1)
    (tmp_path / "texts.txt").write_text("\n".join(TEXTS) + "\n")
    proc = cli("synthesis", path, tmp_path / "texts.txt", tmp_path / "out",
               "--hparams", HP, "--max-decoder-steps", 11, "--batch-size",
               3, "--device", "cpu", "--output-html")
    monkeypatch.setenv("DV3_PALLAS_GL", "1")
    want = j_syn.tts_batch(params, cfg, JAP(hp), j_en, TEXTS,
                           max_decoder_steps=11, fused=True)
    finish(proc)
    for i, (text, res) in enumerate(zip(TEXTS, want)):
        stem = str(tmp_path / "out" / ("%d_checkpoint_step000000010" % i))
        assert open(stem + ".txt").read() == text + "\n"
        rate, wav = wavfile.read(stem + ".wav")
        assert rate == hp.sample_rate
        assert wav.shape == (res["num_decoder_steps"] * 4 * hp.hop_size,)
        w = res["waveform"]
        w = w * 32767 / max(0.01, np.abs(w).max())
        assert np.abs(wav.astype(np.float64) - w).max() < 0.12 * 32767
    assert (tmp_path / "out" / "index.html").read_text().count(
        "<audio") == 3


def test_serve_engine_answers_a_request(trained):
    engine = build_engine(
        str(trained / "ck" / "checkpoint_step000000004.ckpt"),
        hparams_str=HP, max_decoder_steps=12, device="cpu")
    httpd = serve.TTSServer(("127.0.0.1", 0), serve.make_handler(engine))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        url = "http://127.0.0.1:%d/tts?text=hello%%20world." \
            % httpd.server_address[1]
        with urllib.request.urlopen(url, timeout=300) as r:
            assert r.status == 200
            body = r.read()
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.shutdown()
    assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
    assert len(body) > 44 and (len(body) - 44) % 2 == 0


def _reference_state_dict(np_tree, cfg):
    """The reference (r9y9) layout of a JAX parameter tree: JAX's own
    import_state_dict is run with its per-module readers replaced by
    recorders, which yields the reference name of each module at its place
    in the tree; the layout rules of utils/torch_import.py then give each
    tensor."""
    def recorder(kind):
        return lambda sd, prefix: {"__prefix__": prefix, "__kind__": kind}

    mp = pytest.MonkeyPatch()
    for kind in ("_linear", "_conv1d", "_convT1d", "_embedding"):
        mp.setattr(j_import, kind, recorder(kind))
    try:
        names = j_import.import_state_dict({}, cfg)
    finally:
        mp.undo()
    sd = {}

    def walk(n, p):
        if isinstance(n, dict) and "__kind__" in n:
            pre, kind = n["__prefix__"], n["__kind__"]
            if kind == "_embedding":
                sd[pre + ".weight"] = p["w"]
                return
            v, g = np.asarray(p["v"]), np.asarray(p["g"])
            if kind == "_linear":
                sd[pre + ".weight_v"] = v.T
                sd[pre + ".weight_g"] = g[:, None]
            elif kind == "_conv1d":
                sd[pre + ".weight_v"] = v.transpose(2, 1, 0)
                sd[pre + ".weight_g"] = g[:, None, None]
            else:
                sd[pre + ".weight_v"] = v.transpose(1, 2, 0)
                sd[pre + ".weight_g"] = g[:, None, None]
            sd[pre + ".bias"] = p["b"]
        elif isinstance(n, dict):
            for k in n:
                walk(n[k], p[k])
        else:
            for a, b in zip(n, p):
                walk(a, b)

    walk(names, np_tree)
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in sd.items()}


@pytest.mark.parametrize("preset", ["deepvoice3_ljspeech", "nyanko_ljspeech"])
def test_convert_checkpoint_matches_jax_import(tmp_path, preset):
    small = ("text_embed_dim=32,encoder_channels=32,decoder_channels=32,"
             "converter_channels=32")
    hp = j_default()
    with open(join(REPO, "presets", preset + ".json")) as f:
        hp.parse_json(f.read())
    hp.parse(small)
    cfg, params = j_build(hp, j_en.n_vocab, seed=5)
    params = jax.tree_util.tree_map(np.asarray, params)
    sd = _reference_state_dict(params, cfg)
    pth = tmp_path / "ref.pth"
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()},
                "global_step": 7, "global_epoch": 2}, pth)
    out = tmp_path / "converted.ckpt"
    run("convert_checkpoint", pth, out, "--preset",
        join(REPO, "presets", preset + ".json"), "--hparams", small)
    want = flatten_tree(j_import.import_state_dict(
        {k: v.numpy() for k, v in sd.items()}, cfg))
    assert want.keys() == flatten_tree(params).keys()
    blob = jck._load_blob(str(out))
    assert (blob["global_step"], blob["global_epoch"]) == (7, 2)
    got = flatten_tree(blob["params"])
    src = flatten_tree(params)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert np.array_equal(got[k], src[k]), k   # the layout round-trips


def test_dump_hparams_matches_root_script(tmp_path):
    args = ["--preset", join(REPO, "presets", "nyanko_ljspeech.json"),
            "--hparams", "batch_size=3,dropout=0.1"]
    procs = (root_script("dump_hparams_to_json.py", tmp_path / "jax.json",
                         *args),
             cli("dump_hparams_to_json", tmp_path / "port.json", *args))
    a, b = (finish(p) for p in procs)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    assert b.stdout.replace("port.json", "") == \
        a.stdout.replace("jax.json", "")


def test_compute_timestamp_ratio_matches_root_script(corpus):
    args = [corpus, "--hparams=outputs_per_step=4,downsample_step=1"]
    procs = (root_script("compute_timestamp_ratio.py", *args),
             cli("compute_timestamp_ratio", *args))
    a, b = (finish(p) for p in procs)
    assert b.stdout == a.stdout
    assert "key_position_rate" in b.stdout


def test_data_loader_matches_jax_and_raises(corpus):
    """The prefetching loader yields the JAX package's numpy batches (its
    Python collate path) in the same order, and re-raises a failure of its
    producer thread instead of ending the epoch early."""
    from deepvoice3_pytorch_tpu.training import dataset as j_ds
    from deepvoice3_pytorch_tpu_torch.frontend import en as t_en

    def batches(mod, fe, **kw):
        ds = mod.TTSDataset(str(corpus), fe, 0.0)
        sampler = mod.SimilarTimeLengthSampler(ds.meta.frame_lengths,
                                               batch_size=4)
        return list(mod.DataLoader(ds, sampler, 1, 4, length_bucket_step=8,
                                   frame_bucket_step=4, **kw))

    want = batches(j_ds, j_en, use_native=False)
    got = batches(dataset, t_en)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert np.array_equal(g[k], w[k]), k

    ds = dataset.TTSDataset(str(corpus), t_en, 0.0)
    ds.meta.mel_files[5] = "missing.npy"
    loader = dataset.DataLoader(
        ds, dataset.SimilarTimeLengthSampler(ds.meta.frame_lengths, 4,
                                             permutate=False), 1, 4)
    with pytest.raises(FileNotFoundError):
        list(loader)
