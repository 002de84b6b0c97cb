# coding: utf-8
"""The port's command lines under a mesh: `python -m torch.distributed.run`
(torchrun) starts two CPU ranks over gloo (--device cpu) on the tiny corpus
of tests/test_torch_cli.py.

  * cli.train --mesh-model 2 (tensor parallelism of the weights and
    sequence parallelism of the frames over both ranks, as the JAX
    train.py runs that flag) four steps, checkpoints at steps 2 and 4 and
    an eval at step 4: rank 0 alone prints, writes the files and
    synthesises the eval sentences; the step exchanged halos; JAX's
    load_checkpoint takes its file;
  * its step-2 file resumed under the same mesh gives the step-4 file of
    the uninterrupted run byte for byte; resumed in one process, the
    losses of steps 3 and 4 within 1e-6 relative and every parameter within
    2e-6 (the blocks sum the gradients in another order:
    tests/test_multichip.py's bar);
  * cli.synthesis --data-parallel on two ranks writes the wav files of the
    one-process run at the waveform bar of tests/test_multichip.py (5e-2 of
    the peak-normalised signal) with the same lengths.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from scipy.io import wavfile

import jax
import jax.numpy as jnp

from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.hparams import default_hparams as j_default
from deepvoice3_pytorch_tpu.model_builder import build_model as j_build
from deepvoice3_pytorch_tpu.training import checkpoint as jck
from deepvoice3_pytorch_tpu.training import trainer as jt
from deepvoice3_pytorch_tpu_torch.params import flatten_tree
from deepvoice3_pytorch_tpu_torch.training import checkpoint as tck

from test_torch_cli import ENV, HP, REPO, TEXTS, TRAIN_HP, corpus  # noqa

TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2"]


def _start(cmd):
    return subprocess.Popen([str(a) for a in cmd], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=ENV,
                            cwd=REPO)


def _finish(proc):
    out = proc.communicate(timeout=600)[0]
    assert proc.returncode == 0, out[-6000:]
    return out


def _cli(module, *args, ranks=True):
    head = TORCHRUN if ranks else [sys.executable]
    return _start(head + ["-m", "deepvoice3_pytorch_tpu_torch.cli." + module]
                  + list(args))


def _train_args(corpus, ck, *extra):
    return ("--device", "cpu", "--data-root", corpus, "--checkpoint-dir",
            ck, "--hparams", TRAIN_HP, "--max-steps", 4) + extra


def _params(path):
    return {k: np.asarray(v) for k, v in flatten_tree(
        tck._load_blob(str(path))["params"]).items()}


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """The mesh run, then (side by side) its step-2 file resumed under the
    mesh and in one process, and the synthesis runs."""
    out = tmp_path_factory.mktemp("mesh_cli")
    log = _finish(_cli("train", *_train_args(
        corpus, out / "mesh", "--mesh-model", 2, "--summary-json",
        out / "mesh.json")))
    step2 = out / "mesh" / "checkpoint_step000000002.ckpt"
    step4 = out / "mesh" / "checkpoint_step000000004.ckpt"
    (out / "texts.txt").write_text("\n".join(TEXTS) + "\n")
    syn = ("synthesis", step4, out / "texts.txt")
    syn_kw = ("--hparams", HP, "--max-decoder-steps", 11, "--batch-size", 3,
              "--device", "cpu")
    procs = {
        "resume_mesh": _cli("train", *_train_args(
            corpus, out / "resume_mesh", "--mesh-model", 2,
            "--checkpoint", step2)),
        "resume_one": _cli("train", *_train_args(
            corpus, out / "resume_one", "--checkpoint", step2,
            "--summary-json", out / "one.json"), ranks=False),
        "syn_dp": _cli(*syn, out / "syn_dp", *syn_kw, "--data-parallel"),
        "syn_one": _cli(*syn, out / "syn_one", *syn_kw, ranks=False),
    }
    logs = {k: _finish(p) for k, p in procs.items()}
    return dict(out=out, log=log, logs=logs, step2=step2, step4=step4)


def test_tp_train_writes_on_rank_zero_alone(runs):
    out, log = runs["out"], runs["log"]
    assert log.count("Mesh: data=1, model=2 over 2 process(es), gloo") == 1
    assert log.count("Sequence parallelism: frames over the 2 model "
                     "ranks") == 1
    assert log.count("Saved final checkpoint at step 4") == 1
    assert log.count("step 1 | loss") == 1
    summary = json.loads((out / "mesh.json").read_text())
    assert len(summary["losses"]) == 4 and np.isfinite(
        summary["losses"]).all()
    assert summary["collectives"]["halo"] > 0
    assert sorted(os.listdir(out / "mesh" / "eval")) == sorted(
        "step000000004_eval_%d_single.wav" % i for i in range(6))
    ckpts = sorted(f for f in os.listdir(out / "mesh") if f.endswith(
        ".ckpt"))
    assert ckpts == [runs["step2"].name, runs["step4"].name]
    hp = j_default().parse(TRAIN_HP)
    _, template = j_build(hp, j_en.n_vocab, seed=7)
    template = jax.tree.map(jnp.asarray, template)
    opt = jt.make_optimizer(hp, jt.make_lr_fn(hp))
    _, opt_state, step, _ = jck.load_checkpoint(
        str(runs["step4"]), template, opt.init(template))
    assert step == 4 and opt_state is not None


def test_tp_resume_under_the_mesh_is_bit_exact(runs):
    resumed = runs["out"] / "resume_mesh" / runs["step4"].name
    assert resumed.read_bytes() == runs["step4"].read_bytes()


def test_tp_checkpoint_resumes_in_one_process(runs):
    out = runs["out"]
    mesh = json.loads((out / "mesh.json").read_text())["losses"]
    one = json.loads((out / "one.json").read_text())["losses"]
    assert len(one) == 2
    for g, w in zip(one, mesh[2:]):
        assert abs(g - w) <= 1e-6 * abs(w)
    got = _params(out / "resume_one" / runs["step4"].name)
    want = _params(runs["step4"])
    assert got.keys() == want.keys()
    assert max(float(np.abs(got[k] - want[k]).max()) for k in want) <= 2e-6


def test_data_parallel_synthesis_writes_the_one_process_files(runs):
    out = runs["out"]
    assert runs["logs"]["syn_dp"].count("Finished!") == 1
    for i in range(len(TEXTS)):
        name = "%d_%s.wav" % (i, runs["step4"].stem)
        _, got = wavfile.read(out / "syn_dp" / name)
        _, want = wavfile.read(out / "syn_one" / name)
        assert got.shape == want.shape
        assert np.abs(got.astype(np.float64) - want).max() <= 5e-2 * 32767
