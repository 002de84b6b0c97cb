# coding: utf-8
"""Nothing the run command loads is JAX, jaxlib, flax or the JAX package
(`deepvoice3_pytorch_tpu`), module names compared whole by their top-level
name (the port's name begins with the JAX package's), and the reference
imports nothing of the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from conftest import ROOT
from dv3bench import bench

HERE = ROOT / "dv3bench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    fake = dict(sys.modules)
    for name in ("deepvoice3_pytorch_tpu_torch.serve", "jaxtyping",
                 "flaxen", "dv3bench.jax_free"):
        fake[name] = None
    monkeypatch.setattr(sys, "modules", fake)
    assert bench.forbidden_modules() == []
    fake["deepvoice3_pytorch_tpu.ops"] = None
    fake["jax.numpy"] = None
    assert bench.forbidden_modules() == ["deepvoice3_pytorch_tpu.ops",
                                         "jax.numpy"]


def test_no_source_imports_jax_or_the_jax_package():
    for path in sorted(HERE.rglob("*.py")):
        bad = [m for m in _imports(path) if m in bench.FORBIDDEN]
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in sorted((HERE / "reference").glob("*.py")):
        mods = set(_imports(path))
        assert "deepvoice3_pytorch_tpu_torch" not in mods, path
        assert not mods & set(bench.FORBIDDEN), path
        assert not mods - {"math", "dataclasses", "typing", "numpy", "torch"}, \
            (path, mods)


RUN_BOTH = r"""
import json, sys
sys.path.insert(0, %r)
sys.path.insert(0, %r)
from conftest import small_traffic, tiny_hp
from dv3bench import bench
from dv3bench.kinds import batch_synthesis, train_step
import torch
torch.set_num_threads(1)
batch_synthesis.run(tiny_hp("dv3_ljspeech"), small_traffic("ljspeech_batch32"),
                    7, 0.1, 1, "cpu", lambda: None)
train_step.run(tiny_hp("dv3_vctk"), small_traffic("vctk_train16"), 7, 0.1, 0,
               "cpu", lambda: None)
print(json.dumps(bench.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    """Both kinds' whole path (set-up, window, trace, judge) in a fresh
    interpreter, then the modules it loaded."""
    code = RUN_BOTH % (str(ROOT), str(HERE / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT),
                         env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
                              "HOME": str(Path.home())})
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
