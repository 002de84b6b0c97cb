# coding: utf-8
"""The run command without a card, the cell files BENCHMARK.json names,
and the contract's names, units and result keys."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT
from dv3bench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CMD = [sys.executable, "dv3bench/run.py", "--workload",
       "dv3_ljspeech.batch32", "--seed", "3000000000", "--seconds", "1",
       "--trace", "0"]


def _run(cwd):
    return subprocess.run(CMD, capture_output=True, text=True, timeout=300,
                          cwd=str(cwd), env={"PATH": "/usr/bin:/bin",
                                             "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "dv3bench", tmp_path / "dv3bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_every_cell_finds_its_files_and_readers():
    spec = bench.benchmark()
    for cell in spec["workloads"]:
        _, hp, traffic, limits = bench.cell_files(cell["name"], spec)
        assert (ROOT / "dv3bench" / "kinds" / (traffic["kind"] + ".py")) \
            .exists()
        assert limits
        per_layer = bench.cell_metrics(cell["name"], spec, "per_layer")
        e2e = bench.cell_metrics(cell["name"], spec)
        assert [m["name"] for m in e2e].count("setup_s") == 1 and len(e2e) > 1
        assert per_layer
        for m in per_layer:
            assert m["moves"] in [x["name"] for x in e2e]
            assert callable(bench.load_metric(m["name"]))


def test_names_units_and_keys_follow_the_contract():
    spec = bench.benchmark()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in spec["workloads"]]:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^b\d_roofline\.", m["name"]) and m["unit"] == "%"
    for m in spec["end_to_end"]:
        assert 0 < m["bound"] <= 0.25


def test_result_line_keys(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"synth_rtf": {"value": 1.5, "unit": "audio_s/s"}},
              "device": {"platform": "gpu", "kind": "x", "count": 1,
                         "memory_peak_bytes": 1}}
    ok, rows = bench.judge({"frame_gap": 1e-6, "shape_faults": 0},
                           {"frame_gap": 1e-4, "shape_faults": 0})
    assert ok
    bench.emit(result, rows)
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checked"]
    assert cap.err.strip().splitlines()[-1].startswith("check shape_faults")


@pytest.mark.parametrize("numbers,ok", [
    ({"a": 1.0, "b": 0}, True), ({"a": 2.5, "b": 0}, False),
    ({"a": float("nan"), "b": 0}, False), ({"b": 0}, False),
    ({"a": 1.0, "b": 0, "c": 0.0}, False)])
def test_judge_needs_every_number_under_its_limit(numbers, ok):
    assert bench.judge(numbers, {"a": 2.0, "b": 0})[0] is ok
