# coding: utf-8
"""The plain reference against the port at tiny sizes on the CPU, through
each cell's loop (traffic, the port's timed path, the judge), and the
faults each cell can have planted under the timed path: each must turn
`correct` false under the cell's limits."""

import pytest

from conftest import small_traffic, tiny_hp
from dv3bench import bench, faults
from dv3bench.kinds import batch_synthesis, train_step

SEED = 2 ** 31 + 12345


def _batch(cell, config, traffic, **kw):
    return batch_synthesis.run(tiny_hp(config), small_traffic(traffic), SEED,
                               0.2, 0, "cpu", lambda: None, **kw)


def _train(**kw):
    return train_step.run(tiny_hp("dv3_vctk"), small_traffic("vctk_train16"),
                          SEED, 0.2, 0, "cpu", lambda: None, **kw)


BATCH_CELLS = [("dv3_ljspeech.batch32", "dv3_ljspeech", "ljspeech_batch32"),
               ("dv3_vctk.batch32", "dv3_vctk", "vctk_batch32")]


@pytest.mark.parametrize("cell,config,traffic", BATCH_CELLS)
def test_batch_reference_agrees_with_port(cell, config, traffic):
    out = _batch(cell, config, traffic)
    assert out["notes"]["judged_calls"]
    nums = out["numbers"]
    assert nums["shape_faults"] == 0
    for k in ("frame_gap", "align_gap", "linear_gap"):
        assert nums[k] < 1e-5, (k, nums)
    assert abs(nums["gl_sc_excess"]) < 1e-3, nums
    assert bench.judge(nums, bench.limits(cell))[0]


@pytest.mark.parametrize("fault", sorted(faults.BY_KIND["batch_synthesis"][1]))
def test_batch_faults_are_not_correct(fault):
    cell, config, traffic = BATCH_CELLS[0]
    out = _batch(cell, config, traffic,
                 call_fault=faults.BY_KIND["batch_synthesis"][1][fault])
    assert not bench.judge(out["numbers"], bench.limits(cell))[0], out["numbers"]


def test_train_reference_agrees_with_port():
    out = _train()
    nums = out["numbers"]
    assert nums["frozen_moved"] == 0
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert nums[k] < 1e-4, (k, nums)
    assert bench.judge(nums, bench.limits("dv3_vctk.train16"))[0]


@pytest.mark.parametrize("fault", sorted(faults.BY_KIND["train_step"][1]))
def test_train_faults_are_not_correct(fault):
    out = _train(step_fault=faults.BY_KIND["train_step"][1][fault])
    assert not bench.judge(out["numbers"],
                           bench.limits("dv3_vctk.train16"))[0], out["numbers"]


def test_windows_followed_through_every_tie(monkeypatch):
    """With every window counted as tied the reference evaluates each
    latch the program may have taken, keeps the one nearest the program's
    frame, and still agrees with the port."""
    from dv3bench.reference import synthesis as ref_synthesis
    monkeypatch.setattr(ref_synthesis, "TIE", 2.0)
    cell, config, traffic = BATCH_CELLS[0]
    nums = _batch(cell, config, traffic)["numbers"]
    assert nums["frame_gap"] < 1e-5 and nums["align_gap"] < 1e-5, nums
