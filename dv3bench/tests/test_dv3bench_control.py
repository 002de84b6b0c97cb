# coding: utf-8
"""The control comes out as not correct: the reference one precision below
the configuration's put in the program's place (e4m3 for the bf16
Griffin-Lim; TF32 for the f32 model, which only the card has), judged
against each cell's limits at a size a test run holds. control.py reads
the same at each cell's own size on the card."""

import pytest

from conftest import small_traffic, tiny_hp
from dv3bench import bench
from dv3bench.kinds import batch_synthesis, train_step

CELLS = [("dv3_ljspeech.batch32", "dv3_ljspeech", "ljspeech_batch32"),
         ("dv3_vctk.batch32", "dv3_vctk", "vctk_batch32")]


def _batch_control(cell, config, traffic, device):
    out = batch_synthesis.run(tiny_hp(config), small_traffic(traffic),
                              2 ** 31 + 404, 0.2, 0, device, lambda: None,
                              control=True)
    limits = bench.limits(cell)
    assert bench.judge(out["numbers"], limits)[0], out["numbers"]
    return out["control_numbers"], limits


@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_gl_control_is_not_correct(cell, config, traffic):
    ctl, limits = _batch_control(cell, config, traffic, "cpu")
    assert ctl["gl_sc_excess"] > limits["gl_sc_excess"], ctl
    assert not bench.judge(ctl, limits)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,config,traffic", CELLS)
def test_batch_control_is_not_correct_on_the_card(card, cell, config,
                                                  traffic):
    ctl, limits = _batch_control(cell, config, traffic, card)
    for k in ("frame_gap", "linear_gap", "gl_sc_excess"):
        assert ctl[k] > limits[k], (k, ctl)


@pytest.mark.cuda
def test_train_control_is_not_correct_on_the_card(card):
    out = train_step.run(tiny_hp("dv3_vctk"), small_traffic("vctk_train16"),
                         2 ** 31 + 405, 0.2, 0, card, lambda: None,
                         control=True)
    limits = bench.limits("dv3_vctk.train16")
    assert bench.judge(out["numbers"], limits)[0], out["numbers"]
    ctl = out["control_numbers"]
    assert ctl["loss_gap"] > limits["loss_gap"], ctl
    assert not bench.judge(ctl, limits)[0]
