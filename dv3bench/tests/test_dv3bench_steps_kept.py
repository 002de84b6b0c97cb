# coding: utf-8
"""The reader of `b1.steps_kept.batch` (metrics/b1.steps_kept.batch.py):
its arithmetic on a known recorder, no value where the program keeps no
`b1.steps_run` / `b1.steps_kept` counters or ran no step, and its reading
in a traced window: 100 % on the CPU and on the card, where each decode
runs only the steps it returns."""

import pytest

from dv3bench import bench

from test_dv3bench_spans import _check_traced_window, _ctx, _known_window, \
    _traced

NAME = "b1.steps_kept.batch"


@pytest.mark.parametrize("kept,run,share", [
    (2374, 2374, 100.0), (2374, 2656, 100.0 * 2374 / 2656), (0, 32, 0.0)])
def test_the_reader_on_a_known_recorder(monkeypatch, kept, run, share):
    w = _known_window()
    w.add("b1.steps_run", run)
    w.add("b1.steps_kept", kept)
    assert bench.load_metric(NAME)(_ctx(w, monkeypatch)) == \
        pytest.approx(share)


def test_no_value_without_the_counters(monkeypatch):
    """A program without the counters (one that predates them), a window
    in which no step ran, or one of another kind: no value, no error."""
    assert bench.load_metric(NAME)(_ctx(_known_window(), monkeypatch)) \
        is None
    w = _known_window()
    w.add("b1.steps_run", 64)
    assert bench.load_metric(NAME)(_ctx(w, monkeypatch)) is None
    w = _known_window()
    w.add("b1.steps_run", 0)
    w.add("b1.steps_kept", 0)
    assert bench.load_metric(NAME)(_ctx(w, monkeypatch)) is None
    w.add("b1.steps_run", 32)
    ctx = _ctx(w, monkeypatch)
    ctx["kind"] = "train"
    assert bench.load_metric(NAME)(ctx) is None


def test_the_traced_window_on_the_cpu_keeps_every_step():
    ctx = _traced("cpu")
    _check_traced_window(ctx)
    assert bench.load_metric(NAME)(ctx) == 100.0


@pytest.mark.cuda
def test_the_traced_window_on_the_card_keeps_every_step(card):
    ctx = _traced(card)
    _check_traced_window(ctx)
    assert bench.load_metric(NAME)(ctx) == 100.0
