# coding: utf-8
"""The reader of `synth.copy_pinned.batch` (metrics/synth.copy_pinned.batch.py):
its arithmetic on a known recorder, no value where the program keeps no
`tts.bytes_pinned` counter or copied nothing, and its reading in a traced
window: 0 % on the CPU (plain copies), 100 % on the card."""

import pytest

from dv3bench import bench

from test_dv3bench_spans import _check_traced_window, _ctx, _known_window, \
    _traced

NAME = "synth.copy_pinned.batch"


@pytest.mark.parametrize("pinned,share", [(1000, 100.0), (250, 25.0),
                                          (0, 0.0)])
def test_the_reader_on_a_known_recorder(monkeypatch, pinned, share):
    w = _known_window()                     # 1000 bytes to the host
    w.add("tts.bytes_pinned", pinned)
    assert bench.load_metric(NAME)(_ctx(w, monkeypatch)) == \
        pytest.approx(share)


def test_no_value_without_the_counters(monkeypatch):
    """A program without `tts.bytes_pinned` (one that predates it), a
    window that copied nothing, or none at all: no value, no error."""
    assert bench.load_metric(NAME)(_ctx(_known_window(), monkeypatch)) \
        is None
    w = _known_window()
    w._counts = {"tts.bytes_pinned": 0, "tts.bytes_kept": 0}
    assert bench.load_metric(NAME)(_ctx(w, monkeypatch)) is None
    w._counts["tts.bytes_to_host"] = 0
    assert bench.load_metric(NAME)(_ctx(w, monkeypatch)) is None
    ctx = _ctx(_known_window(), monkeypatch)
    ctx["kind"] = "train"
    assert bench.load_metric(NAME)(ctx) is None


def test_the_traced_window_on_the_cpu_reads_no_pinned_bytes():
    ctx = _traced("cpu")
    _check_traced_window(ctx)
    assert bench.load_metric(NAME)(ctx) == 0.0


@pytest.mark.cuda
def test_the_traced_window_on_the_card_reads_every_byte_pinned(card):
    ctx = _traced(card)
    _check_traced_window(ctx)
    assert bench.load_metric(NAME)(ctx) == pytest.approx(100.0)
