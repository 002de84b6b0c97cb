# coding: utf-8
"""CPU fixtures of the benchmark's tests: tiny widths of the two
configurations and small traffic, so each cell's pieces run here."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from dv3bench import bench  # noqa: E402

TINY = dict(text_embed_dim=32, encoder_channels=32, decoder_channels=32,
            converter_channels=32, fft_size=256, hop_size=64)


def tiny_hp(config):
    hp = bench.load_json(ROOT / "dv3bench" / "configs" / (config + ".json"))
    hp.update(TINY)
    return hp


def small_traffic(name):
    tr = bench.load_json(ROOT / "dv3bench" / "traffic" / (name + ".json"))
    if tr["kind"] == "batch_synthesis":
        tr.update(pool=8, batch=4, trace_calls=2, sample_calls=2,
                  corpus=dict(tr["corpus"], max_s=2.0))
    else:
        tr.update(pool_batches=3, batch=3, trace_steps=3,
                  corpus=dict(tr["corpus"], max_s=1.5))
    return tr


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (TF32 exists only on the card)")
    bench.tf32_off(torch)
    return "cuda"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
