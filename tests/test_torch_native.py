# coding: utf-8
"""The port's copy of the host C++ library (deepvoice3_pytorch_tpu_torch/
native/) against the JAX package's (the same sources, built by the same
g++: bit for bit) and against the port's torch features (2e-4, the bar of
tests/test_native.py), and the port's native collate against its numpy
`collate` and JAX's `collate_native` (equal arrays)."""

import numpy as np
import pytest

from deepvoice3_pytorch_tpu import native as j_native
from deepvoice3_pytorch_tpu.frontend import en as j_en
from deepvoice3_pytorch_tpu.training import dataset as j_dataset
from deepvoice3_pytorch_tpu_torch import native as t_native
from deepvoice3_pytorch_tpu_torch.dsp.audio import AudioProcessor
from deepvoice3_pytorch_tpu_torch.frontend import en as t_en
from deepvoice3_pytorch_tpu_torch.hparams import default_hparams
from deepvoice3_pytorch_tpu_torch.training import dataset as t_dataset

import torch_port_common  # noqa: F401  (one torch thread a worker)

needs_jax_library = pytest.mark.skipif(
    not j_native.is_available(),
    reason="the JAX package's library did not build (no C++ toolchain)")


@pytest.fixture(scope="module")
def setup():
    hp = default_hparams()
    return hp, AudioProcessor(hp)


def _args(hp):
    return (hp.fft_size, hp.hop_size, hp.preemphasis, hp.min_level_db,
            hp.ref_level_db)


def _wavs():
    rs = np.random.RandomState(0)
    return [(rs.rand(n).astype(np.float32) - 0.5) * 0.3
            for n in (22050, 8000, 3000)]


def test_library_builds_into_the_build_dir():
    path = t_native.build()
    assert path.parent == t_native.BUILD_DIR and path.exists()
    assert t_native.BUILD_DIR.parent.name == "build"


def test_jax_library_loads():
    """The root conftest builds the JAX package's library before any worker
    collects; a worker that raced another to build it would skip the
    comparisons below, and this names the fault."""
    assert j_native.is_available()


@needs_jax_library
def test_features_equal_jax_native_and_torch(setup):
    hp, ap = setup
    mel_w = ap.mel_filters_np
    for wav in _wavs():
        lin_t, mel_t = t_native.features(wav, mel_w, *_args(hp))
        lin_j, mel_j = j_native.features(wav, mel_w, *_args(hp))
        assert np.array_equal(lin_t, lin_j) and np.array_equal(mel_t, mel_j)
        lin_d, mel_d = ap.both_spectrograms(wav, device="cpu")
        assert lin_t.shape == lin_d.shape and mel_t.shape == mel_d.shape
        assert np.abs(lin_t - lin_d).max() < 2e-4
        assert np.abs(mel_t - mel_d).max() < 2e-4


@needs_jax_library
def test_features_batch_equals_single_and_jax(setup):
    hp, ap = setup
    wavs = _wavs()
    got = t_native.features_batch(wavs, ap.mel_filters_np, *_args(hp))
    want = j_native.features_batch(wavs, ap.mel_filters_np, *_args(hp))
    for w, (lt, mt), (lj, mj) in zip(wavs, got, want):
        assert np.array_equal(lt, lj) and np.array_equal(mt, mj)
        ls, ms = t_native.features(w, ap.mel_filters_np, *_args(hp))
        assert np.array_equal(lt, ls) and np.array_equal(mt, ms)
    for (lt, mt), (ld, md) in zip(got, ap.batch_features(wavs,
                                                         device="cpu")):
        assert np.abs(lt - ld).max() < 2e-4 and np.abs(mt - md).max() < 2e-4


@needs_jax_library
def test_inv_spectrogram_equals_jax_native(setup):
    hp, ap = setup
    t = np.arange(8000) / 22050.0
    wav = (0.5 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    lin = ap.spectrogram(wav, device="cpu").T
    kw = dict(power=hp.power, min_level_db=hp.min_level_db,
              ref_level_db=hp.ref_level_db, n_iters=4,
              momentum=hp.griffin_lim_momentum, preemphasis=hp.preemphasis,
              phase_init="spsi")
    got = t_native.inv_spectrogram(lin, hp.fft_size, hp.hop_size, **kw)
    want = j_native.inv_spectrogram(lin, hp.fft_size, hp.hop_size, **kw)
    assert got.shape == (lin.shape[0] * hp.hop_size,)
    assert np.isfinite(got).all() and np.array_equal(got, want)


def test_npy_shape_and_unsupported(tmp_path):
    np.save(tmp_path / "a.npy", np.zeros((7, 3), np.float32))
    np.save(tmp_path / "b.npy", np.zeros((5,), np.float32))
    np.save(tmp_path / "c.npy", np.zeros((2, 2), np.float64))
    assert t_native.npy_shape(tmp_path / "a.npy") == (7, 3)
    assert t_native.npy_shape(tmp_path / "b.npy") == (5, 1)
    assert t_native.npy_shape(tmp_path / "c.npy") is None
    assert t_native.npy_shape(tmp_path / "missing.npy") is None


def test_load_padded_batch_offset(tmp_path):
    rs = np.random.RandomState(0)
    arrs = [rs.rand(n, 4).astype(np.float32) for n in (3, 6, 1)]
    paths = []
    for i, a in enumerate(arrs):
        np.save(tmp_path / ("%d.npy" % i), a)
        paths.append(tmp_path / ("%d.npy" % i))
    np.save(tmp_path / "bad.npy", np.zeros((2, 4), np.float64))
    batch, rows = t_native.load_padded_batch(paths + [tmp_path / "bad.npy"],
                                             10, 4, row_offset=2)
    assert list(rows) == [3, 6, 1, -1]
    for i, a in enumerate(arrs):
        assert (batch[i, 2:2 + len(a)] == a).all()
        assert not batch[i, :2].any() and not batch[i, 2 + len(a):].any()


def _fake_corpus(root, n=10, speakers=False):
    rs = np.random.RandomState(0)
    lines = []
    for i in range(n):
        T = int(rs.randint(40, 120))
        np.save(root / ("x-mel-%05d.npy" % i),
                rs.rand(T, 80).astype(np.float32))
        np.save(root / ("x-spec-%05d.npy" % i),
                rs.rand(T, 129).astype(np.float32))
        cols = ["x-spec-%05d.npy" % i, "x-mel-%05d.npy" % i, str(T),
                "hello world %d." % i]
        lines.append("|".join(cols + ([str(i % 3)] if speakers else [])))
    (root / "train.txt").write_text("\n".join(lines), encoding="utf-8")
    return root


@needs_jax_library
@pytest.mark.parametrize("r,ds_step,speakers", [(4, 1, False), (1, 4, False),
                                                (1, 4, True)])
def test_collate_native_matches_numpy_and_jax(tmp_path, r, ds_step,
                                              speakers):
    root = _fake_corpus(tmp_path, speakers=speakers)
    ds_t = t_dataset.TTSDataset(str(root), t_en,
                                replace_pronunciation_prob=0.0)
    ds_j = j_dataset.TTSDataset(str(root), j_en,
                                replace_pronunciation_prob=0.0)
    idxs = [0, 3, 7, 9]
    kw = dict(length_bucket_step=16, frame_bucket_step=8)
    ref = t_dataset.collate([ds_t[i] for i in idxs], r, ds_step, **kw)
    got = t_dataset.collate_native(ds_t, idxs, r, ds_step, **kw)
    want = j_dataset.collate_native(ds_j, idxs, r, ds_step, **kw)
    assert got is not None and want is not None
    assert set(got) == set(ref) == set(want)
    assert ("speaker_ids" in got) == speakers
    for k in ref:
        assert got[k].dtype == ref[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], ref[k]), k
        assert np.array_equal(got[k], want[k]), k


def test_data_loader_routes(tmp_path):
    """The loader's batches come from the C++ reader; a corpus of float64
    files goes through numpy's collate with the same arrays; each route is
    counted."""
    root = _fake_corpus(tmp_path)
    ds = t_dataset.TTSDataset(str(root), t_en, 0.0)

    def run(use_native):
        sampler = t_dataset.SimilarTimeLengthSampler(
            ds.meta.frame_lengths, batch_size=4, permutate=False)
        loader = t_dataset.DataLoader(ds, sampler, 1, 4, length_bucket_step=8,
                                      use_native=use_native)
        return list(loader), loader.batches

    got, counts = run(True)
    want, counts_np = run(False)
    assert counts == {"native": 2, "numpy": 0}
    assert counts_np == {"native": 0, "numpy": 2}
    for g, w in zip(got, want):
        for k in w:
            assert np.array_equal(g[k], w[k]), k
    for i in range(10):
        p = root / ("x-mel-%05d.npy" % i)
        np.save(p, np.load(p).astype(np.float64))
    got64, counts64 = run(True)
    assert counts64 == {"native": 0, "numpy": 2}
    for g, w in zip(got64, want):
        for k in w:
            assert np.allclose(g[k], w[k]), k
