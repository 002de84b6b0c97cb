# coding: utf-8
"""Host C++ library of the port, loaded with ctypes: a copy of the JAX
package's deepvoice3_pytorch_tpu/native/ (the same sources under `src/`).

  * dv3_dsp — host STFT / mel features and Griffin-Lim inversion in the lws
    framing: the preprocessing backend for hosts without a card
    (`datasets.common.process_utterances(backend="native")`).
  * dv3_loader — threaded .npy batch loader with the padded collate
    (`training.dataset.collate_native`).

The library is built on first use with g++ into `build/native/
libdv3native-<hash>.so` next to the package, by `_build.compile_cached`.
A failed build raises RuntimeError with the compiler's output; nothing
falls back.
"""

import ctypes
import threading
from pathlib import Path

import numpy as np

from .. import _build

SRC = Path(__file__).resolve().with_name("src")
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
SOURCES = ("dv3_dsp.cc", "dv3_loader.cc")

_lock = threading.Lock()
_lib = None


def build():
    """Compile the library if needed. Returns its path."""
    argv = ["g++", *CXX_FLAGS, *(SRC / s for s in SOURCES)]
    return _build.compile_cached(BUILD_DIR, "libdv3native", argv,
                                 sorted(SRC.iterdir()))[0]


def load():
    """The loaded library (built on first use)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        fp = ctypes.POINTER(ctypes.c_float)
        lp = ctypes.POINTER(ctypes.c_long)
        lib.dv3_num_frames.restype = ctypes.c_int
        lib.dv3_num_frames.argtypes = [ctypes.c_long, ctypes.c_int,
                                       ctypes.c_int]
        lib.dv3_features.restype = None
        lib.dv3_features.argtypes = [
            fp, ctypes.c_long, ctypes.c_int, ctypes.c_int, fp, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, fp, fp]
        lib.dv3_features_batch.restype = None
        lib.dv3_features_batch.argtypes = [
            fp, lp, ctypes.c_int, ctypes.c_int, ctypes.c_int, fp,
            ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            fp, fp, ctypes.c_int]
        lib.dv3_inv_spectrogram.restype = None
        lib.dv3_inv_spectrogram.argtypes = [
            fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, fp]
        lib.dv3_npy_shape.restype = ctypes.c_int
        lib.dv3_npy_shape.argtypes = [ctypes.c_char_p, lp]
        lib.dv3_load_padded_batch.restype = ctypes.c_int
        lib.dv3_load_padded_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_long,
            ctypes.c_long, ctypes.c_long, fp, lp, ctypes.c_int]
        _lib = lib
        return _lib


def _as_f32(x):
    return np.ascontiguousarray(x, dtype=np.float32)


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _lptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def features(y, mel_basis, fft_size, hop_size, preemphasis=0.97,
             min_level_db=-100.0, ref_level_db=20.0):
    """wav (T,) -> (linear (n, F), mel (n, M)), both normalized to [0, 1]
    (lws framing)."""
    lib = load()
    y = _as_f32(y)
    mel_w = _as_f32(mel_basis)
    n_mels = mel_w.shape[0]
    n = lib.dv3_num_frames(len(y), fft_size, hop_size)
    F = fft_size // 2 + 1
    linear = np.empty((n, F), np.float32)
    mel = np.empty((n, n_mels), np.float32)
    lib.dv3_features(_fptr(y), len(y), fft_size, hop_size, _fptr(mel_w),
                     n_mels, preemphasis, min_level_db, ref_level_db,
                     _fptr(linear), _fptr(mel))
    return linear, mel


def features_batch(wavs, mel_basis, fft_size, hop_size, preemphasis=0.97,
                   min_level_db=-100.0, ref_level_db=20.0, n_threads=0):
    """List of ragged wavs -> list of (linear, mel), on a C++ thread pool
    (n_threads 0: one per hardware thread)."""
    lib = load()
    mel_w = _as_f32(mel_basis)
    n_mels = mel_w.shape[0]
    F = fft_size // 2 + 1
    wavs = [_as_f32(w) for w in wavs]
    lengths = np.asarray([len(w) for w in wavs], np.int64)
    packed = np.concatenate(wavs) if wavs else np.zeros((0,), np.float32)
    frames = [lib.dv3_num_frames(int(n), fft_size, hop_size) for n in lengths]
    total = int(np.sum(frames))
    linear = np.empty((total, F), np.float32)
    mel = np.empty((total, n_mels), np.float32)
    lib.dv3_features_batch(
        _fptr(packed), _lptr(lengths), len(wavs), fft_size, hop_size,
        _fptr(mel_w), n_mels, preemphasis, min_level_db, ref_level_db,
        _fptr(linear), _fptr(mel), n_threads)
    out, off = [], 0
    for nf in frames:
        out.append((linear[off:off + nf].copy(), mel[off:off + nf].copy()))
        off += nf
    return out


def inv_spectrogram(spec_nf, fft_size, hop_size, power=1.4,
                    min_level_db=-100.0, ref_level_db=20.0, n_iters=60,
                    momentum=0.99, preemphasis=0.97, phase_init="zero"):
    """Normalized linear (n, F) -> waveform (n * hop,), Griffin-Lim in the
    lws framing. phase_init: "zero" or "spsi"."""
    lib = load()
    spec = _as_f32(spec_nf)
    n_frames = spec.shape[0]
    wav = np.empty((n_frames * hop_size,), np.float32)
    lib.dv3_inv_spectrogram(_fptr(spec), n_frames, fft_size, hop_size, power,
                            min_level_db, ref_level_db, n_iters, momentum,
                            preemphasis, 1 if phase_init == "spsi" else 0,
                            _fptr(wav))
    return wav


def npy_shape(path):
    """(rows, cols) of a float32 C-order npy file, or None if the C++
    reader does not take it."""
    lib = load()
    shape = np.zeros((2,), np.int64)
    rc = lib.dv3_npy_shape(str(path).encode(), _lptr(shape))
    return (int(shape[0]), int(shape[1])) if rc == 0 else None


def load_padded_batch(paths, max_rows, cols, row_offset=0, n_threads=0):
    """Read float32 npy files into a zero-padded (B, max_rows, cols) batch,
    each item's rows starting at row_offset (collate's b_pad). Returns
    (batch, rows): rows[i] is the item's row count, -1 for a file the C++
    reader could not take."""
    lib = load()
    n = len(paths)
    batch = np.empty((n, max_rows, cols), np.float32)
    rows = np.empty((n,), np.int64)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    lib.dv3_load_padded_batch(arr, n, max_rows, cols, row_offset,
                              _fptr(batch), _lptr(rows), n_threads)
    return batch, rows
