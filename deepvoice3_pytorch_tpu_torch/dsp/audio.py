# coding: utf-8
"""Audio API, counterpart of deepvoice3_pytorch_tpu/dsp/audio.py.

Two framings (`hparams.stft_mode`): "lws" (causal frames over a zero tail
pad, the lws-normalised sqrt of a symmetric Hann; ceil(T / hop) frames) and
"center" (reflect-padded by fft // 2 on both sides, the periodic sqrt-Hann;
1 + T // hop frames). Any hop.

Features: waveform -> pre-emphasis -> analysis pad -> |STFT| -> dB -> [0, 1]
normalised linear and mel spectrograms, batched over ragged waveforms
(`batch_features`) on the card unless the caller asks for the CPU.

Inversion: normalized linear spectrogram -> denormalize -> dB to amplitude
-> ** power -> phase retrieval -> inverse pre-emphasis -> waveform. The
phase retrieval is chosen from the configuration (`inversion_route`) and
counted per call in `routes`:
  * "b2": Griffin-Lim on kernel B2 (dsp/gl_cuda.py: the CUDA kernel on the
    card, its plain version on the CPU) whenever B2 takes the framing
    (`gl_cuda.b2_takes`: hop | fft, at any fft / hop), with the centred
    trim in centre mode;
  * "general": the JAX package's XLA Griffin-Lim loop in plain PyTorch
    (dsp/stft.py `griffin_lim`, bf16 carry) when hop does not divide fft,
    where the JAX package takes that loop too;
  * "lws": local-weighted-sums retrieval (dsp/lws_phase.py) for
    phase_retrieval="lws", which needs hop | fft (ValueError at
    construction otherwise, as in the JAX package).
"""

import functools

import numpy as np
import torch
from scipy import signal as sp_signal
from scipy.io import wavfile

from . import gl_cuda
from . import lws_phase
from . import stft as dsp


def _tensor_or_numpy(fn):
    """A helper that computes on tensors: a tensor in gives a tensor out; an
    array in gives a float32 numpy array out (the JAX package's helpers
    take and return numpy)."""
    @functools.wraps(fn)
    def wrapper(self, x):
        if isinstance(x, torch.Tensor):
            return fn(self, x)
        return fn(self, torch.as_tensor(np.asarray(x, np.float32))).numpy()
    return wrapper


class AudioProcessor:
    """Constants and routes for one audio config (an hparams-like object)."""

    def __init__(self, hp):
        self.sample_rate = hp.sample_rate
        self.fft_size = hp.fft_size
        self.hop_size = hp.hop_size
        self.num_mels = hp.num_mels
        self.fmin = hp.fmin
        self.fmax = hp.fmax
        self.allow_clipping = getattr(hp, "allow_clipping_in_normalization",
                                      True)
        self.preemphasis_coef = hp.preemphasis
        self.min_level_db = hp.min_level_db
        self.ref_level_db = hp.ref_level_db
        self.power = getattr(hp, "power", 1.4)
        self.gl_iters = getattr(hp, "griffin_lim_iters", 60)
        self.gl_phase_init = getattr(hp, "griffin_lim_phase_init", "zero")
        self.gl_momentum = float(getattr(hp, "griffin_lim_momentum", 0.99))
        self.stft_mode = getattr(hp, "stft_mode", "lws")
        if self.stft_mode not in ("lws", "center"):
            raise ValueError("stft_mode must be 'lws' or 'center', got %r"
                             % (self.stft_mode,))
        # "lws" selects local weighted sums; anything else Griffin-Lim, as
        # in the JAX package
        self.phase_retrieval = getattr(hp, "phase_retrieval", "gl")
        if self.phase_retrieval == "lws" and self.fft_size % self.hop_size:
            raise ValueError(
                "phase_retrieval='lws' requires hop_size to divide "
                "fft_size (got fft_size=%d hop_size=%d); use the default "
                "'gl'" % (self.fft_size, self.hop_size))
        if self.stft_mode == "lws":
            self.window_np = dsp.lws_hann_window(self.fft_size, self.hop_size)
        else:
            self.window_np = dsp.sqrt_hann_window(self.fft_size)
        self.mel_filters_np = dsp.mel_basis(
            self.sample_rate, self.fft_size, self.num_mels, self.fmin,
            self.fmax)
        self.routes = {}           # inversion route -> calls
        self._mats = {}

    @property
    def centered(self):
        return self.stft_mode == "center"

    @property
    def inversion_route(self):
        """"lws", else `window_route`."""
        if self.phase_retrieval == "lws":
            return "lws"
        return self.window_route

    @property
    def window_route(self):
        """Griffin-Lim's route for this framing, a rule of the shape: "b2"
        where kernel B2 takes it (`gl_cuda.b2_takes`: hop | fft), else
        "general" (dsp/stft.py `griffin_lim`), as the JAX package's guard
        (`gl_pallas.fits_vmem`) decides. Streams and serving windows take
        it whatever phase_retrieval says, as in the JAX package."""
        return "b2" if gl_cuda.b2_takes(self.fft_size, self.hop_size) \
            else "general"

    def count_route(self, route):
        self.routes[route] = self.routes.get(route, 0) + 1

    def mats(self, device, carry="bf16"):
        """Window-folded DFT matrices on `device`, built once: bf16 (B2's
        and the batch loop's, `gl_cuda.gl_mats`) or f32 (the stream loop's,
        `stft.griffin_lim_mats(..., carry="f32")`)."""
        key = (str(torch.device(device)), carry)
        if key not in self._mats:
            self._mats[key] = dsp.griffin_lim_mats(
                self.fft_size, self.window_np, device, carry)
        return self._mats[key]

    # -- file I/O (host) ----------------------------------------------------

    def load_wav(self, path):
        """A wav file as float32 mono at the configured rate: integer PCM
        scaled to [-1, 1), channels averaged, resampled (polyphase) when
        the file's rate differs."""
        sr, wav = wavfile.read(path)
        if wav.dtype == np.int16:
            wav = wav.astype(np.float32) / 32768.0
        elif wav.dtype == np.int32:
            wav = wav.astype(np.float32) / 2147483648.0
        elif wav.dtype == np.uint8:
            wav = (wav.astype(np.float32) - 128.0) / 128.0
        else:
            wav = wav.astype(np.float32)
        if wav.ndim > 1:
            wav = wav.mean(axis=1)
        if sr != self.sample_rate:
            g = np.gcd(int(self.sample_rate), int(sr))
            wav = sp_signal.resample_poly(wav, self.sample_rate // g, sr // g)
        return wav.astype(np.float32)

    def save_wav(self, wav, path):
        wav = np.asarray(wav)
        wav = wav * 32767 / max(0.01, np.max(np.abs(wav)))
        wavfile.write(path, self.sample_rate, wav.astype(np.int16))

    # -- feature extraction ---------------------------------------------------

    def _features_padded(self, y):
        """(..., T') pre-emphasised signals with their analysis padding ->
        (linear (..., n, F), mel (..., n, M)), both normalised to [0, 1]."""
        mld, rld = float(self.min_level_db), float(self.ref_level_db)
        window = torch.from_numpy(self.window_np).to(y.device)
        mel_w = torch.from_numpy(self.mel_filters_np).to(y.device)
        D = torch.abs(dsp.stft(y, self.fft_size, self.hop_size, window))
        linear = dsp.normalize(dsp.amp_to_db(D, mld) - rld, mld)
        mel = dsp.normalize(dsp.amp_to_db(D @ mel_w.t(), mld) - rld, mld)
        return linear, mel

    def _features(self, y, device):
        y = torch.as_tensor(np.asarray(y, np.float32)).to(device)
        e = dsp.preemphasis(y, self.preemphasis_coef)
        if self.centered:
            e = dsp.reflect_pad(e, self.fft_size // 2)
        else:
            e = dsp.lws_pad(e, self.fft_size, self.hop_size)
        linear, mel = self._features_padded(e)
        return linear.cpu().numpy(), mel.cpu().numpy()

    def spectrogram(self, y, device="cuda"):
        return self._features(y, device)[0].T            # (F, n)

    def melspectrogram(self, y, device="cuda"):
        mel = self._features(y, device)[1]
        if not self.allow_clipping:
            assert mel.max() <= 1.0 and mel.min() >= 0.0
        return mel.T                                     # (M, n)

    def both_spectrograms(self, y, device="cuda"):
        return self._features(y, device)                 # (n, F), (n, M)

    def num_frames(self, length):
        """Frame count of the active framing: lws ceil(length / hop),
        center 1 + length // hop."""
        if self.centered:
            return dsp.num_frames(length, self.fft_size, self.hop_size)
        return dsp.lws_num_frames(length, self.hop_size)

    def batch_features(self, wavs, bucket_samples=16384, device="cuda"):
        """Features of a list of ragged waveforms in one batched pass: the
        host applies pre-emphasis and each utterance's analysis padding
        (lws: the zero tail pad; center: a reflect pad of fft // 2 on both
        sides) and zero-pads to a common length (rounded up to
        `bucket_samples`); the device computes every frame. Returns
        [(linear (n_i, F), mel (n_i, M))], exact per utterance (utterance
        i's frames read only its padded samples, and the frames past n_i
        are dropped)."""
        pad = self.fft_size // 2
        prepped, n_frames = [], []
        for w in wavs:
            e = np.asarray(w, np.float32)
            e = np.concatenate([e[:1], e[1:] - self.preemphasis_coef * e[:-1]])
            if self.centered:
                e = np.pad(e, (pad, pad), mode="reflect")
            else:
                e = dsp.lws_pad(e, self.fft_size, self.hop_size)
            prepped.append(e)
            n_frames.append(self.num_frames(len(w)))
        max_len = max(len(p) for p in prepped)
        max_len = -(-max_len // bucket_samples) * bucket_samples
        batch = np.zeros((len(prepped), max_len), np.float32)
        for i, p in enumerate(prepped):
            batch[i, :len(p)] = p
        linear, mel = self._features_padded(torch.from_numpy(batch).to(device))
        linear, mel = linear.cpu().numpy(), mel.cpu().numpy()
        return [(linear[i, :n], mel[i, :n]) for i, n in enumerate(n_frames)]

    # -- inversion ------------------------------------------------------------

    def _denorm_pow(self, spec):
        S = dsp.db_to_amp(dsp.denormalize(spec, self.min_level_db)
                          + self.ref_level_db)
        return S ** self.power

    def phase_retrieval_device(self, S):
        """(B, n, F) f32 magnitudes (already raised to `power`) -> (B, n *
        hop) waveform before inverse pre-emphasis, on the magnitudes'
        device, by `inversion_route` (counted in `routes`)."""
        route = self.inversion_route
        self.count_route(route)
        fft, hop = self.fft_size, self.hop_size
        if route == "lws":
            return lws_phase.lws_run(S, fft, hop, self.window_np,
                                     n_iters=self.gl_iters,
                                     center=self.centered)
        kw = dict(n_iters=self.gl_iters, momentum=self.gl_momentum,
                  phase_init=self.gl_phase_init, mats=self.mats(S.device),
                  center=self.centered)
        if route == "b2":
            return gl_cuda.griffin_lim(S, fft, hop, self.window_np, **kw)
        return dsp.griffin_lim(S, fft, hop, self.window_np, **kw)

    def inv_spectrogram_device(self, spec_bnf):
        """(B, n, F) normalized linear tensor -> (B, n * hop) waveform
        tensor on the same device."""
        wav = self.phase_retrieval_device(self._denorm_pow(spec_bnf.float()))
        return self.inv_preemphasis(wav)

    def inv_spectrogram_batch(self, spec_bnf):
        """(B, n, F) normalized linear (tensor or array) -> numpy (B, T)."""
        return self.inv_spectrogram_device(
            torch.as_tensor(spec_bnf)).cpu().numpy()

    def inv_spectrogram(self, spectrogram):
        """(F, n) normalized linear, like the reference -> numpy (T,)."""
        spec = torch.as_tensor(np.asarray(spectrogram, np.float32)).T
        return self.inv_spectrogram_batch(spec[None])[0]

    # -- scalar helpers (tensor in, tensor out; array in, array out) ---------

    @_tensor_or_numpy
    def _normalize(self, S):
        """dB -> [0, 1]."""
        return dsp.normalize(S, self.min_level_db)

    @_tensor_or_numpy
    def _denormalize(self, S):
        """[0, 1] -> dB."""
        return dsp.denormalize(S, self.min_level_db)

    @_tensor_or_numpy
    def preemphasis(self, x):
        return dsp.preemphasis(x, self.preemphasis_coef)

    @_tensor_or_numpy
    def inv_preemphasis(self, x):
        return dsp.inv_preemphasis(x, self.preemphasis_coef)
