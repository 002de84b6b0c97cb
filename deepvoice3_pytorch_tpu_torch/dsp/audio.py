# coding: utf-8
"""Audio API, counterpart of deepvoice3_pytorch_tpu/dsp/audio.py, in the
lws framing only.

Features: waveform -> pre-emphasis -> tail pad -> |STFT| -> dB -> [0, 1]
normalised linear and mel spectrograms, batched over ragged waveforms
(`batch_features`) on the card unless the caller asks for the CPU.

Inversion: normalized linear spectrogram -> denormalize -> dB to amplitude
-> ** power -> Griffin-Lim (dsp/gl_cuda.py: the CUDA kernel on the card,
its plain version on the CPU) -> inverse pre-emphasis -> waveform.
"""

import numpy as np
import torch
from scipy.io import wavfile

from . import gl_cuda
from . import stft as dsp


class AudioProcessor:
    """Inversion constants for one audio config (an hparams-like object)."""

    def __init__(self, hp):
        self.sample_rate = hp.sample_rate
        self.fft_size = hp.fft_size
        self.hop_size = hp.hop_size
        self.num_mels = hp.num_mels
        self.allow_clipping = getattr(hp, "allow_clipping_in_normalization",
                                      True)
        self.preemphasis_coef = hp.preemphasis
        self.min_level_db = hp.min_level_db
        self.ref_level_db = hp.ref_level_db
        self.power = getattr(hp, "power", 1.4)
        self.gl_iters = getattr(hp, "griffin_lim_iters", 60)
        self.gl_phase_init = getattr(hp, "griffin_lim_phase_init", "zero")
        self.gl_momentum = float(getattr(hp, "griffin_lim_momentum", 0.99))
        if getattr(hp, "stft_mode", "lws") != "lws":
            raise NotImplementedError("only stft_mode='lws' is ported")
        if getattr(hp, "phase_retrieval", "gl") != "gl":
            raise NotImplementedError("only phase_retrieval='gl' is ported")
        if self.fft_size % self.hop_size:
            raise ValueError(
                "Griffin-Lim needs hop_size to divide fft_size (got "
                "fft_size=%d hop_size=%d)" % (self.fft_size, self.hop_size))
        self.window_np = dsp.lws_hann_window(self.fft_size, self.hop_size)
        self.mel_filters_np = dsp.mel_basis(
            self.sample_rate, self.fft_size, self.num_mels, hp.fmin, hp.fmax)
        self._mats = {}

    def mats(self, device):
        """Window-folded bf16 DFT matrices on `device`, built once."""
        key = str(torch.device(device))
        if key not in self._mats:
            self._mats[key] = gl_cuda.gl_mats(self.fft_size, self.window_np,
                                              device)
        return self._mats[key]

    # -- file I/O (host) ----------------------------------------------------

    def save_wav(self, wav, path):
        wav = np.asarray(wav)
        wav = wav * 32767 / max(0.01, np.max(np.abs(wav)))
        wavfile.write(path, self.sample_rate, wav.astype(np.int16))

    # -- feature extraction ---------------------------------------------------

    def _features_padded(self, y):
        """(..., T') pre-emphasised, padded signals -> (linear (..., n, F),
        mel (..., n, M)), both normalised to [0, 1]."""
        mld, rld = float(self.min_level_db), float(self.ref_level_db)
        window = torch.from_numpy(self.window_np).to(y.device)
        mel_w = torch.from_numpy(self.mel_filters_np).to(y.device)
        D = torch.abs(dsp.stft(y, self.fft_size, self.hop_size, window))
        linear = dsp.normalize(dsp.amp_to_db(D, mld) - rld, mld)
        mel = dsp.normalize(dsp.amp_to_db(D @ mel_w.t(), mld) - rld, mld)
        return linear, mel

    def _features(self, y, device):
        y = torch.as_tensor(np.asarray(y, np.float32)).to(device)
        e = dsp.lws_pad(dsp.preemphasis(y, self.preemphasis_coef),
                        self.fft_size, self.hop_size)
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
        """Frame count of the lws framing: ceil(length / hop)."""
        return dsp.lws_num_frames(length, self.hop_size)

    def batch_features(self, wavs, bucket_samples=16384, device="cuda"):
        """Features of a list of ragged waveforms in one batched pass: the
        host applies pre-emphasis and the lws tail pad per utterance and
        zero-pads to a common length (rounded up to `bucket_samples`); the
        device computes every frame. Returns [(linear (n_i, F), mel (n_i,
        M))], exact per utterance (a causal frame of utterance i reads only
        its samples and trailing zeros)."""
        prepped, n_frames = [], []
        for w in wavs:
            e = np.asarray(w, np.float32)
            e = np.concatenate([e[:1], e[1:] - self.preemphasis_coef * e[:-1]])
            prepped.append(dsp.lws_pad(e, self.fft_size, self.hop_size))
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

    def _denormalize(self, S):
        """Normalized [0, 1] -> dB (tensor in, tensor out)."""
        return dsp.denormalize(S, self.min_level_db)

    def _denorm_pow(self, spec):
        S = dsp.db_to_amp(dsp.denormalize(spec, self.min_level_db)
                          + self.ref_level_db)
        return S ** self.power

    def inv_preemphasis(self, x):
        return dsp.inv_preemphasis(x, self.preemphasis_coef)

    def inv_spectrogram_device(self, spec_bnf):
        """(B, n, F) normalized linear tensor -> (B, n * hop) waveform
        tensor on the same device."""
        S = self._denorm_pow(spec_bnf.float())
        wav = gl_cuda.griffin_lim(
            S, self.fft_size, self.hop_size, self.window_np,
            n_iters=self.gl_iters, momentum=self.gl_momentum,
            phase_init=self.gl_phase_init, mats=self.mats(S.device))
        return self.inv_preemphasis(wav)

    def inv_spectrogram_batch(self, spec_bnf):
        """(B, n, F) normalized linear (tensor or array) -> numpy (B, T)."""
        return self.inv_spectrogram_device(
            torch.as_tensor(spec_bnf)).cpu().numpy()

    def inv_spectrogram(self, spectrogram):
        """(F, n) normalized linear, like the reference -> numpy (T,)."""
        spec = torch.as_tensor(np.asarray(spectrogram, np.float32)).T
        return self.inv_spectrogram_batch(spec[None])[0]
