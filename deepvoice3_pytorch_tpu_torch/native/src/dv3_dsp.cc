// Host DSP library: STFT feature extraction + Griffin-Lim inversion.
//
// A copy of the JAX package's deepvoice3_pytorch_tpu/native/src/dv3_dsp.cc
// for the PyTorch port (the same code, so both libraries give the same
// bits). Native (C++) equivalent of the reference's lws dependency
// (reference audio.py:9,31-55): forward features for dataset preprocessing
// workers and phase-retrieval synthesis on hosts without an accelerator.
// Semantics mirror dsp/stft.py's lws mode: PR-normalized sqrt of a
// symmetric Hann window, causal framing with tail zero-pad (frame count =
// ceil(T/hop)), Slaney mel basis (passed in from Python), momentum
// Griffin-Lim over the raw overlap-add analysis timeline, squared-window
// COLA-normalized iSTFT. Parity with the port's torch features is held by
// tests/test_torch_native.py.
//
// Exposed as a plain C ABI consumed via ctypes
// (deepvoice3_pytorch_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <complex>
#include <cstring>
#include <thread>
#include <vector>

#include "dv3_fft.h"

namespace {

using cf = std::complex<float>;

// LWS-convention analysis window (dsp/stft.py:lws_hann_window): sqrt of a
// symmetric Hann, scaled so the steady-state overlap-add of its square is 1.
void lws_window(std::vector<float>* w, int n, int hop) {
  std::vector<double> a(n);
  for (int i = 0; i < n; ++i) {
    const double h = 0.5 - 0.5 * std::cos(2.0 * M_PI * i / (n - 1));
    a[i] = std::sqrt(h);
  }
  const int t0 = n / 2;
  const int k = n / hop;
  double c = 0.0;
  for (int j = -k + 1; j < k; ++j) {
    const long idx = t0 - static_cast<long>(j) * hop;
    if (idx >= 0 && idx < n) c += a[idx] * a[idx];
  }
  const double s = 1.0 / std::sqrt(c);
  w->resize(n);
  for (int i = 0; i < n; ++i) (*w)[i] = static_cast<float>(a[i] * s);
}

// Causal framing with tail zero-pad: frame f, tap k reads y[f*hop + k],
// zero beyond the signal (dsp/stft.py lws mode).
inline float sample_causal(const float* y, long n, long idx) {
  return (idx < n) ? y[idx] : 0.f;
}

float amp_to_db(float x, float min_level) {
  return 20.0f * std::log10(std::max(min_level, x));
}

float normalize_db(float db, float min_level_db) {
  float v = (db - min_level_db) / -min_level_db;
  return std::min(1.0f, std::max(0.0f, v));
}

struct Stft {
  int fft, hop, n_freqs;
  std::vector<float> window;
  explicit Stft(int fft_size, int hop_size)
      : fft(fft_size), hop(hop_size), n_freqs(fft_size / 2 + 1) {
    lws_window(&window, fft_size, hop_size);
  }

  // magnitude STFT, causal framing with tail zero-pad (lws convention).
  void forward_mag(const float* y, long n, int n_frames, float* mag) const {
    std::vector<float> frame(fft);
    std::vector<cf> bins(n_freqs);
    std::vector<cf> scratch;
    for (int f = 0; f < n_frames; ++f) {
      const long base = static_cast<long>(f) * hop;
      for (int k = 0; k < fft; ++k)
        frame[k] = sample_causal(y, n, base + k) * window[k];
      dv3::rfft(frame.data(), fft, bins.data(), scratch);
      for (int k = 0; k < n_freqs; ++k) mag[f * n_freqs + k] = std::abs(bins[k]);
    }
  }

  // complex STFT of an already-materialized padded signal buffer.
  void forward_cpx(const float* padded, int n_frames, cf* out) const {
    std::vector<float> frame(fft);
    std::vector<cf> scratch;
    for (int f = 0; f < n_frames; ++f) {
      const float* base = padded + static_cast<long>(f) * hop;
      for (int k = 0; k < fft; ++k) frame[k] = base[k] * window[k];
      dv3::rfft(frame.data(), fft, out + static_cast<long>(f) * n_freqs,
                scratch);
    }
  }

  // iSTFT with overlap-add and squared-window normalization into a
  // padded-length buffer of size (n_frames-1)*hop + fft.
  void inverse(const cf* spec, int n_frames, std::vector<float>* padded) const {
    const long T = static_cast<long>(n_frames - 1) * hop + fft;
    padded->assign(T, 0.f);
    std::vector<float> norm(T, 0.f);
    std::vector<float> frame(fft);
    std::vector<cf> scratch;
    for (int f = 0; f < n_frames; ++f) {
      dv3::irfft(spec + static_cast<long>(f) * n_freqs, fft, frame.data(),
                 scratch);
      const long base = static_cast<long>(f) * hop;
      for (int k = 0; k < fft; ++k) {
        (*padded)[base + k] += frame[k] * window[k];
        norm[base + k] += window[k] * window[k];
      }
    }
    for (long i = 0; i < T; ++i)
      (*padded)[i] /= std::max(norm[i], 1e-8f);
  }
};

}  // namespace

extern "C" {

// Frame count of the lws-convention STFT: ceil(T/hop)
// (dsp/stft.py:lws_num_frames).
int dv3_num_frames(long length, int fft, int hop) {
  (void)fft;
  return static_cast<int>((length + hop - 1) / hop);
}

// wav (n) -> normalized linear (n_frames, fft/2+1) + mel (n_frames, n_mels).
// mel_w is the (n_mels, fft/2+1) Slaney filterbank row-major.
// Matches AudioProcessor._features (dsp/audio.py:52-62).
void dv3_features(const float* y, long n, int fft, int hop,
                  const float* mel_w, int n_mels, float preemph,
                  float min_level_db, float ref_level_db,
                  float* linear_out, float* mel_out) {
  const Stft stft(fft, hop);
  const int n_frames = dv3_num_frames(n, fft, hop);
  const int F = stft.n_freqs;

  // preemphasis: y[t] - coef * y[t-1]
  std::vector<float> e(n);
  if (n > 0) e[0] = y[0];
  for (long t = 1; t < n; ++t) e[t] = y[t] - preemph * y[t - 1];

  std::vector<float> mag(static_cast<long>(n_frames) * F);
  stft.forward_mag(e.data(), n, n_frames, mag.data());

  const float min_level = std::exp(min_level_db / 20.0f * std::log(10.0f));
  for (int f = 0; f < n_frames; ++f) {
    const float* m = &mag[static_cast<long>(f) * F];
    for (int k = 0; k < F; ++k)
      linear_out[static_cast<long>(f) * F + k] =
          normalize_db(amp_to_db(m[k], min_level) - ref_level_db,
                       min_level_db);
    for (int j = 0; j < n_mels; ++j) {
      float acc = 0.f;
      const float* w = mel_w + static_cast<long>(j) * F;
      for (int k = 0; k < F; ++k) acc += w[k] * m[k];
      mel_out[static_cast<long>(f) * n_mels + j] =
          normalize_db(amp_to_db(acc, min_level) - ref_level_db, min_level_db);
    }
  }
}

// Normalized linear spectrogram (n_frames, fft/2+1) -> waveform
// (n_frames * hop samples). Full inverse pipeline: denormalize -> dB->amp ->
// power raise -> momentum Griffin-Lim -> iSTFT -> inverse preemphasis
// (reference audio.py:37-43; dsp/audio.py inv_spectrogram).
// phase_init: 0 = zero phase (classic GL), 1 = SPSI-style per-bin
// interpolated-frequency phase integration (dsp/stft.py:spsi_phase) — the
// device default; halves the iterations needed for equal quality.
void dv3_inv_spectrogram(const float* spec, int n_frames, int fft, int hop,
                         float power, float min_level_db, float ref_level_db,
                         int n_iters, float momentum, float preemph,
                         int phase_init, float* wav_out) {
  const Stft stft(fft, hop);
  const int F = stft.n_freqs;
  const long NF = static_cast<long>(n_frames) * F;

  // denormalize + amp + power
  std::vector<float> S(NF);
  for (long i = 0; i < NF; ++i) {
    const float clipped = std::min(1.0f, std::max(0.0f, spec[i]));
    const float db = clipped * -min_level_db + min_level_db + ref_level_db;
    S[i] = std::pow(std::pow(10.0f, db * 0.05f), power);
  }

  // Griffin-Lim with momentum (dsp/stft.py:griffin_lim): c = S * phase,
  // t = STFT(iSTFT(c)), accelerated by t + momentum*(t - t_prev).
  std::vector<cf> c(NF), t(NF), t_prev(NF, cf(0.f, 0.f));
  if (phase_init == 1) {
    // SPSI start (dsp/stft.py:spsi_phase): each bin's instantaneous
    // frequency by quadratic interpolation of its magnitude triplet,
    // phase integrated over frames (phi[f] = phi[f-1] + hop*omega).
    const float two_pi = 6.28318530717958647692f;
    std::vector<float> phi(F, 0.f);
    for (int f = 0; f < n_frames; ++f) {
      const float* m = S.data() + static_cast<long>(f) * F;
      cf* cf_row = c.data() + static_cast<long>(f) * F;
      for (int i = 0; i < F; ++i) {
        const float l = m[i > 0 ? i - 1 : 0];
        const float r = m[i < F - 1 ? i + 1 : F - 1];
        const float denom = l - 2.0f * m[i] + r;
        float p = (std::fabs(denom) > 1e-12f) ? 0.5f * (l - r) / denom : 0.f;
        p = std::min(0.5f, std::max(-0.5f, p));
        const float omega = two_pi * (static_cast<float>(i) + p) / fft;
        phi[i] += hop * omega;
        cf_row[i] = m[i] * cf(std::cos(phi[i]), std::sin(phi[i]));
      }
    }
  } else {
    for (long i = 0; i < NF; ++i) c[i] = cf(S[i], 0.f);
  }
  std::vector<float> padded;
  for (int it = 0; it < n_iters; ++it) {
    stft.inverse(c.data(), n_frames, &padded);
    // re-frame the raw overlap-add signal directly on the analysis
    // timeline (frame f = padded[f*hop : f*hop+fft]) — identical
    // semantics to dsp/stft.py:griffin_lim and the Pallas kernel.
    {
      std::vector<float> frame(fft);
      std::vector<cf> scratch;
      for (int f = 0; f < n_frames; ++f) {
        const float* base = padded.data() + static_cast<long>(f) * hop;
        for (int k = 0; k < fft; ++k) frame[k] = base[k] * stft.window[k];
        dv3::rfft(frame.data(), fft, t.data() + static_cast<long>(f) * F,
                  scratch);
      }
    }
    for (long i = 0; i < NF; ++i) {
      const cf acc = t[i] + momentum * (t[i] - t_prev[i]);
      const float a = std::abs(acc);
      const cf phase = (a > 1e-16f) ? acc / a : cf(1.f, 0.f);
      c[i] = S[i] * phase;
      t_prev[i] = t[i];
    }
  }

  stft.inverse(c.data(), n_frames, &padded);
  // lws-convention trim: the waveform starts at sample 0 of the analysis
  // timeline (no centering offset).
  const long out_len = static_cast<long>(n_frames) * hop;
  std::vector<float> wav(out_len, 0.f);
  const long avail = static_cast<long>(padded.size());
  for (long i = 0; i < out_len && i < avail; ++i) wav[i] = padded[i];

  // inverse preemphasis: y[t] = x[t] + coef * y[t-1]
  float prev = 0.f;
  for (long i = 0; i < out_len; ++i) {
    prev = wav[i] + preemph * prev;
    wav_out[i] = prev;
  }
}

// Batched feature extraction across a worker thread pool — the native
// analogue of the reference's ProcessPoolExecutor fan-out (ljspeech.py:25-36)
// without process-spawn overhead. Signals are packed back to back in `y`
// with per-item lengths; outputs are packed the same way.
void dv3_features_batch(const float* y, const long* lengths, int n_items,
                        int fft, int hop, const float* mel_w, int n_mels,
                        float preemph, float min_level_db, float ref_level_db,
                        float* linear_out, float* mel_out, int n_threads) {
  std::vector<long> in_off(n_items + 1, 0), fr_off(n_items + 1, 0);
  for (int i = 0; i < n_items; ++i) {
    in_off[i + 1] = in_off[i] + lengths[i];
    fr_off[i + 1] = fr_off[i] + dv3_num_frames(lengths[i], fft, hop);
  }
  const int F = fft / 2 + 1;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  n_threads = std::min(n_threads, std::max(n_items, 1));
  std::vector<std::thread> pool;
  std::atomic<int> next{0};
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (int i = next.fetch_add(1); i < n_items; i = next.fetch_add(1)) {
        dv3_features(y + in_off[i], lengths[i], fft, hop, mel_w, n_mels,
                     preemph, min_level_db, ref_level_db,
                     linear_out + fr_off[i] * F, mel_out + fr_off[i] * n_mels);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
