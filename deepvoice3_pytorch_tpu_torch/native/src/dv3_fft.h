// Iterative radix-2 FFT used by the host DSP library.
//
// The device path uses torch.fft (dsp/stft.py); this native library is the
// host-side equivalent of the reference's lws C++ extension (reference
// audio.py:9,54-55) for machines with no accelerator attached — dataset
// preprocessing workers and CPU-only synthesis.
#pragma once

#include <cmath>
#include <complex>
#include <cstddef>
#include <vector>

namespace dv3 {

// In-place iterative radix-2 Cooley-Tukey FFT. n must be a power of two.
// sign = -1 for forward, +1 for inverse (unscaled).
inline void fft_pow2(std::complex<float>* a, std::size_t n, int sign) {
  // bit-reversal permutation
  for (std::size_t i = 1, j = 0; i < n; ++i) {
    std::size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (std::size_t len = 2; len <= n; len <<= 1) {
    const double ang = sign * 2.0 * M_PI / static_cast<double>(len);
    const std::complex<double> wlen(std::cos(ang), std::sin(ang));
    for (std::size_t i = 0; i < n; i += len) {
      std::complex<double> w(1.0, 0.0);
      for (std::size_t k = 0; k < len / 2; ++k) {
        const std::complex<double> u(a[i + k]);
        const std::complex<double> v =
            std::complex<double>(a[i + k + len / 2]) * w;
        a[i + k] = std::complex<float>(u + v);
        a[i + k + len / 2] = std::complex<float>(u - v);
        w *= wlen;
      }
    }
  }
}

// Real-input FFT: returns the first n/2+1 bins (like numpy.fft.rfft).
inline void rfft(const float* x, std::size_t n, std::complex<float>* out,
                 std::vector<std::complex<float>>& scratch) {
  scratch.assign(n, std::complex<float>(0.f, 0.f));
  for (std::size_t i = 0; i < n; ++i) scratch[i] = {x[i], 0.f};
  fft_pow2(scratch.data(), n, -1);
  for (std::size_t i = 0; i <= n / 2; ++i) out[i] = scratch[i];
}

// Inverse of rfft: reconstructs a length-n real signal from n/2+1 bins
// (like numpy.fft.irfft).
inline void irfft(const std::complex<float>* spec, std::size_t n, float* out,
                  std::vector<std::complex<float>>& scratch) {
  scratch.assign(n, std::complex<float>(0.f, 0.f));
  for (std::size_t i = 0; i <= n / 2; ++i) scratch[i] = spec[i];
  for (std::size_t i = n / 2 + 1; i < n; ++i)
    scratch[i] = std::conj(spec[n - i]);
  fft_pow2(scratch.data(), n, +1);
  const float inv_n = 1.0f / static_cast<float>(n);
  for (std::size_t i = 0; i < n; ++i) out[i] = scratch[i].real() * inv_n;
}

}  // namespace dv3
