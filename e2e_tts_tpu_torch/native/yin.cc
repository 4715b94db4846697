// Native YIN fundamental-frequency estimator.
//
// The hot loop of corpus preprocessing: per-frame difference function +
// cumulative-mean normalization + threshold search with parabolic
// interpolation (de Cheveigné & Kawahara 2002).  Mirrors the NumPy
// implementation in audio/features.py (same contract: f0 per hop frame,
// 0 = unvoiced) but runs the per-frame search in C++, called through
// ctypes from native/__init__.py.  A copy of e2e_tts_tpu/native/yin.cc,
// built by native/build.py at first use.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// difference function d(tau) for one frame via direct accumulation.
// W = frame_length/2 comparison window, tau in [0, tau_max).
void difference(const double* frame, int frame_length, int tau_max,
                double* d) {
  const int w = frame_length / 2;
  for (int tau = 0; tau < tau_max; ++tau) {
    double acc = 0.0;
    for (int j = 0; j < w; ++j) {
      const double diff = frame[j] - frame[j + tau];
      acc += diff * diff;
    }
    d[tau] = acc;
  }
}

}  // namespace

extern "C" {

// audio: float32 mono signal, n samples (caller pre-pads by frame_length/2).
// out_f0: float32, n_frames entries.
// Returns number of frames written.
int yin_f0(const float* audio, int64_t n, int sample_rate, int hop_length,
           double fmin, double fmax, int frame_length, double threshold,
           float* out_f0) {
  const int tau_min_raw = static_cast<int>(sample_rate / fmax);
  const int tau_min = tau_min_raw > 2 ? tau_min_raw : 2;
  int tau_max = static_cast<int>(sample_rate / fmin) + 1;
  if (tau_max > frame_length / 2) tau_max = frame_length / 2;

  const int pad = frame_length / 2;
  const int64_t padded_n = n + 2 * pad;
  std::vector<double> x(padded_n, 0.0);
  for (int64_t i = 0; i < n; ++i) x[pad + i] = audio[i];

  const int n_frames =
      padded_n >= frame_length
          ? static_cast<int>(1 + (padded_n - frame_length) / hop_length)
          : 0;

  std::vector<double> d(tau_max);
  std::vector<double> cmnd(tau_max);

  for (int f = 0; f < n_frames; ++f) {
    const double* frame = x.data() + static_cast<int64_t>(f) * hop_length;
    difference(frame, frame_length, tau_max, d.data());

    // cumulative-mean-normalized difference
    cmnd[0] = 1.0;
    double running = 0.0;
    for (int tau = 1; tau < tau_max; ++tau) {
      running += d[tau];
      cmnd[tau] = running > 1e-12 ? d[tau] * tau / running : 1.0;
    }

    // first threshold crossing, then descend to the local minimum
    int tau = -1;
    for (int t = tau_min; t < tau_max; ++t) {
      if (cmnd[t] < threshold) {
        tau = t;
        while (tau + 1 < tau_max && cmnd[tau + 1] < cmnd[tau]) ++tau;
        break;
      }
    }
    if (tau < 0) {
      out_f0[f] = 0.0f;
      continue;
    }

    // parabolic interpolation around the minimum
    double tau_refined = tau;
    if (tau >= 1 && tau < tau_max - 1) {
      const double s0 = cmnd[tau - 1], s1 = cmnd[tau], s2 = cmnd[tau + 1];
      const double denom = 2.0 * (2.0 * s1 - s2 - s0);
      if (std::fabs(denom) > 1e-12) {
        double shift = (s2 - s0) / denom;
        if (shift > 1.0) shift = 1.0;
        if (shift < -1.0) shift = -1.0;
        tau_refined = tau + shift;
      }
    }
    double f0 = sample_rate / tau_refined;
    if (f0 < fmin || f0 > fmax) f0 = 0.0;
    out_f0[f] = static_cast<float>(f0);
  }
  return n_frames;
}

}  // extern "C"
