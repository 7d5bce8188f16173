// Native host feature extractor: Kaldi-semantics log-mel fbank.
//
// The in-tree equivalent of the reference's external Kaldi C++ toolchain
// (reference prepare_kaldi_data.py:38-46 shells out to compute-fbank-feats;
// Makefile:5-8 builds all of Kaldi to get it). Implements the same pipeline
// as the Python mirror in features/kaldi_fbank.py — the canonical spec —
// and is tested for agreement with it (tests/test_native.py):
//
//   scale to int16 units -> snip-edges framing -> dither -> DC removal ->
//   in-frame pre-emphasis -> symmetric window -> zero-pad to pow2 ->
//   radix-2 FFT -> power spectrum -> HTK-mel triangular bins -> log.
//
// Deviation (documented): the dither RNG is a seeded xoshiro256++ with a
// Box-Muller transform, deterministic per (seed) but a different stream from
// both Kaldi's RandGauss and numpy's PCG64; dither=0 gives bit-comparable
// output across all three.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---- seeded Gaussian RNG (xoshiro256++ + Box-Muller) ----

struct Rng {
  uint64_t s[4];
  explicit Rng(uint64_t seed) {
    // splitmix64 expansion of the seed
    uint64_t x = seed + 0x9E3779B97F4A7C15ULL;
    for (int i = 0; i < 4; ++i) {
      uint64_t z = (x += 0x9E3779B97F4A7C15ULL);
      z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
      z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static uint64_t rotl(uint64_t v, int k) { return (v << k) | (v >> (64 - k)); }
  uint64_t next() {
    uint64_t result = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return result;
  }
  double uniform() {  // (0, 1]
    return ((next() >> 11) + 1.0) * (1.0 / 9007199254740993.0);
  }
  double gauss() {
    double u1 = uniform(), u2 = uniform();
    return std::sqrt(-2.0 * std::log(u1)) * std::cos(2.0 * kPi * u2);
  }
};

// ---- iterative radix-2 complex FFT (n must be a power of two) ----

void fft_radix2(std::vector<double>& re, std::vector<double>& im) {
  const size_t n = re.size();
  for (size_t i = 1, j = 0; i < n; ++i) {  // bit reversal
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) {
      std::swap(re[i], re[j]);
      std::swap(im[i], im[j]);
    }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = -2.0 * kPi / static_cast<double>(len);
    double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cwr = 1.0, cwi = 0.0;
      for (size_t k = 0; k < len / 2; ++k) {
        double ur = re[i + k], ui = im[i + k];
        double vr = re[i + k + len / 2] * cwr - im[i + k + len / 2] * cwi;
        double vi = re[i + k + len / 2] * cwi + im[i + k + len / 2] * cwr;
        re[i + k] = ur + vr;
        im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr;
        im[i + k + len / 2] = ui - vi;
        double nwr = cwr * wr - cwi * wi;
        cwi = cwr * wi + cwi * wr;
        cwr = nwr;
      }
    }
  }
}

double hz_to_mel(double hz) { return 1127.0 * std::log1p(hz / 700.0); }

int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

// Number of output frames for a signal of length n (snip_edges).
int fbank_num_frames(int n, int sr, double frame_length_ms, double frame_shift_ms) {
  int win = static_cast<int>(sr * frame_length_ms / 1000.0);
  int hop = static_cast<int>(sr * frame_shift_ms / 1000.0);
  if (n < win) return 0;
  return (n - win) / hop + 1;
}

// Compute fbank features.
//   y: [n] float32 in [-1, 1]; out: [n_frames * n_mels] float32 (row-major).
// window_type: 0=hamming 1=povey 2=hanning 3=rectangular 4=blackman.
// Returns n_frames (>= 0) or -1 on error.
int fbank_compute(const float* y, int n, int sr,
                  double frame_length_ms, double frame_shift_ms,
                  int n_mels, int window_type, double dither,
                  double preemph, int remove_dc_offset,
                  double low_freq, double high_freq,
                  int use_power, int use_log,
                  double input_scale, uint64_t seed,
                  float* out) {
  const int win = static_cast<int>(sr * frame_length_ms / 1000.0);
  const int hop = static_cast<int>(sr * frame_shift_ms / 1000.0);
  const int n_frames = fbank_num_frames(n, sr, frame_length_ms, frame_shift_ms);
  if (n_frames <= 0) return 0;
  const int n_fft = next_pow2(win);
  const int n_bins = n_fft / 2 + 1;

  // window function (symmetric, Kaldi feature-window.cc semantics)
  std::vector<double> window(win);
  const double a = 2.0 * kPi / (win - 1);
  for (int i = 0; i < win; ++i) {
    switch (window_type) {
      case 0: window[i] = 0.54 - 0.46 * std::cos(a * i); break;
      case 1: window[i] = std::pow(0.5 - 0.5 * std::cos(a * i), 0.85); break;
      case 2: window[i] = 0.5 - 0.5 * std::cos(a * i); break;
      case 3: window[i] = 1.0; break;
      case 4: window[i] = 0.42 - 0.5 * std::cos(a * i) + 0.08 * std::cos(2 * a * i); break;
      default: return -1;
    }
  }

  // mel filterbank (triangles in mel space over FFT bin centers, peak 1)
  const double nyquist = sr / 2.0;
  double high = high_freq <= 0.0 ? nyquist + high_freq : high_freq;
  const double mel_low = hz_to_mel(low_freq);
  const double mel_high = hz_to_mel(high);
  const double mel_delta = (mel_high - mel_low) / (n_mels + 1);
  std::vector<double> bin_mel(n_bins);
  for (int k = 0; k < n_bins; ++k)
    bin_mel[k] = hz_to_mel(static_cast<double>(k) * sr / n_fft);
  // per-mel [start_bin, end_bin) + weights, sparse
  std::vector<int> mel_start(n_mels), mel_end(n_mels);
  std::vector<std::vector<double>> mel_w(n_mels);
  for (int m = 0; m < n_mels; ++m) {
    const double left = mel_low + m * mel_delta;
    const double center = left + mel_delta;
    const double right = center + mel_delta;
    int s = 0;
    while (s < n_bins && bin_mel[s] <= left) ++s;
    int e = s;
    while (e < n_bins && bin_mel[e] < right) ++e;
    mel_start[m] = s;
    mel_end[m] = e;
    mel_w[m].resize(e - s);
    for (int k = s; k < e; ++k) {
      double up = (bin_mel[k] - left) / (center - left);
      double down = (right - bin_mel[k]) / (right - center);
      double w = up < down ? up : down;
      mel_w[m][k - s] = w > 0.0 ? w : 0.0;
    }
  }

  const double eps = 1.1920928955078125e-07;  // FLT_EPSILON
  Rng rng(seed);
  std::vector<double> frame(win), re(n_fft), im(n_fft);

  for (int t = 0; t < n_frames; ++t) {
    const float* src = y + static_cast<long>(t) * hop;
    for (int i = 0; i < win; ++i) frame[i] = static_cast<double>(src[i]) * input_scale;

    if (dither != 0.0)
      for (int i = 0; i < win; ++i) frame[i] += dither * rng.gauss();

    if (remove_dc_offset) {
      double mean = 0.0;
      for (int i = 0; i < win; ++i) mean += frame[i];
      mean /= win;
      for (int i = 0; i < win; ++i) frame[i] -= mean;
    }

    if (preemph != 0.0) {
      for (int i = win - 1; i > 0; --i) frame[i] -= preemph * frame[i - 1];
      frame[0] -= preemph * frame[0];
    }

    std::fill(re.begin(), re.end(), 0.0);
    std::fill(im.begin(), im.end(), 0.0);
    for (int i = 0; i < win; ++i) re[i] = frame[i] * window[i];
    fft_radix2(re, im);

    // power (or magnitude) spectrum over the first n_bins
    std::vector<double> spec(n_bins);
    for (int k = 0; k < n_bins; ++k) {
      double p = re[k] * re[k] + im[k] * im[k];
      spec[k] = use_power ? p : std::sqrt(p);
    }

    float* dst = out + static_cast<long>(t) * n_mels;
    for (int m = 0; m < n_mels; ++m) {
      double acc = 0.0;
      const int s = mel_start[m];
      for (int k = s; k < mel_end[m]; ++k) acc += spec[k] * mel_w[m][k - s];
      if (use_log) acc = std::log(acc > eps ? acc : eps);
      dst[m] = static_cast<float>(acc);
    }
  }
  return n_frames;
}

}  // extern "C"
