// aat_host: the host-side routines of the data path, in C++ with a C ABI
// bound through ctypes (aat_tpu_torch/runtime/native.py). The port's copy
// of aat_tpu/runtime/aat_host.cpp; every entry point is bitwise equal to
// its numpy route in aat_tpu_torch/runtime/host_ops.py.
//
//   assemble_segments   dense [S, F] segment gather + mask from boundaries
//   normalize_pad       per-row zero-mean/unit-var normalization + padding
//   smoothed_amplitude  float32 running-mean curve, bit-faithful to a
//                       sequential numpy float32 cumsum
//   find_minima         epsilon-comparator local maxima + threshold
//   edit_distance       word-level Levenshtein over id sequences (WER)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 aat_host.cpp -o libaat_host.so
// (no -ffast-math: the float semantics are IEEE, as numpy's)

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <vector>

extern "C" {

// Gather variable-length [start, end) windows of `waveform` into a dense
// [n_segments, max_frames] buffer and set the validity mask over out_lens.
void assemble_segments(
    const float* waveform, int64_t waveform_len,
    const int64_t* starts, const int64_t* ends, const int64_t* out_lens,
    int64_t n_segments, int64_t max_frames,
    float* segments_out, float* mask_out) {
  for (int64_t s = 0; s < n_segments; ++s) {
    float* seg = segments_out + s * max_frames;
    float* msk = mask_out + s * max_frames;
    std::memset(seg, 0, sizeof(float) * max_frames);
    std::memset(msk, 0, sizeof(float) * max_frames);
    const int64_t start = starts[s];
    const int64_t data_len =
        std::min(ends[s] - start,
                 std::min(max_frames, waveform_len - start));
    const int64_t valid_len = std::min(out_lens[s], max_frames);
    if (data_len > 0) {
      std::memcpy(seg, waveform + start, sizeof(float) * data_len);
    }
    for (int64_t f = 0; f < valid_len; ++f) msk[f] = 1.0f;
  }
}

// Per-row zero-mean / unit-variance (HF Wav2Vec2 feature-extractor
// semantics, eps 1e-7) into a padded [n, max_len] batch.
void normalize_pad(
    const double* const* waveforms, const int64_t* lengths, int64_t n,
    int64_t max_len, float* out, int64_t* mask_out) {
  for (int64_t i = 0; i < n; ++i) {
    const double* w = waveforms[i];
    const int64_t len = lengths[i];
    double mean = 0.0;
    for (int64_t j = 0; j < len; ++j) mean += w[j];
    mean /= static_cast<double>(len);
    double var = 0.0;
    for (int64_t j = 0; j < len; ++j) {
      const double d = w[j] - mean;
      var += d * d;
    }
    var /= static_cast<double>(len);
    const double inv = 1.0 / std::sqrt(var + 1e-7);
    float* row = out + i * max_len;
    int64_t* mrow = mask_out + i * max_len;
    for (int64_t j = 0; j < len; ++j) {
      row[j] = static_cast<float>((w[j] - mean) * inv);
      mrow[j] = 1;
    }
    for (int64_t j = len; j < max_len; ++j) {
      row[j] = 0.0f;
      mrow[j] = 0;
    }
  }
}

// Float32 smoothed amplitude curve: callers pass the float32 amplitude;
// this is the sequential float32 cumsum and the windowed difference over
// n_points, (c[i + n] - c[i]) / n in that order.
void smoothed_amplitude(
    const float* amplitude, int64_t t, int64_t n_points, float* out) {
  std::vector<float> cumsum(t);
  float acc = 0.0f;
  for (int64_t i = 0; i < t; ++i) {
    acc += amplitude[i];  // sequential f32 adds == numpy float32 cumsum
    cumsum[i] = acc;
  }
  for (int64_t i = 0; i + n_points < t; ++i) {
    out[i] = (cumsum[i + n_points] - cumsum[i]) / static_cast<float>(n_points);
  }
}

// Epsilon-comparator strict local maxima with amplitude threshold
// (scipy argrelextrema with a greater-by-eps comparator, then the filter).
// Returns number of minima written to out_idx (capacity max_out).
int64_t find_minima(
    const float* smoothed, int64_t t, float eps, float threshold,
    int64_t* out_idx, int64_t max_out) {
  int64_t count = 0;
  for (int64_t i = 1; i + 1 < t && count < max_out; ++i) {
    const float x = smoothed[i];
    if (x > smoothed[i + 1] + eps && x > smoothed[i - 1] + eps &&
        x > threshold) {
      out_idx[count++] = i;
    }
  }
  return count;
}

// Word-level Levenshtein distance between two id sequences.
int64_t edit_distance(
    const int64_t* a, int64_t la, const int64_t* b, int64_t lb) {
  if (la < lb) {
    std::swap(a, b);
    std::swap(la, lb);
  }
  std::vector<int64_t> prev(lb + 1), cur(lb + 1);
  for (int64_t j = 0; j <= lb; ++j) prev[j] = j;
  for (int64_t i = 1; i <= la; ++i) {
    cur[0] = i;
    for (int64_t j = 1; j <= lb; ++j) {
      const int64_t sub = prev[j - 1] + (a[i - 1] != b[j - 1] ? 1 : 0);
      cur[j] = std::min({prev[j] + 1, cur[j - 1] + 1, sub});
    }
    std::swap(prev, cur);
  }
  return prev[lb];
}

}  // extern "C"
