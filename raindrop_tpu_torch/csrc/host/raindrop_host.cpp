// The port's host-side data runtime: the hot loops of its data layer in
// C++/OpenMP, exported with a plain C ABI and bound with ctypes by
// raindrop_tpu_torch/native.py, which builds this file with g++ at first
// use (g++ -O3 -march=native -fopenmp -std=c++17 -shared -fPIC, into
// raindrop_tpu_torch/kernels/_build/, the file named by a hash of this
// source and the flags).
//
// The numpy functions of raindrop_tpu_torch/data/ (normalize.py,
// baselines/grud.py's recurrence, settings.py, prefetch.py) define the
// semantics; every function here matches them to float64 round-off:
// elementwise ops are bit-identical, and the reductions use Kahan
// compensation and agree with numpy's pairwise sums to about 1e-13
// relative. The reference's host pipeline is Python loops over numpy
// views (reference code/utils_rd.py:149-257, per-feature loops;
// code/baselines/GRU-D_data_preparation.py:55-200, per-timestamp delta
// loops).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Per-sensor mean/std over strictly-positive entries.
//   P: [R, F] row-major float64 (R = N*T flattened observations)
//   mf/stdf: [F] outputs. cnt==0 -> mean=NaN (like numpy 0/0 path guarded
//   by where(cnt>0, ., nan)); std floored at eps.
// Reference semantics: code/utils_rd.py:149-161 (getStats).
void rd_get_stats(const double* P, int64_t R, int64_t F,
                  double* mf, double* stdf, double eps) {
#pragma omp parallel for schedule(static)
  for (int64_t f = 0; f < F; ++f) {
    // pass 1: compensated sum + count of positives
    double sum = 0.0, c = 0.0;
    int64_t cnt = 0;
    for (int64_t r = 0; r < R; ++r) {
      double v = P[r * F + f];
      if (v > 0.0) {
        double y = v - c;
        double t = sum + y;
        c = (t - sum) - y;
        sum = t;
        ++cnt;
      }
    }
    int64_t safe = cnt > 0 ? cnt : 1;
    double mean = sum / (double)safe;
    if (cnt == 0) {
      // numpy: mean is NaN, and the NaN propagates through the variance
      // and maximum(sqrt(var), eps) — std is NaN too, not eps.
      mf[f] = NAN;
      stdf[f] = NAN;
      continue;
    }
    mf[f] = mean;
    // pass 2: compensated sum of squared deviations over positives
    double ss = 0.0, c2 = 0.0;
    for (int64_t r = 0; r < R; ++r) {
      double v = P[r * F + f];
      if (v > 0.0) {
        double d = v - mean;
        double y = d * d - c2;
        double t = ss + y;
        c2 = (t - ss) - y;
        ss = t;
      }
    }
    double sd = std::sqrt(ss / (double)safe);
    stdf[f] = sd > eps ? sd : eps;
  }
}

// z-score with (mf, stdf), re-zero missing, concat observed mask.
//   P: [N, T, F] float64; out: [N, T, 2F] float32.
// Bit-identical to data/normalize.py's numpy mask_normalize (same op order:
// (v - mf) / (stdf + 1e-18) * m, computed in double, cast to float).
// Reference semantics: code/utils_rd.py:164-175.
void rd_mask_normalize(const double* P, int64_t N, int64_t T, int64_t F,
                       const double* mf, const double* stdf, float* out) {
  int64_t rows = N * T;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    const double* src = P + r * F;
    float* dst = out + r * 2 * F;
    for (int64_t f = 0; f < F; ++f) {
      double v = src[f];
      double m = v > 0.0 ? 1.0 : 0.0;
      dst[f] = (float)((v - mf[f]) / (stdf[f] + 1e-18) * m);
      dst[F + f] = (float)m;
    }
  }
}

// z-score static features then zero entries that END UP <= 0 (the
// reference's post-normalization relu quirk, code/utils_rd.py:211-214).
//   Ps: [N, S] float64; out float32.
void rd_mask_normalize_static(const double* Ps, int64_t N, int64_t S,
                              const double* ms, const double* ss,
                              float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t n = 0; n < N; ++n) {
    for (int64_t s = 0; s < S; ++s) {
      double v = (Ps[n * S + s] - ms[s]) / (ss[s] + 1e-18);
      out[n * S + s] = (float)(v <= 0.0 ? 0.0 : v);
    }
  }
}

// GRU-D delta recurrence: time since the sensor was last observed,
// accumulating through missing steps (reference
// GRU-D_data_preparation.py:142-148):
//   delta[0] = 0;  delta[t] = gap(t) + (1 - mask[t-1]) * delta[t-1]
//   mask: [N, T, F] float32; times: [N, T] float64; delta out [N, T, F] f32.
void rd_build_delta(const float* mask, const double* times,
                    int64_t N, int64_t T, int64_t F, float* delta) {
#pragma omp parallel for schedule(static)
  for (int64_t n = 0; n < N; ++n) {
    const float* m = mask + n * T * F;
    const double* tm = times + n * T;
    float* d = delta + n * T * F;
    for (int64_t f = 0; f < F; ++f) d[f] = 0.0f;
    for (int64_t t = 1; t < T; ++t) {
      double gap = tm[t] - tm[t - 1];
      const float* mp = m + (t - 1) * F;
      const float* dp = d + (t - 1) * F;
      float* dt = d + t * F;
      for (int64_t f = 0; f < F; ++f) {
        dt[f] = (float)(gap + (1.0 - (double)mp[f]) * (double)dp[f]);
      }
    }
  }
}

// Zero a fixed set of sensor VALUE columns in-place across val/test
// tensors — the Setting-2 "leave-fixed-sensors-out" transform (reference
// code/Raindrop.py:227-231) on the [N, T, 2F] values++mask layout. The
// reference zeroes only the value columns, leaving the mask columns as
// they were (data/settings.py remove_sensors_fixed matches).
//   P: [N, T, 2F] float32; idx: [K] sensor indices.
void rd_zero_sensors(float* P, int64_t N, int64_t T, int64_t F,
                     const int64_t* idx, int64_t K) {
  int64_t rows = N * T;
#pragma omp parallel for schedule(static)
  for (int64_t r = 0; r < rows; ++r) {
    float* row = P + r * 2 * F;
    for (int64_t k = 0; k < K; ++k) {
      row[idx[k]] = 0.0f;
    }
  }
}

// Batch assembly for the streaming input pipeline (data/prefetch.py):
// gather B sample rows by index in one OpenMP pass. P is any [N, rowlen]
// row-major float32 view (e.g. [N, T*2F] flattened series); out [B, rowlen].
void rd_gather_rows(const float* P, int64_t rowlen, const int64_t* idx,
                    int64_t B, float* out) {
#pragma omp parallel for schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    memcpy(out + b * rowlen, P + idx[b] * rowlen,
           (size_t)rowlen * sizeof(float));
  }
}

// Gather + time-major transpose fused: P [N, T, C] -> out [T, B, C] for
// the model's [T, B, 2F] input contract (reference permute at
// code/Raindrop.py:233-239) without a second host pass.
void rd_gather_time_major(const float* P, int64_t T, int64_t C,
                          const int64_t* idx, int64_t B, float* out) {
#pragma omp parallel for collapse(2) schedule(static)
  for (int64_t b = 0; b < B; ++b) {
    for (int64_t t = 0; t < T; ++t) {
      memcpy(out + (t * B + b) * C, P + (idx[b] * T + t) * C,
             (size_t)C * sizeof(float));
    }
  }
}


}  // extern "C"
