// Host GMM EM and Fisher-vector encoding behind a plain C ABI, for ctypes.
//
// The repository's native/enceval_ffi.cpp exports these loops only as XLA
// FFI handlers (KeystoneGmmEm, KeystoneFisher), which PyTorch cannot call.
// This file keeps its own copy of their arithmetic: em_pass, the M step
// of GmmEmImpl and FisherImpl, line for line in double precision. One
// change: em_pass sums each thread's partial statistics in thread order
// after the parallel region (a static schedule), where the FFI version
// adds them under `omp critical` in whatever order threads finish, so a
// run here is bitwise repeatable for a fixed thread count.
//
// Layouts: x (n, d) row-major; mu and var (d, k) row-major (x[i * k + j]);
// w (k,); a descriptor batch (n, d, m); Fisher vectors (n, d, 2k).
//
// Built by g++ (-O3 -fPIC -fopenmp -std=c++17; without -fopenmp where the
// compiler has no OpenMP runtime) into keystone_tpu_torch/_build/ at first
// use; bound in keystone_tpu_torch/native/enceval.py.

#ifdef _OPENMP
#include <omp.h>
#else
// serial build (a compiler without OpenMP's runtime): one thread
static inline int omp_get_max_threads() { return 1; }
static inline int omp_get_thread_num() { return 0; }
#endif

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

void log_norms(const float* var, const float* w, int64_t d, int64_t k,
               std::vector<double>& log_norm) {
  for (int64_t j = 0; j < k; ++j) {
    double s = 0.0;
    for (int64_t i = 0; i < d; ++i) s += std::log(2.0 * M_PI * var[i * k + j]);
    log_norm[j] = -0.5 * s + std::log(std::max((double)w[j], 1e-30));
  }
}

// log responsibilities + the three sufficient statistics of one EM pass
void em_pass(const float* x, int64_t n, int64_t d, int64_t k, const float* mu,
             const float* var, const float* w, double* nk, double* sx,
             double* sxx) {
  std::vector<double> log_norm(k, 0.0);
  log_norms(var, w, d, k, log_norm);

  const int threads = omp_get_max_threads();
  std::vector<std::vector<double>> nk_t(threads), sx_t(threads), sxx_t(threads);
#pragma omp parallel num_threads(threads)
  {
    const int t = omp_get_thread_num();
    std::vector<double> lp(k), gamma(k);
    std::vector<double> nk_l(k, 0.0), sx_l(d * k, 0.0), sxx_l(d * k, 0.0);
#pragma omp for schedule(static) nowait
    for (int64_t r = 0; r < n; ++r) {
      const float* xr = x + r * d;
      double m = -1e300;
      for (int64_t j = 0; j < k; ++j) {
        double q = 0.0;
        for (int64_t i = 0; i < d; ++i) {
          const double diff = (double)xr[i] - (double)mu[i * k + j];
          q += diff * diff / (double)var[i * k + j];
        }
        lp[j] = log_norm[j] - 0.5 * q;
        m = std::max(m, lp[j]);
      }
      double z = 0.0;
      for (int64_t j = 0; j < k; ++j) {
        gamma[j] = std::exp(lp[j] - m);
        z += gamma[j];
      }
      for (int64_t j = 0; j < k; ++j) {
        const double g = gamma[j] / z;
        nk_l[j] += g;
        for (int64_t i = 0; i < d; ++i) {
          const double xi = xr[i];
          sx_l[i * k + j] += g * xi;
          sxx_l[i * k + j] += g * xi * xi;
        }
      }
    }
    nk_t[t] = std::move(nk_l);
    sx_t[t] = std::move(sx_l);
    sxx_t[t] = std::move(sxx_l);
  }
  std::fill(nk, nk + k, 0.0);
  std::fill(sx, sx + d * k, 0.0);
  std::fill(sxx, sxx + d * k, 0.0);
  for (int t = 0; t < threads; ++t) {
    if (nk_t[t].empty()) continue;
    for (int64_t j = 0; j < k; ++j) nk[j] += nk_t[t][j];
    for (int64_t e = 0; e < d * k; ++e) {
      sx[e] += sx_t[t][e];
      sxx[e] += sxx_t[t][e];
    }
  }
}

}  // namespace

extern "C" {

// max_iter EM steps from (mu0, var0, w0); the regularized nk (nk + 1e-10)
// serves all three updates, as in the device path. Returns 0.
int keystone_gmm_em(const float* x, int64_t n, int64_t d, int64_t k,
                    const float* mu0, const float* var0, const float* w0,
                    int64_t max_iter, float var_floor, float* mu_out,
                    float* var_out, float* w_out) {
  if (n < 1 || d < 1 || k < 1) return 1;
  std::vector<float> mu(mu0, mu0 + d * k);
  std::vector<float> var(var0, var0 + d * k);
  std::vector<float> w(w0, w0 + k);
  std::vector<double> nk(k), sx(d * k), sxx(d * k);
  for (int64_t it = 0; it < max_iter; ++it) {
    em_pass(x, n, d, k, mu.data(), var.data(), w.data(), nk.data(), sx.data(),
            sxx.data());
    for (int64_t j = 0; j < k; ++j) {
      const double denom = nk[j] + 1e-10;
      for (int64_t i = 0; i < d; ++i) {
        const double m = sx[i * k + j] / denom;
        const double v = sxx[i * k + j] / denom - m * m;
        mu[i * k + j] = (float)m;
        var[i * k + j] = (float)std::max(v, (double)var_floor);
      }
      w[j] = (float)(denom / (double)n);
    }
  }
  std::copy(mu.begin(), mu.end(), mu_out);
  std::copy(var.begin(), var.end(), var_out);
  std::copy(w.begin(), w.end(), w_out);
  return 0;
}

// improved Fisher vectors, no internal normalization (alpha 1, pnorm 0):
// per image the mean gradients in columns 0..k-1, the variance gradients
// in k..2k-1. Returns 0.
int keystone_fisher(const float* batch, int64_t n, int64_t d, int64_t m,
                    int64_t k, const float* mu_p, const float* var_p,
                    const float* w_p, float* out) {
  if (d < 1 || m < 1 || k < 1) return 1;
  std::vector<double> log_norm(k);
  log_norms(var_p, w_p, d, k, log_norm);

#pragma omp parallel for
  for (int64_t img = 0; img < n; ++img) {
    const float* xb = batch + img * d * m;  // (d, m) descriptor-major
    float* ob = out + img * d * 2 * k;
    std::vector<double> lp(k), gamma(k);
    std::vector<double> s0(k, 0.0), s1(d * k, 0.0), s2(d * k, 0.0);
    for (int64_t c = 0; c < m; ++c) {
      double mx = -1e300;
      for (int64_t j = 0; j < k; ++j) {
        double q = 0.0;
        for (int64_t i = 0; i < d; ++i) {
          const double diff = (double)xb[i * m + c] - (double)mu_p[i * k + j];
          q += diff * diff / (double)var_p[i * k + j];
        }
        lp[j] = log_norm[j] - 0.5 * q;
        mx = std::max(mx, lp[j]);
      }
      double z = 0.0;
      for (int64_t j = 0; j < k; ++j) {
        gamma[j] = std::exp(lp[j] - mx);
        z += gamma[j];
      }
      for (int64_t j = 0; j < k; ++j) {
        const double g = gamma[j] / z;
        s0[j] += g;
        for (int64_t i = 0; i < d; ++i) {
          const double xi = xb[i * m + c];
          s1[i * k + j] += g * xi;
          s2[i * k + j] += g * xi * xi;
        }
      }
    }
    for (int64_t i = 0; i < d; ++i) {
      for (int64_t j = 0; j < k; ++j) {
        const double muij = mu_p[i * k + j];
        const double sig = std::sqrt((double)var_p[i * k + j]);
        const double fv_mu = (s1[i * k + j] - s0[j] * muij) / sig /
                             ((double)m * std::sqrt((double)w_p[j]));
        const double quad = s2[i * k + j] - 2.0 * s1[i * k + j] * muij +
                            s0[j] * muij * muij;
        const double fv_sig = (quad / (sig * sig) - s0[j]) /
                              ((double)m * std::sqrt(2.0 * (double)w_p[j]));
        ob[i * 2 * k + j] = (float)fv_mu;
        ob[i * 2 * k + k + j] = (float)fv_sig;
      }
    }
  }
  return 0;
}

}  // extern "C"
