// Host-side column data marshaling for ocean_bgc.
//
// The reference library receives level-major Fortran arrays
// (k, column[, tracer]) filled by its host model (SURVEY.md par.1
// "data-flow contract"); real hosts (MPAS-Ocean) store column-major
// (cell, level) blocks, so a layout transform sits on the hot
// host->device path every coupling step.  This translation unit provides
// that transform as a small threaded C++ library:
//
//   * pack_level_major    (ncol, nlev)       -> (nlev, ncol)
//   * unpack_level_major  (nlev, ncol)       -> (ncol, nlev)
//   * pack_tracers        (ncol, nlev, ntr)  -> (nlev, ntr, ncol)
//   * unpack_tracers      (nlev, ntr, ncol)  -> (ncol, nlev, ntr)
//   * pack_tracers_f32    same, widening float -> double on the fly
//   * scrub_nonfinite     replace NaN/Inf with a fill value (returns count)
//
// Cache-blocked transposes, sliced across a std::thread pool.  Built as a
// plain shared library (see native/Makefile) and loaded via ctypes — no
// Python build-time dependency.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBlock = 64;  // tile edge for cache-blocked transpose

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 1 : static_cast<int>(n);
}

// Run fn(lo, hi) over [0, n) split across the thread pool.
template <typename Fn>
void parallel_for(int64_t n, Fn fn) {
  int nthreads = std::min<int64_t>(hardware_threads(), std::max<int64_t>(n / 256, 1));
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> pool;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

// (rows, cols) -> (cols, rows), cache-blocked on the row axis slice.
template <typename Src>
void transpose_block(const Src* src, double* dst, int64_t rows, int64_t cols,
                     int64_t row_lo, int64_t row_hi) {
  for (int64_t rb = row_lo; rb < row_hi; rb += kBlock) {
    int64_t re = std::min(row_hi, rb + kBlock);
    for (int64_t cb = 0; cb < cols; cb += kBlock) {
      int64_t ce = std::min(cols, cb + kBlock);
      for (int64_t r = rb; r < re; ++r) {
        for (int64_t c = cb; c < ce; ++c) {
          dst[c * rows + r] = static_cast<double>(src[r * cols + c]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// (ncol, nlev) host layout -> (nlev, ncol) device layout.
void pack_level_major(const double* src, double* dst, int64_t ncol,
                      int64_t nlev) {
  parallel_for(ncol, [=](int64_t lo, int64_t hi) {
    transpose_block(src, dst, ncol, nlev, lo, hi);
  });
}

// (nlev, ncol) device layout -> (ncol, nlev) host layout.
void unpack_level_major(const double* src, double* dst, int64_t nlev,
                        int64_t ncol) {
  parallel_for(nlev, [=](int64_t lo, int64_t hi) {
    transpose_block(src, dst, nlev, ncol, lo, hi);
  });
}

// (ncol, nlev, ntr) -> (nlev, ntr, ncol)
void pack_tracers(const double* src, double* dst, int64_t ncol, int64_t nlev,
                  int64_t ntr) {
  parallel_for(ncol, [=](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      const double* s = src + c * nlev * ntr;
      for (int64_t k = 0; k < nlev; ++k) {
        for (int64_t t = 0; t < ntr; ++t) {
          dst[(k * ntr + t) * ncol + c] = s[k * ntr + t];
        }
      }
    }
  });
}

// float32 host data widened to float64 while packing.
void pack_tracers_f32(const float* src, double* dst, int64_t ncol,
                      int64_t nlev, int64_t ntr) {
  parallel_for(ncol, [=](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      const float* s = src + c * nlev * ntr;
      for (int64_t k = 0; k < nlev; ++k) {
        for (int64_t t = 0; t < ntr; ++t) {
          dst[(k * ntr + t) * ncol + c] = static_cast<double>(s[k * ntr + t]);
        }
      }
    }
  });
}

// (nlev, ntr, ncol) -> (ncol, nlev, ntr)
void unpack_tracers(const double* src, double* dst, int64_t nlev, int64_t ntr,
                    int64_t ncol) {
  parallel_for(ncol, [=](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      double* d = dst + c * nlev * ntr;
      for (int64_t k = 0; k < nlev; ++k) {
        for (int64_t t = 0; t < ntr; ++t) {
          d[k * ntr + t] = src[(k * ntr + t) * ncol + c];
        }
      }
    }
  });
}

// Replace non-finite entries with fill; returns the number replaced.
int64_t scrub_nonfinite(double* data, int64_t n, double fill) {
  std::atomic<int64_t> count{0};
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    int64_t local = 0;
    for (int64_t i = lo; i < hi; ++i) {
      if (!std::isfinite(data[i])) {
        data[i] = fill;
        ++local;
      }
    }
    count += local;
  });
  return count.load();
}

}  // extern "C"
