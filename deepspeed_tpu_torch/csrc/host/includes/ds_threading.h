// Chunked parallel-for over std::thread for host optimizer steps.
//
// The reference parallelizes cpu_adam with OpenMP (#pragma omp parallel for
// in csrc/adam/cpu_adam_impl.cpp); we use a plain std::thread fan-out so the
// build has no OpenMP runtime dependency.  Chunks are cache-line aligned
// multiples of the SIMD width.
#pragma once

#include <algorithm>
#include <cstddef>
#include <functional>
#include <thread>
#include <vector>

namespace ds {

inline size_t default_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<size_t>(hw) : 4;
}

// Invoke fn(begin, end) over [0, n) in parallel chunks; chunk boundaries are
// multiples of `align` so SIMD bodies never straddle a boundary.
inline void parallel_for(size_t n, size_t align,
                         const std::function<void(size_t, size_t)>& fn,
                         size_t min_chunk = 1 << 16) {
  size_t nthreads = std::min(default_threads(),
                             std::max<size_t>(1, n / min_chunk));
  if (nthreads <= 1) {
    fn(0, n);
    return;
  }
  size_t chunk = (n + nthreads - 1) / nthreads;
  chunk = ((chunk + align - 1) / align) * align;
  std::vector<std::thread> workers;
  workers.reserve(nthreads);
  for (size_t t = 0; t < nthreads; ++t) {
    size_t begin = t * chunk;
    if (begin >= n) break;
    size_t end = std::min(n, begin + chunk);
    workers.emplace_back([&fn, begin, end] { fn(begin, end); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace ds
