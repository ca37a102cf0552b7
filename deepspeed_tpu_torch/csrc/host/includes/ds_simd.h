// SIMD helpers for host-side optimizer kernels.
//
// TPU-native analogue of the reference's csrc/includes/simd.h (AVX512/AVX256
// wrappers used by cpu_adam/cpu_lion/cpu_adagrad). The offload path runs the
// optimizer step on the host CPU while the TPU computes the next micro-batch,
// so the host step must keep up with HBM->host gradient streaming: that means
// vectorized FMA over contiguous fp32 shards plus multi-threaded chunking
// (see ds_threading.h).
#pragma once

#include <cstddef>
#include <cmath>

#if defined(__AVX2__)
#include <immintrin.h>
#define DS_SIMD_WIDTH 8

namespace ds {
struct vecf {
  __m256 v;
  static inline vecf load(const float* p) { return {_mm256_loadu_ps(p)}; }
  static inline vecf set1(float x) { return {_mm256_set1_ps(x)}; }
  inline void store(float* p) const { _mm256_storeu_ps(p, v); }
  inline vecf operator+(const vecf& o) const { return {_mm256_add_ps(v, o.v)}; }
  inline vecf operator-(const vecf& o) const { return {_mm256_sub_ps(v, o.v)}; }
  inline vecf operator*(const vecf& o) const { return {_mm256_mul_ps(v, o.v)}; }
  inline vecf operator/(const vecf& o) const { return {_mm256_div_ps(v, o.v)}; }
};
// a*b + c
static inline vecf fma(const vecf& a, const vecf& b, const vecf& c) {
  return {_mm256_fmadd_ps(a.v, b.v, c.v)};
}
static inline vecf sqrt(const vecf& a) { return {_mm256_sqrt_ps(a.v)}; }
// sign(a): +1.0f / -1.0f / 0.0f
static inline vecf sign(const vecf& a) {
  __m256 zero = _mm256_setzero_ps();
  __m256 pos = _mm256_and_ps(_mm256_cmp_ps(a.v, zero, _CMP_GT_OQ),
                             _mm256_set1_ps(1.0f));
  __m256 neg = _mm256_and_ps(_mm256_cmp_ps(a.v, zero, _CMP_LT_OQ),
                             _mm256_set1_ps(-1.0f));
  return {_mm256_add_ps(pos, neg)};
}
}  // namespace ds

#else  // scalar fallback (portable; also what non-x86 hosts get)
#define DS_SIMD_WIDTH 1

namespace ds {
struct vecf {
  float v;
  static inline vecf load(const float* p) { return {*p}; }
  static inline vecf set1(float x) { return {x}; }
  inline void store(float* p) const { *p = v; }
  inline vecf operator+(const vecf& o) const { return {v + o.v}; }
  inline vecf operator-(const vecf& o) const { return {v - o.v}; }
  inline vecf operator*(const vecf& o) const { return {v * o.v}; }
  inline vecf operator/(const vecf& o) const { return {v / o.v}; }
};
static inline vecf fma(const vecf& a, const vecf& b, const vecf& c) {
  return {a.v * b.v + c.v};
}
static inline vecf sqrt(const vecf& a) { return {std::sqrt(a.v)}; }
static inline vecf sign(const vecf& a) {
  return {a.v > 0.0f ? 1.0f : (a.v < 0.0f ? -1.0f : 0.0f)};
}
}  // namespace ds
#endif
