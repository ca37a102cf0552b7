// Host Adam/AdamW step for the ZeRO-Offload path.
//
// TPU-native analogue of the reference csrc/adam/{cpu_adam.cpp,
// cpu_adam_impl.cpp} (AVX-vectorized DeepSpeedCPUAdam). Operates in-place on
// contiguous fp32 shards: params (fp32 master), grads, exp_avg, exp_avg_sq.
// Exposed as a C ABI for ctypes (no pybind11 in this image). bf16 "copy back"
// is handled Python-side (the device copy is jnp.asarray of the updated
// master shard cast to bf16).

#include <cstdint>
#include <cstring>

#include "../includes/ds_simd.h"
#include "../includes/ds_threading.h"

namespace {

struct AdamHyper {
  float lr;
  float beta1;
  float beta2;
  float eps;
  float weight_decay;
  int adamw_mode;  // 1: decoupled decay (AdamW); 0: L2-into-grad (Adam)
  int bias_correction;
};

inline void adam_range(float* p, float* g, float* m, float* v, size_t begin,
                       size_t end, const AdamHyper& h, float bc1, float bc2) {
  const float step_size = h.lr / bc1;
  const float bc2_sqrt = bc2;  // already sqrt'ed by caller
  ds::vecf vb1 = ds::vecf::set1(h.beta1);
  ds::vecf vb1m = ds::vecf::set1(1.0f - h.beta1);
  ds::vecf vb2 = ds::vecf::set1(h.beta2);
  ds::vecf vb2m = ds::vecf::set1(1.0f - h.beta2);
  // -step * m / (sqrt(v)/bc2 + eps)  ==  (-step*bc2) * m / (sqrt(v) + eps*bc2)
  ds::vecf veps = ds::vecf::set1(h.eps * bc2_sqrt);
  ds::vecf vstep = ds::vecf::set1(-step_size * bc2_sqrt);
  ds::vecf vwd = ds::vecf::set1(h.weight_decay);
  ds::vecf vlrwd = ds::vecf::set1(1.0f - h.lr * h.weight_decay);

  size_t i = begin;
  const size_t vec_end = begin + ((end - begin) / DS_SIMD_WIDTH) * DS_SIMD_WIDTH;
  for (; i < vec_end; i += DS_SIMD_WIDTH) {
    ds::vecf grad = ds::vecf::load(g + i);
    ds::vecf param = ds::vecf::load(p + i);
    if (!h.adamw_mode && h.weight_decay != 0.0f)
      grad = ds::fma(param, vwd, grad);
    ds::vecf mom = ds::fma(vb1, ds::vecf::load(m + i), vb1m * grad);
    ds::vecf var = ds::fma(vb2, ds::vecf::load(v + i), vb2m * (grad * grad));
    if (h.adamw_mode && h.weight_decay != 0.0f) param = param * vlrwd;
    // p += -step/bc2_sqrt * m / (sqrt(v) + eps*bc2_sqrt)
    //    == p - step * (m/bc1') / (sqrt(v)/bc2_sqrt + eps)
    param = param + (vstep * mom) / (ds::sqrt(var) + veps);
    mom.store(m + i);
    var.store(v + i);
    param.store(p + i);
  }
  for (; i < end; ++i) {
    float grad = g[i];
    if (!h.adamw_mode && h.weight_decay != 0.0f) grad += p[i] * h.weight_decay;
    m[i] = h.beta1 * m[i] + (1.0f - h.beta1) * grad;
    v[i] = h.beta2 * v[i] + (1.0f - h.beta2) * grad * grad;
    float param = p[i];
    if (h.adamw_mode && h.weight_decay != 0.0f)
      param *= (1.0f - h.lr * h.weight_decay);
    p[i] = param - step_size * m[i] / (std::sqrt(v[i]) / bc2_sqrt + h.eps);
  }
}

}  // namespace

extern "C" {

// One fused Adam(W) step over a flat shard. `step` is 1-based.
void ds_cpu_adam_step(float* params, float* grads, float* exp_avg,
                      float* exp_avg_sq, int64_t n, int64_t step, float lr,
                      float beta1, float beta2, float eps, float weight_decay,
                      int adamw_mode, int bias_correction) {
  AdamHyper h{lr, beta1, beta2, eps, weight_decay, adamw_mode, bias_correction};
  float bc1 = 1.0f, bc2 = 1.0f;
  if (bias_correction) {
    bc1 = 1.0f - std::pow(beta1, static_cast<float>(step));
    bc2 = std::sqrt(1.0f - std::pow(beta2, static_cast<float>(step)));
  }
  ds::parallel_for(static_cast<size_t>(n), DS_SIMD_WIDTH,
                   [&](size_t b, size_t e) {
                     adam_range(params, grads, exp_avg, exp_avg_sq, b, e, h,
                                bc1, bc2);
                   });
}

int ds_simd_width() { return DS_SIMD_WIDTH; }

}  // extern "C"
