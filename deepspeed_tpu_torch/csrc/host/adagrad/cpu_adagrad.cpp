// Host Adagrad step (reference csrc/adagrad/cpu_adagrad.cpp) for offloaded
// optimizer state. In-place over contiguous fp32 shards; C ABI for ctypes.

#include <cstdint>

#include "../includes/ds_simd.h"
#include "../includes/ds_threading.h"

extern "C" {

void ds_cpu_adagrad_step(float* params, float* grads, float* exp_avg_sq,
                         int64_t n, float lr, float eps, float weight_decay) {
  ds::parallel_for(
      static_cast<size_t>(n), DS_SIMD_WIDTH, [&](size_t begin, size_t end) {
        ds::vecf vlr = ds::vecf::set1(-lr);
        ds::vecf veps = ds::vecf::set1(eps);
        ds::vecf vwd = ds::vecf::set1(weight_decay);
        size_t i = begin;
        const size_t vend =
            begin + ((end - begin) / DS_SIMD_WIDTH) * DS_SIMD_WIDTH;
        for (; i < vend; i += DS_SIMD_WIDTH) {
          ds::vecf grad = ds::vecf::load(grads + i);
          ds::vecf param = ds::vecf::load(params + i);
          if (weight_decay != 0.0f) grad = ds::fma(param, vwd, grad);
          ds::vecf var = ds::fma(grad, grad, ds::vecf::load(exp_avg_sq + i));
          param = param + (vlr * grad) / (ds::sqrt(var) + veps);
          var.store(exp_avg_sq + i);
          param.store(params + i);
        }
        for (; i < end; ++i) {
          float grad = grads[i];
          if (weight_decay != 0.0f) grad += params[i] * weight_decay;
          exp_avg_sq[i] += grad * grad;
          params[i] -= lr * grad / (std::sqrt(exp_avg_sq[i]) + eps);
        }
      });
}

}  // extern "C"
