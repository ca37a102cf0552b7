// Host Lion step (reference csrc/lion/) for offloaded optimizer state.
// update = sign(beta1*m + (1-beta1)*g); m = beta2*m + (1-beta2)*g
// In-place over contiguous fp32 shards; C ABI for ctypes.

#include <cstdint>

#include "../includes/ds_simd.h"
#include "../includes/ds_threading.h"

extern "C" {

void ds_cpu_lion_step(float* params, float* grads, float* exp_avg, int64_t n,
                      float lr, float beta1, float beta2, float weight_decay) {
  ds::parallel_for(
      static_cast<size_t>(n), DS_SIMD_WIDTH, [&](size_t begin, size_t end) {
        ds::vecf vb1 = ds::vecf::set1(beta1);
        ds::vecf vb1m = ds::vecf::set1(1.0f - beta1);
        ds::vecf vb2 = ds::vecf::set1(beta2);
        ds::vecf vb2m = ds::vecf::set1(1.0f - beta2);
        ds::vecf vlr = ds::vecf::set1(-lr);
        ds::vecf vdecay = ds::vecf::set1(1.0f - lr * weight_decay);
        size_t i = begin;
        const size_t vend =
            begin + ((end - begin) / DS_SIMD_WIDTH) * DS_SIMD_WIDTH;
        for (; i < vend; i += DS_SIMD_WIDTH) {
          ds::vecf grad = ds::vecf::load(grads + i);
          ds::vecf mom = ds::vecf::load(exp_avg + i);
          ds::vecf param = ds::vecf::load(params + i);
          ds::vecf update = ds::sign(ds::fma(vb1, mom, vb1m * grad));
          if (weight_decay != 0.0f) param = param * vdecay;
          param = ds::fma(vlr, update, param);
          mom = ds::fma(vb2, mom, vb2m * grad);
          mom.store(exp_avg + i);
          param.store(params + i);
        }
        for (; i < end; ++i) {
          float grad = grads[i];
          float mom = exp_avg[i];
          float u = beta1 * mom + (1.0f - beta1) * grad;
          float update = u > 0.0f ? 1.0f : (u < 0.0f ? -1.0f : 0.0f);
          float param = params[i];
          if (weight_decay != 0.0f) param *= (1.0f - lr * weight_decay);
          params[i] = param - lr * update;
          exp_avg[i] = beta2 * mom + (1.0f - beta2) * grad;
        }
      });
}

}  // extern "C"
