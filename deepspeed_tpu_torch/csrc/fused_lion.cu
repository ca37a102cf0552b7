// Fused Lion: one in-place elementwise pass over p, g and m.
//
// Replaces: deepspeed_tpu/ops/fused_optimizer.py:_lion_kernel (via
// fused_lion_flat).  Training with optimizer "lion" / "fusedlion" runs
// it once per parameter leaf per optimizer step.
//
// Math, optax.lion as the TPU kernel writes it (decoupled decay):
//   u = sign(b1 m + (1 - b1) g)        sign(0) = 0
//   p -= lr (u + wd p)
//   m = b2 m + (1 - b2) g
// Every product and sum is written with the _rn intrinsics, so nvcc
// contracts nothing into a fused multiply-add: the sign's argument near
// zero, and with it every p and m, is bit-equal to the plain version's
// separately rounded fp32 operations.
//
// Types: a template over p's and g's types, each fp32 or bf16, over an
// fp32 m, as fused_adamw.cu: fp32 arithmetic, p rounded once when
// written (round to nearest even, as the plain version's cast), so a
// bf16 instance is bit-equal to its plain version too.  fused_lion_f32
// is the all-fp32 instance; the others are fused_lion_<p>_<g>.
//
// Layout: three contiguous buffers of n elements, 16-byte aligned.  A
// grid-stride loop moves four elements of each buffer per thread and
// iteration; the last n % 4 elements are a scalar tail.
//
// Bound on the H100: bytes, 20 B per element in fp32 (p, g, m read; p,
// m written), 16 B with bf16 p, at 3.35 TB/s; ~10
// flops per element.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks of 256 per SM: full occupancy

struct Lion {
  float lr, b1, b2, wd, c1, c2;   // c = 1 - b, in fp32

  __device__ void operator()(float& p, float g, float& m) const {
    const float arg = __fadd_rn(__fmul_rn(b1, m), __fmul_rn(c1, g));
    const float u = arg > 0.f ? 1.f : (arg < 0.f ? -1.f : 0.f);
    p = __fsub_rn(p, __fmul_rn(lr, __fadd_rn(u, __fmul_rn(wd, p))));
    m = __fadd_rn(__fmul_rn(b2, m), __fmul_rn(c2, g));
  }
};

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
fused_lion_kernel(TP* __restrict__ p, const TG* __restrict__ g,
                  float* __restrict__ m, long long n, float lr, float b1,
                  float b2, float wd) {
  const Lion op{lr, b1, b2, wd, 1.f - b1, 1.f - b2};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n4 = n / 4;
  for (long long i = first; i < n4; i += stride) {
    float pp[4], gg[4], mm[4];
    ds_load4(p, i, pp);
    ds_load4(g, i, gg);
    ds_load4(m, i, mm);
#pragma unroll
    for (int k = 0; k < 4; ++k) op(pp[k], gg[k], mm[k]);
    ds_store4(p, i, pp);
    ds_store4(m, i, mm);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float pp = ds_load1(p, i), mm = ds_load1(m, i);
    op(pp, ds_load1(g, i), mm);
    ds_store1(p, i, pp);
    ds_store1(m, i, mm);
  }
}

template <typename TP, typename TG>
int launch(void* p, const void* g, void* m, long long n, float lr, float b1,
           float b2, float wd, void* stream) {
  const long long n4 = (n + 3) / 4;
  const long long want = (n4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  fused_lion_kernel<TP, TG>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<TP*>(p), static_cast<const TG*>(g),
          static_cast<float*>(m), n, lr, b1, b2, wd);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DS_LION_ENTRY(NAME, TP, TG)                                          \
  DS_EXPORT int NAME(void* p, const void* g, void* m, long long n, float lr, \
                     float b1, float b2, float wd, void* stream) {           \
    return launch<TP, TG>(p, g, m, n, lr, b1, b2, wd, stream);               \
  }

using bf16 = __nv_bfloat16;
DS_LION_ENTRY(fused_lion_f32, float, float)
DS_LION_ENTRY(fused_lion_f32_bf16, float, bf16)
DS_LION_ENTRY(fused_lion_bf16_f32, bf16, float)
DS_LION_ENTRY(fused_lion_bf16_bf16, bf16, bf16)
