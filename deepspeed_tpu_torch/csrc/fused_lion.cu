// Fused Lion: one in-place elementwise pass over fp32 p, g and m.
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
// Layout: three contiguous fp32 buffers of n elements, 16-byte aligned.
// A grid-stride loop moves one float4 of each buffer per thread and
// iteration; the last n % 4 elements are a scalar tail.
//
// Bound on the H100: bytes, 20 B per element (p, g, m read; p, m
// written) at 3.35 TB/s; ~10 flops per element.

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

__global__ void __launch_bounds__(kThreads)
fused_lion_kernel(float* __restrict__ p, const float* __restrict__ g,
                  float* __restrict__ m, long long n, float lr, float b1,
                  float b2, float wd) {
  const Lion op{lr, b1, b2, wd, 1.f - b1, 1.f - b2};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  for (long long i = first; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i];
    const float4 gg = g4[i];
    op(pp.x, gg.x, mm.x);
    op(pp.y, gg.y, mm.y);
    op(pp.z, gg.z, mm.z);
    op(pp.w, gg.w, mm.w);
    p4[i] = pp;
    m4[i] = mm;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) op(p[i], g[i], m[i]);
}

}  // namespace

DS_EXPORT int fused_lion_f32(void* p, const void* g, void* m, long long n,
                             float lr, float b1, float b2, float wd,
                             void* stream) {
  const long long n4 = (n + 3) / 4;
  const long long want = (n4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  fused_lion_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), n, lr, b1, b2, wd);
  return static_cast<int>(cudaGetLastError());
}
