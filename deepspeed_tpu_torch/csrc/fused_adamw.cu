// Fused AdamW: one in-place elementwise pass over fp32 p, g, m and v.
//
// Replaces: deepspeed_tpu/ops/fused_optimizer.py:_adamw_kernel (via
// fused_adamw_flat).  Training runs it once per parameter leaf per
// optimizer step (one launch per leaf, no pointer table: a leaf of the
// 7B-width model is 16 M to 131 M elements, so a launch is far longer
// than its overhead).
//
// Math, optax.adamw as the TPU kernel writes it (eps_root = 0, decay on
// every leaf):
//   m = b1 m + (1 - b1) g             v = b2 v + (1 - b2) g^2
//   p -= lr ((m / (1 - b1^step)) / (sqrt(v / (1 - b2^step)) + eps) + wd p)
// with step the 1-based update count and the bias corrections taken in
// fp32 by powf, as the TPU kernel's jnp.power does.
//
// Layout: four contiguous fp32 buffers of n elements, 16-byte aligned.
// A grid-stride loop moves one float4 of each buffer per thread and
// iteration (16-byte loads and stores); the last n % 4 elements are a
// scalar tail.
//
// Bound on the H100: bytes, 28 B per element (p, g, m, v read; p, m, v
// written) at 3.35 TB/s; the ~15 flops per element are far below the
// ridge.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks of 256 per SM: full occupancy

struct AdamW {
  float lr, b1, b2, eps, wd, bc1, bc2;

  __device__ void operator()(float& p, float g, float& m, float& v) const {
    m = b1 * m + (1.f - b1) * g;
    v = b2 * v + (1.f - b2) * g * g;
    const float update = (m / bc1) / (sqrtf(v / bc2) + eps) + wd * p;
    p = p - lr * update;
  }
};

__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(float* __restrict__ p, const float* __restrict__ g,
                   float* __restrict__ m, float* __restrict__ v, long long n,
                   float lr, float b1, float b2, float eps, float wd,
                   int step) {
  const AdamW op{lr, b1, b2, eps, wd,
                 1.f - powf(b1, static_cast<float>(step)),
                 1.f - powf(b2, static_cast<float>(step))};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n4 = n / 4;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = first; i < n4; i += stride) {
    float4 pp = p4[i], mm = m4[i], vv = v4[i];
    const float4 gg = g4[i];
    op(pp.x, gg.x, mm.x, vv.x);
    op(pp.y, gg.y, mm.y, vv.y);
    op(pp.z, gg.z, mm.z, vv.z);
    op(pp.w, gg.w, mm.w, vv.w);
    p4[i] = pp;
    m4[i] = mm;
    v4[i] = vv;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) op(p[i], g[i], m[i], v[i]);
}

}  // namespace

// step: the 1-based update count.
DS_EXPORT int fused_adamw_f32(void* p, const void* g, void* m, void* v,
                              long long n, float lr, float b1, float b2,
                              float eps, float wd, int step, void* stream) {
  const long long n4 = (n + 3) / 4;
  const long long want = (n4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  fused_adamw_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), n, lr, b1, b2, eps, wd,
      step);
  return static_cast<int>(cudaGetLastError());
}
