// Fused AdamW: one in-place elementwise pass over p, g, m and v.
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
// Types: the kernel is a template over p's and g's types, each fp32 or
// bf16, over fp32 moments (the TPU kernel takes any dtype for p and g;
// pure bf16 training keeps bf16 p over fp32 moments, as the JAX
// engine's optax state).  Every operand is read as fp32, the arithmetic
// is fp32, and p is rounded once when written.  fused_adamw_f32 is the
// all-fp32 instance; the others are fused_adamw_<p>_<g>, each f32 or
// bf16.
//
// Layout: four contiguous buffers of n elements, 16-byte aligned.  A
// grid-stride loop moves four elements of each buffer per thread and
// iteration (one 16-byte fp32 or 8-byte bf16 access); the last n % 4
// elements are a scalar tail.
//
// Bound on the H100: bytes, 28 B per element in fp32 (p, g, m, v read;
// p, m, v written), 24 B with bf16 p, at 3.35 TB/s;
// the ~15 flops per element are far below the ridge.

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

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(TP* __restrict__ p, const TG* __restrict__ g,
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
  for (long long i = first; i < n4; i += stride) {
    float pp[4], gg[4], mm[4], vv[4];
    ds_load4(p, i, pp);
    ds_load4(g, i, gg);
    ds_load4(m, i, mm);
    ds_load4(v, i, vv);
#pragma unroll
    for (int k = 0; k < 4; ++k) op(pp[k], gg[k], mm[k], vv[k]);
    ds_store4(p, i, pp);
    ds_store4(m, i, mm);
    ds_store4(v, i, vv);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    float pp = ds_load1(p, i), mm = ds_load1(m, i), vv = ds_load1(v, i);
    op(pp, ds_load1(g, i), mm, vv);
    ds_store1(p, i, pp);
    ds_store1(m, i, mm);
    ds_store1(v, i, vv);
  }
}

template <typename TP, typename TG>
int launch(void* p, const void* g, void* m, void* v, long long n, float lr,
           float b1, float b2, float eps, float wd, int step, void* stream) {
  const long long n4 = (n + 3) / 4;
  const long long want = (n4 + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  fused_adamw_kernel<TP, TG>
      <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<TP*>(p), static_cast<const TG*>(g),
          static_cast<float*>(m), static_cast<float*>(v), n, lr, b1, b2, eps,
          wd, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// step: the 1-based update count.
#define DS_ADAMW_ENTRY(NAME, TP, TG)                                         \
  DS_EXPORT int NAME(void* p, const void* g, void* m, void* v, long long n, \
                     float lr, float b1, float b2, float eps, float wd,     \
                     int step, void* stream) {                              \
    return launch<TP, TG>(p, g, m, v, n, lr, b1, b2, eps, wd, step,         \
                          stream);                                          \
  }

using bf16 = __nv_bfloat16;
DS_ADAMW_ENTRY(fused_adamw_f32, float, float)
DS_ADAMW_ENTRY(fused_adamw_f32_bf16, float, bf16)
DS_ADAMW_ENTRY(fused_adamw_bf16_f32, bf16, float)
DS_ADAMW_ENTRY(fused_adamw_bf16_bf16, bf16, bf16)
