// Fused LAMB, stage 1: moments, the Adam-style update and the partial
// squared norms of p and of the update, in one elementwise pass.
//
// Replaces: deepspeed_tpu/ops/fused_optimizer.py:_lamb_stage1_kernel
// (via fused_lamb_flat).  Training with optimizer "lamb" / "fusedlamb"
// runs it once per parameter leaf per optimizer step.  The per-tensor
// trust ratio ||p|| / ||u|| and the axpy p -= lr * ratio * u stay outside
// the kernel, as in the JAX package (torch ops on device tensors).
//
// Math, optax.lamb's update before the trust ratio (eps_root = 0, decay
// on every leaf), as the TPU kernel writes it:
//   m = b1 m + (1 - b1) g             v = b2 v + (1 - b2) g^2
//   u = (m / (1 - b1^step)) / (sqrt(v / (1 - b2^step)) + eps) + wd p
// with step the 1-based update count and the bias corrections taken in
// fp32 by powf, as fused_adamw.cu does.
//
// Types: a template over p's and g's types, each fp32 or bf16, over fp32
// moments, as fused_adamw.cu: fp32 arithmetic; u and the partial norms
// stay fp32 (the trust ratio's inputs).  fused_lamb_stage1_f32 is the
// all-fp32 instance; the others are fused_lamb_stage1_<p>_<g>.
//
// Layout: p, g read; m, v updated in place; u written (fp32); all
// contiguous buffers of n elements, 16-byte aligned.  norms is fp32
// [nblocks, 2]: block b's sums of p^2 and u^2.  The grid is nblocks CTAs
// (the wrapper fixes it from n alone), each grid-striding over float4s
// and summing its squares in fp64 registers, then through shuffles and
// shared memory, so the partials are deterministic and need no atomics.
//
// Bound on the H100: bytes, 28 B per element in fp32 (p, g, m, v read;
// u, m, v written), 26 B with bf16 p, at 3.35 TB/s;
// ~20 flops per element.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct LambStage1 {
  float b1, b2, eps, wd, bc1, bc2;

  // returns u; updates m and v
  __device__ float operator()(float p, float g, float& m, float& v) const {
    m = b1 * m + (1.f - b1) * g;
    v = b2 * v + (1.f - b2) * g * g;
    return (m / bc1) / (sqrtf(v / bc2) + eps) + wd * p;
  }
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
fused_lamb_stage1_kernel(const TP* __restrict__ p, const TG* __restrict__ g,
                         float* __restrict__ m, float* __restrict__ v,
                         float* __restrict__ u, float* __restrict__ norms,
                         long long n, float b1, float b2, float eps, float wd,
                         int step) {
  const LambStage1 op{b1, b2, eps, wd,
                      1.f - powf(b1, static_cast<float>(step)),
                      1.f - powf(b2, static_cast<float>(step))};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n4 = n / 4;
  double pp = 0.0, uu = 0.0;
  for (long long i = first; i < n4; i += stride) {
    float x[4], gg[4], mm[4], vv[4], out[4];
    ds_load4(p, i, x);
    ds_load4(g, i, gg);
    ds_load4(m, i, mm);
    ds_load4(v, i, vv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      out[k] = op(x[k], gg[k], mm[k], vv[k]);
      pp += static_cast<double>(x[k]) * x[k];
      uu += static_cast<double>(out[k]) * out[k];
    }
    ds_store4(m, i, mm);
    ds_store4(v, i, vv);
    ds_store4(u, i, out);
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    const float x = ds_load1(p, i);
    float mm = ds_load1(m, i), vv = ds_load1(v, i);
    const float out = op(x, ds_load1(g, i), mm, vv);
    ds_store1(m, i, mm);
    ds_store1(v, i, vv);
    u[i] = out;
    pp += static_cast<double>(x) * x;
    uu += static_cast<double>(out) * out;
  }

  __shared__ double scratch[2][kThreads / 32];
  pp = warp_sum(pp);
  uu = warp_sum(uu);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    scratch[0][warp] = pp;
    scratch[1][warp] = uu;
  }
  __syncthreads();
  if (warp == 0) {
    pp = warp_sum(lane < kThreads / 32 ? scratch[0][lane] : 0.0);
    uu = warp_sum(lane < kThreads / 32 ? scratch[1][lane] : 0.0);
    if (lane == 0) {
      norms[2 * blockIdx.x] = static_cast<float>(pp);
      norms[2 * blockIdx.x + 1] = static_cast<float>(uu);
    }
  }
}

template <typename TP, typename TG>
int launch(const void* p, const void* g, void* m, void* v, void* u,
           void* norms, long long n, int nblocks, float b1, float b2,
           float eps, float wd, int step, void* stream) {
  fused_lamb_stage1_kernel<TP, TG>
      <<<nblocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const TP*>(p), static_cast<const TG*>(g),
          static_cast<float*>(m), static_cast<float*>(v),
          static_cast<float*>(u), static_cast<float*>(norms), n, b1, b2, eps,
          wd, step);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// nblocks: the grid, and the rows of norms [nblocks, 2].  step: the
// 1-based update count.
#define DS_LAMB_ENTRY(NAME, TP, TG)                                           \
  DS_EXPORT int NAME(const void* p, const void* g, void* m, void* v, void* u, \
                     void* norms, long long n, int nblocks, float b1,         \
                     float b2, float eps, float wd, int step, void* stream) { \
    return launch<TP, TG>(p, g, m, v, u, norms, n, nblocks, b1, b2, eps, wd,  \
                          step, stream);                                      \
  }

using bf16 = __nv_bfloat16;
DS_LAMB_ENTRY(fused_lamb_stage1_f32, float, float)
DS_LAMB_ENTRY(fused_lamb_stage1_f32_bf16, float, bf16)
DS_LAMB_ENTRY(fused_lamb_stage1_bf16_f32, bf16, float)
DS_LAMB_ENTRY(fused_lamb_stage1_bf16_bf16, bf16, bf16)
