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
// Layout: p, g read; m, v updated in place; u written; all contiguous
// fp32 buffers of n elements, 16-byte aligned.  norms is fp32
// [nblocks, 2]: block b's sums of p^2 and u^2.  The grid is nblocks CTAs
// (the wrapper fixes it from n alone), each grid-striding over float4s
// and summing its squares in fp64 registers, then through shuffles and
// shared memory, so the partials are deterministic and need no atomics.
//
// Bound on the H100: bytes, 28 B per element (p, g, m, v read; u, m, v
// written) at 3.35 TB/s; ~20 flops per element.

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

__global__ void __launch_bounds__(kThreads)
fused_lamb_stage1_kernel(const float* __restrict__ p,
                         const float* __restrict__ g, float* __restrict__ m,
                         float* __restrict__ v, float* __restrict__ u,
                         float* __restrict__ norms, long long n, float b1,
                         float b2, float eps, float wd, int step) {
  const LambStage1 op{b1, b2, eps, wd,
                      1.f - powf(b1, static_cast<float>(step)),
                      1.f - powf(b2, static_cast<float>(step))};
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long n4 = n / 4;
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  float4* u4 = reinterpret_cast<float4*>(u);
  double pp = 0.0, uu = 0.0;
  for (long long i = first; i < n4; i += stride) {
    const float4 x = p4[i], gg = g4[i];
    float4 mm = m4[i], vv = v4[i], out;
    out.x = op(x.x, gg.x, mm.x, vv.x);
    out.y = op(x.y, gg.y, mm.y, vv.y);
    out.z = op(x.z, gg.z, mm.z, vv.z);
    out.w = op(x.w, gg.w, mm.w, vv.w);
    m4[i] = mm;
    v4[i] = vv;
    u4[i] = out;
    pp += static_cast<double>(x.x) * x.x + static_cast<double>(x.y) * x.y +
          static_cast<double>(x.z) * x.z + static_cast<double>(x.w) * x.w;
    uu += static_cast<double>(out.x) * out.x +
          static_cast<double>(out.y) * out.y +
          static_cast<double>(out.z) * out.z +
          static_cast<double>(out.w) * out.w;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    const float out = op(p[i], g[i], m[i], v[i]);
    u[i] = out;
    pp += static_cast<double>(p[i]) * p[i];
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

}  // namespace

// nblocks: the grid, and the rows of norms [nblocks, 2].  step: the
// 1-based update count.
DS_EXPORT int fused_lamb_stage1_f32(const void* p, const void* g, void* m,
                                    void* v, void* u, void* norms,
                                    long long n, int nblocks, float b1,
                                    float b2, float eps, float wd, int step,
                                    void* stream) {
  fused_lamb_stage1_kernel<<<nblocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<const float*>(g),
      static_cast<float*>(m), static_cast<float*>(v), static_cast<float*>(u),
      static_cast<float*>(norms), n, b1, b2, eps, wd, step);
  return static_cast<int>(cudaGetLastError());
}
