// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w, moments in fp32, cast
// back to bf16.
//
// Replaces: deepspeed_tpu/ops/normalization.py:_rmsnorm_kernel (via
// rmsnorm / _row_call).  Serving runs it twice per layer plus the final
// norm on every step.
//
// Layout: x, out [N, E] bf16 contiguous, w [E] fp32 (the JAX package
// keeps norm scales in fp32).  E % 8 == 0 and E <= 8192.
//
// Grid: one block of 256 threads per row.  Each thread loads its 16-byte
// chunks of the row once (at most 4, kept in registers), the fp32 sum of
// squares reduces through warp shuffles and shared memory, and the same
// registers are scaled and stored -- x is read once and y written once.
//
// Bound on the H100: bytes, 2 * N * E * 2 B + E * 4 B at 3.35 TB/s; the
// arithmetic is a few flops per element.  At decode sizes (N = 8) the
// launch, not the bytes, sets the time.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxChunks = 4;  // 16-byte chunks per thread: E <= 8192

__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int E, float eps) {
  const int row = blockIdx.x;
  const int n_chunks = E / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * E);
  uint4* yr = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * E);

  uint4 cache[kMaxChunks];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      cache[i] = xr[c];
      float f[8];
      ds_bf16x8_to_float(cache[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }

  __shared__ float partial[kThreads / 32];
  ss = ds_warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float v = lane < kThreads / 32 ? partial[lane] : 0.f;
    v = ds_warp_sum(v);
    if (lane == 0) partial[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(partial[0] / static_cast<float>(E) + eps);

#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      float f[8];
      ds_bf16x8_to_float(cache[i], f);
      const float4 w0 = reinterpret_cast<const float4*>(w)[2 * c];
      const float4 w1 = reinterpret_cast<const float4*>(w)[2 * c + 1];
      const float ws[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      uint4 packed;
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p[j] = __floats2bfloat162_rn(f[2 * j] * inv * ws[2 * j],
                                     f[2 * j + 1] * inv * ws[2 * j + 1]);
      yr[c] = packed;
    }
  }
}

DS_EXPORT int rmsnorm_bf16(const void* x, const void* w, void* out, int N,
                           int E, float eps, void* stream) {
  rmsnorm_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
      static_cast<__nv_bfloat16*>(out), E, eps);
  return static_cast<int>(cudaGetLastError());
}
