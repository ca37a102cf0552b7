// RMSNorm: y = x * rsqrt(mean(x^2) + eps) * w, moments in fp32, cast
// back to bf16; and its fused residual-add form.
//
// Replaces: deepspeed_tpu/ops/normalization.py:_rmsnorm_kernel and
// _rmsnorm_res_kernel (via rmsnorm / _row_call).  Serving an RMSNorm
// family runs rmsnorm_bf16 twice per layer plus the final norm on every
// step.  rmsnorm_res_bf16 is the op entry point rmsnorm(x, w, eps,
// residual=r): as in the JAX package, no model path calls it.
//
// Layout: x, res, out, res_out [N, E] bf16 contiguous, w [E] fp32 (the
// JAX package keeps norm scales in fp32).  E % 8 == 0 and E <= 8192.
//
// Grid: one block per row.  The serving decode step gives the kernel
// 1-16 rows, so a launch is one round trip to memory per block and the
// block's reduction; the design shortens that chain.  Each thread issues
// all its loads at once -- its 16-byte chunks of the row and the fp32
// scale of the same columns -- before the first wait, so the scale's
// latency hides behind the row's instead of following the reduction.
// The row stays in registers, the fp32 sum of squares reduces through
// warp shuffles and shared memory, and the same registers are scaled
// and stored: x is read once and y written once.  256 threads a row
// (PERF.md keeps the times of 64-512); chunks per thread are picked per
// E at launch (a power of two), so no register holds a chunk the row
// does not have.
//
// The residual form (the same 256 threads a row, the scale read after
// the reduction) adds x + res in fp32, stores the sum rounded to
// bf16 as the new residual, and takes the moment and the output from
// the UNROUNDED fp32 sum it keeps in registers.
//
// Bound on the H100: bytes, 2 * N * E * 2 B + E * 4 B at 3.35 TB/s
// (4 * N * E * 2 B + E * 4 B with the residual: two reads, two writes);
// the arithmetic is a few flops per element.  At decode sizes (N = 8)
// the launch and one memory round trip, not the bytes, set the time.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxChunks = 4;  // 16-byte chunks per thread: E <= 8192

template <int CHUNKS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
               __nv_bfloat16* __restrict__ out, int E, float eps) {
  const int row = blockIdx.x;
  const int n_chunks = E / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * E);
  uint4* yr = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * E);
  __shared__ float scratch[kThreads / 32];

  uint4 xs[CHUNKS];
  float ws[CHUNKS][8];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      xs[i] = xr[c];
      ds_load_float8(w, c, ws[i]);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if (threadIdx.x + i * kThreads < n_chunks) {
      float f[8];
      ds_bf16x8_to_float(xs[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss = fmaf(f[j], f[j], ss);
    }
  }
  const float inv = rsqrtf(
      ds_block_sum<kThreads>(ss, scratch) / static_cast<float>(E) + eps);

#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      float f[8];
      ds_bf16x8_to_float(xs[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = f[j] * inv * ws[i][j];
      yr[c] = ds_float8_to_bf16(f);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_res_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ res,
                   const float* __restrict__ w, __nv_bfloat16* __restrict__ out,
                   __nv_bfloat16* __restrict__ res_out, int E, float eps) {
  const size_t row = static_cast<size_t>(blockIdx.x) * E;
  const int n_chunks = E / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row);
  const uint4* rr = reinterpret_cast<const uint4*>(res + row);
  uint4* yr = reinterpret_cast<uint4*>(out + row);
  uint4* sr = reinterpret_cast<uint4*>(res_out + row);
  __shared__ float scratch[kThreads / 32];

  float s[kMaxChunks][8];  // x + res, fp32, never rounded
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      float r[8];
      ds_bf16x8_to_float(xr[c], s[i]);
      ds_bf16x8_to_float(rr[c], r);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] += r[j];
        ss = fmaf(s[i][j], s[i][j], ss);
      }
      sr[c] = ds_float8_to_bf16(s[i]);
    }
  }
  const float inv = rsqrtf(
      ds_block_sum<kThreads>(ss, scratch) / static_cast<float>(E) + eps);

#pragma unroll
  for (int i = 0; i < kMaxChunks; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      float ws[8], y[8];
      ds_load_float8(w, c, ws);
#pragma unroll
      for (int j = 0; j < 8; ++j) y[j] = s[i][j] * inv * ws[j];
      yr[c] = ds_float8_to_bf16(y);
    }
  }
}

DS_EXPORT int rmsnorm_bf16(const void* x, const void* w, void* out, int N,
                           int E, float eps, void* stream) {
  ds_with_pow2<kMaxChunks>((E / 8 + kThreads - 1) / kThreads,
                           [&](auto chunks) {
    rmsnorm_kernel<decltype(chunks)::value>
        <<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
            static_cast<__nv_bfloat16*>(out), E, eps);
  });
  return static_cast<int>(cudaGetLastError());
}

// out and res_out are distinct from x and res (the wrapper allocates
// them): the kernel's pointers are __restrict__.
DS_EXPORT int rmsnorm_res_bf16(const void* x, const void* res, const void* w,
                               void* out, void* res_out, int N, int E,
                               float eps, void* stream) {
  rmsnorm_res_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(res),
      static_cast<const float*>(w), static_cast<__nv_bfloat16*>(out),
      static_cast<__nv_bfloat16*>(res_out), E, eps);
  return static_cast<int>(cudaGetLastError());
}
