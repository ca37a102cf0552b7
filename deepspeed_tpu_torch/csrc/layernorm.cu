// LayerNorm: y = (x - mean) * rsqrt(var + eps) * w + b with
// var = mean((x - mean)^2), moments in fp32, cast back to bf16.
//
// Replaces: deepspeed_tpu/ops/normalization.py:_layernorm_kernel (via
// layernorm / _row_call).  Serving a LayerNorm family (OPT, GPT-2, BLOOM,
// GPT-NeoX, Falcon, Phi) runs it twice per layer plus the final norm on
// every step, and once more on the embeddings where the family norms
// them.
//
// Layout: x, out [N, E] bf16 contiguous, w and b [E] fp32 (the JAX
// package keeps norm scales and biases in fp32).  E % 8 == 0 and
// E <= 8192.
//
// Grid: one block per row.  The serving decode step gives the kernel
// 1-16 rows, so a launch is one round trip to memory per block and the
// block's two reductions; the design shortens that chain.  Each thread
// issues all its loads at once -- its 16-byte chunks of the row and the
// fp32 scale and bias of the same columns -- before the first wait, so
// their latency hides behind the row's instead of following both
// reductions.  The row stays in registers as bf16 (the conversion to
// fp32 is exact, so each pass converts again instead of holding 32 more
// registers).  The variance is the two-pass form on those registers, not
// E[x^2] - mean^2: rows with a mean far above their spread (embeddings
// plus positions) would lose every digit to cancellation.  Two block
// reductions per row, then the same registers are centred, scaled,
// shifted and stored -- x is read once and y written once.  256 threads
// a row (PERF.md keeps the times of 64-512); chunks per thread are
// picked per E at launch.
//
// Bound on the H100: bytes, 2 * N * E * 2 B + 2 * E * 4 B at 3.35 TB/s;
// the arithmetic is a few flops per element.  At decode sizes (N = 16)
// the launch and one memory round trip, not the bytes, set the time.

#include "common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxChunks = 4;  // 16-byte chunks per thread: E <= 8192

template <int CHUNKS>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ w,
                 const float* __restrict__ b, __nv_bfloat16* __restrict__ out,
                 int E, float eps) {
  const int row = blockIdx.x;
  const int n_chunks = E / 8;
  const uint4* xr = reinterpret_cast<const uint4*>(x + static_cast<size_t>(row) * E);
  uint4* yr = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * E);
  __shared__ float scratch[kThreads / 32];

  uint4 xs[CHUNKS];
  float ws[CHUNKS][8], bs[CHUNKS][8];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      xs[i] = xr[c];
      ds_load_float8(w, c, ws[i]);
      ds_load_float8(b, c, bs[i]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if (threadIdx.x + i * kThreads < n_chunks) {
      float f[8];
      ds_bf16x8_to_float(xs[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += f[j];
    }
  }
  const float mean =
      ds_block_sum<kThreads>(sum, scratch) / static_cast<float>(E);

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    if (threadIdx.x + i * kThreads < n_chunks) {
      float f[8];
      ds_bf16x8_to_float(xs[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = f[j] - mean;
        ss = fmaf(d, d, ss);
      }
    }
  }
  const float var =
      ds_block_sum<kThreads>(ss, scratch) / static_cast<float>(E);
  const float inv = rsqrtf(var + eps);

#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (c < n_chunks) {
      float f[8];
      ds_bf16x8_to_float(xs[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = (f[j] - mean) * inv * ws[i][j] + bs[i][j];
      yr[c] = ds_float8_to_bf16(f);
    }
  }
}

DS_EXPORT int layernorm_bf16(const void* x, const void* w, const void* b,
                             void* out, int N, int E, float eps, void* stream) {
  ds_with_pow2<kMaxChunks>((E / 8 + kThreads - 1) / kThreads,
                           [&](auto chunks) {
    layernorm_kernel<decltype(chunks)::value>
        <<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(w),
            static_cast<const float*>(b), static_cast<__nv_bfloat16*>(out), E,
            eps);
  });
  return static_cast<int>(cudaGetLastError());
}
