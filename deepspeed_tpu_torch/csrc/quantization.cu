// Blockwise symmetric int8 quantisation and its inverse.
//
// Replaces: deepspeed_tpu/ops/quantization.py:_quant_kernel and
// _dequant_kernel (via quantize_blockwise / dequantize_blockwise).
// Training with ZeRO++ quantised weights (zero_quantized_weights at
// stage 3) runs both once per step on every floating master leaf of two
// or more dimensions: all but one leaf of the model, every element.
//
// Math, as JAX computes the TPU kernel, per block of 512 consecutive
// elements of the flat (row-major) leaf, zeros past its end:
//   scale = max(max|x|, 1e-12) * fp32(1 / 127)  (fp32, max first)
//   q     = clip(round_half_even(x / scale), -127, 127)
//   out   = fp32(q * scale), stored in the output type (bf16 rounds the
//           fp32 product once, as JAX's (q * s).astype(bf16) does)
// The TPU kernel writes max(...) / 127.0; XLA turns a division by a
// constant into a product with its fp32 reciprocal, and so does this
// kernel, so the scales are bit-equal to JAX's.  The codes' division is
// IEEE (no fast math, no reciprocal) and rintf rounds half to even, so
// the codes are bit-equal to the plain version's.
//
// quantize: one warp per block.  Each lane owns 16 consecutive elements
// (four 16-byte loads), the block's absmax is a shuffle reduction, and
// the lane's 16 codes leave as one 16-byte store.  The tail block of a
// leaf whose size is not a multiple of 512 reads its missing elements as
// zeros in registers (no padded copy); their codes are 0, as JAX pads.
// dequantize: one thread per 16 codes (one 16-byte load and one scale),
// 16 outputs written as 16-byte stores; the padding is never written.
//
// Layout: x fp32 [n] contiguous, 16-byte aligned; codes int8 [rows, 512]
// and scales fp32 [rows] with rows = ceil(n / 512); out fp32 or bf16 [n].
//
// Bound on the H100: bytes.  quantize reads 4 B and writes 1 B per
// element plus 4 B per block (5.008 B/element); dequantize to bf16 reads
// 1 B and writes 2 B (3.008 B/element).  A handful of flops per element
// is far below the ridge.

#include "common.cuh"

namespace {

constexpr int kBlock = 512;               // elements per quantisation block
constexpr int kPerLane = kBlock / 32;     // 16: four float4 loads per lane
constexpr int kWarps = 8;                 // blocks per CTA in quantize
constexpr int kThreads = 32 * kWarps;

__global__ void __launch_bounds__(kThreads)
quantize_blockwise_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                          float* __restrict__ s, long long n,
                          long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
  if (row >= rows) return;                // whole warps leave together
  const int lane = threadIdx.x & 31;
  const long long first = row * kBlock + lane * kPerLane;

  float v[kPerLane];
  if (first + kPerLane <= n) {
    const float4* src = reinterpret_cast<const float4*>(x + first);
#pragma unroll
    for (int j = 0; j < kPerLane / 4; ++j) {
      const float4 f = src[j];
      v[4 * j] = f.x; v[4 * j + 1] = f.y; v[4 * j + 2] = f.z; v[4 * j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = first + i < n ? x[first + i] : 0.f;
  }

  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) amax = fmaxf(amax, fabsf(v[i]));
  amax = ds_warp_max(amax);
  const float scale = fmaxf(amax, 1e-12f) * (1.f / 127.f);

  uint32_t word[kPerLane / 4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] / scale), -127.f), 127.f);
    const uint32_t byte = static_cast<uint32_t>(static_cast<int>(r)) & 0xffu;
    word[i / 4] |= byte << (8 * (i % 4));
  }
  *reinterpret_cast<uint4*>(q + first) =
      make_uint4(word[0], word[1], word[2], word[3]);
  if (lane == 0) s[row] = scale;
}

__device__ __forceinline__ void store16(float* out, const float* f) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    o[j] = make_float4(f[4 * j], f[4 * j + 1], f[4 * j + 2], f[4 * j + 3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* out, const float* f) {
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = ds_float8_to_bf16(f);
  o[1] = ds_float8_to_bf16(f + 8);
}

__device__ __forceinline__ void store1(float* out, float f) { *out = f; }

__device__ __forceinline__ void store1(__nv_bfloat16* out, float f) {
  *out = __float2bfloat16_rn(f);
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
dequantize_blockwise_kernel(const int8_t* __restrict__ q,
                            const float* __restrict__ s, Out* __restrict__ out,
                            long long n) {
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * 16;
  if (first >= n) return;
  const float scale = s[first / kBlock];  // 16 | 512: one block per thread
  const uint4 raw = *reinterpret_cast<const uint4*>(q + first);
  const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int8_t code = static_cast<int8_t>((word[i / 4] >> (8 * (i % 4))) & 0xffu);
    f[i] = static_cast<float>(code) * scale;
  }
  if (first + 16 <= n) {
    store16(out + first, f);
  } else {
    for (int i = 0; first + i < n; ++i) store1(out + first + i, f[i]);
  }
}

template <typename Out>
int dequantize(const void* q, const void* s, void* out, long long n,
               void* stream) {
  const long long threads = (n + 15) / 16;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  dequantize_blockwise_kernel<Out>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(s),
          static_cast<Out*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: n fp32 values; q: ceil(n / 512) * 512 codes; s: ceil(n / 512) scales.
DS_EXPORT int quantize_blockwise_f32(const void* x, void* q, void* s,
                                     long long n, void* stream) {
  const long long rows = (n + kBlock - 1) / kBlock;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  quantize_blockwise_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), n, rows);
  return static_cast<int>(cudaGetLastError());
}

// out: the first n values of the dequantised blocks, fp32 or bf16.
DS_EXPORT int dequantize_blockwise_f32(const void* q, const void* s, void* out,
                                       long long n, void* stream) {
  return dequantize<float>(q, s, out, n, stream);
}

DS_EXPORT int dequantize_blockwise_bf16(const void* q, const void* s,
                                        void* out, long long n, void* stream) {
  return dequantize<__nv_bfloat16>(q, s, out, n, stream);
}
