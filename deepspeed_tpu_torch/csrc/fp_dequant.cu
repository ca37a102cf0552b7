// Channelwise dequantisation of weight-only quantised leaves into bf16.
//
// Replaces no TPU kernel.  The JAX package dequantises a {"q", "scale"}
// leaf with jnp ops (models/transformer.py:_wval ->
// ops/fp_quantizer.py:dequantize_channelwise) and XLA fuses the cast and
// the scale into the consuming einsum, so no bf16 weight is written.  In
// the port the plain expression (q.float() * scale).to(bf16) writes an
// fp32 temporary and reads it back: about 19 bytes an element, which on
// Mixtral-8x7B's experts (3 x [8, 4096, 14336] codes a layer, every
// decode step) is most of the step.  This kernel is the one pass.
//
// Math, per element i of the flat codes (row-major):
//   out[i] = bf16_rn(float(q[i]) * scale[(i / inner) * C + i % C])
// where C is the leaf's last dim and inner the product of the dims from
// the first reduced dim on (quantize_channelwise keeps its batch dims
// and the last dim, and reduces the dims between to 1).  fp8 e4m3 / e5m2
// and int8 codes convert to float exactly, the product is one fp32
// multiply rounded to nearest, and the bf16 store rounds to nearest even:
// bit-equal to the plain version.
//
// Each thread takes 16 consecutive codes: one 16-byte load, 16 scales
// (C % 16 == 0, so one batch index and 16 consecutive channels; the
// scales are a few KB and stay in L1 / L2), two 16-byte stores.
//
// Layout: q [n] contiguous codes, 16-byte aligned, n % inner == 0,
// inner % C == 0, C % 16 == 0; scale fp32 [n / inner * C], 16-byte
// aligned; out bf16 [n], 16-byte aligned.
//
// Bound on the H100: bytes, 1 byte read and 2 written an element (the
// scales are read once per channel and batch: a rounding error of the
// count).  An expert leaf of 8 x 4096 x 14336 moves 1.41 GB: 0.42 ms at
// 3.35 TB/s.  Two flops an element are far below the ridge.

#include <cuda_fp8.h>

#include "common.cuh"

namespace {

constexpr int kVec = 16;        // codes a thread: one 16-byte load
constexpr int kThreads = 256;

enum class Code { kE4M3, kE5M2, kInt8 };

// 2 codes (the low 16 bits of `pair`) -> 2 floats, exactly: every fp8
// value is a half, every half a float.
template <Code C>
__device__ __forceinline__ float2 decode2(uint32_t pair) {
  if constexpr (C == Code::kInt8) {
    return make_float2(static_cast<float>(static_cast<int8_t>(pair & 0xffu)),
                       static_cast<float>(static_cast<int8_t>((pair >> 8) & 0xffu)));
  } else {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        static_cast<__nv_fp8x2_storage_t>(pair & 0xffffu),
        C == Code::kE4M3 ? __NV_E4M3 : __NV_E5M2);
    return __half22float2(*reinterpret_cast<const __half2*>(&h));
  }
}

template <Code C>
__global__ void __launch_bounds__(kThreads)
fp_dequant_kernel(const uint8_t* __restrict__ q, const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, long long n, long long ch,
                  long long inner) {
  const long long first =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (first >= n) return;
  const float* s = scale + (first / inner) * ch + first % ch;
  const uint4 raw = *reinterpret_cast<const uint4*>(q + first);
  const uint32_t word[4] = {raw.x, raw.y, raw.z, raw.w};
  float f[kVec];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 sc = reinterpret_cast<const float4*>(s)[j];
    const float2 lo = decode2<C>(word[j]);
    const float2 hi = decode2<C>(word[j] >> 16);
    f[4 * j] = lo.x * sc.x;
    f[4 * j + 1] = lo.y * sc.y;
    f[4 * j + 2] = hi.x * sc.z;
    f[4 * j + 3] = hi.y * sc.w;
  }
  uint4* o = reinterpret_cast<uint4*>(out + first);
  o[0] = ds_float8_to_bf16(f);
  o[1] = ds_float8_to_bf16(f + 8);
}

template <Code C>
int launch(const void* q, const void* scale, void* out, long long n,
           long long ch, long long inner, void* stream) {
  if (n % kVec || ch % kVec || inner % ch || n % inner)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = n / kVec;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  fp_dequant_kernel<C><<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(q), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), n, ch, inner);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: n codes; scale: n / inner * ch fp32; out: n bf16.
DS_EXPORT int fp_dequant_e4m3_bf16(const void* q, const void* scale, void* out,
                                   long long n, long long ch, long long inner,
                                   void* stream) {
  return launch<Code::kE4M3>(q, scale, out, n, ch, inner, stream);
}

DS_EXPORT int fp_dequant_e5m2_bf16(const void* q, const void* scale, void* out,
                                   long long n, long long ch, long long inner,
                                   void* stream) {
  return launch<Code::kE5M2>(q, scale, out, n, ch, inner, stream);
}

DS_EXPORT int fp_dequant_int8_bf16(const void* q, const void* scale, void* out,
                                   long long n, long long ch, long long inner,
                                   void* stream) {
  return launch<Code::kInt8>(q, scale, out, n, ch, inner, stream);
}
