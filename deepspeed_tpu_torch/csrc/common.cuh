// Shared helpers for the port's hand-written Hopper kernels.
//
// Each .cu file builds into its own shared library with a plain C
// interface (ops/kernel_loader.py): pointers and the stream arrive as
// void*, and every entry point returns cudaGetLastError() so the Python
// wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include <type_traits>

#define DS_EXPORT extern "C" __attribute__((visibility("default")))

// The JAX package's finite mask, -0.7 * finfo(float32).max: masked
// scores stay finite, so a fully masked row never produces inf - inf.
#define DS_MASK_VALUE (-0.7f * FLT_MAX)

// Each library is one translation unit, so this definition is unique
// per .so.
DS_EXPORT const char* ds_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 8 bf16 values (one 16-byte load) -> 8 floats.
__device__ __forceinline__ void ds_bf16x8_to_float(const uint4& raw,
                                                   float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float ds_warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float ds_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over a block of THREADS threads (a multiple of 32, at most 1024);
// every thread returns the total.  `scratch` holds THREADS / 32 floats of
// shared memory and may be reused by the next call: the leading barrier
// waits until the previous call's partials have been read.
template <int THREADS>
__device__ __forceinline__ float ds_block_sum(float v, float* scratch) {
  v = ds_warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  return ds_warp_sum(lane < THREADS / 32 ? scratch[lane] : 0.f);
}

// 8 floats -> 8 bf16 values (round to nearest even), one 16-byte store.
__device__ __forceinline__ uint4 ds_float8_to_bf16(const float* f) {
  uint4 packed;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return packed;
}

// 8 consecutive fp32 values of a 32-byte-aligned vector.
__device__ __forceinline__ void ds_load_float8(const float* v, int chunk,
                                               float* out) {
  const float4 a = reinterpret_cast<const float4*>(v)[2 * chunk];
  const float4 b = reinterpret_cast<const float4*>(v)[2 * chunk + 1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}


// The elementwise optimizers' operands (fused_adamw.cu, fused_lion.cu,
// fused_lamb.cu): fp32 or bf16 buffers, read as fp32 and written with
// one round to nearest even.  ds_load4 / ds_store4 move element group i
// (elements 4i..4i+3) in one access: 16 bytes of fp32 or 8 of bf16, so
// both need only the 16-byte alignment the wrappers check.
__device__ __forceinline__ float ds_load1(const float* v, long long i) {
  return v[i];
}
__device__ __forceinline__ float ds_load1(const __nv_bfloat16* v,
                                          long long i) {
  return __bfloat162float(v[i]);
}
__device__ __forceinline__ void ds_store1(float* v, long long i, float x) {
  v[i] = x;
}
__device__ __forceinline__ void ds_store1(__nv_bfloat16* v, long long i,
                                          float x) {
  v[i] = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void ds_load4(const float* v, long long i,
                                         float* out) {
  const float4 a = reinterpret_cast<const float4*>(v)[i];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void ds_load4(const __nv_bfloat16* v, long long i,
                                         float* out) {
  const uint2 raw = reinterpret_cast<const uint2*>(v)[i];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
__device__ __forceinline__ void ds_store4(float* v, long long i,
                                          const float* x) {
  reinterpret_cast<float4*>(v)[i] = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ void ds_store4(__nv_bfloat16* v, long long i,
                                          const float* x) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(x[0], x[1]);
  h[1] = __floats2bfloat162_rn(x[2], x[3]);
  reinterpret_cast<uint2*>(v)[i] = raw;
}

// Calls f(std::integral_constant<int, C>{}) with the smallest power of
// two C >= n, up to MAX: picks a kernel instantiation from a runtime
// count (chunks per thread) so that no register holds a chunk the row
// does not have.
template <int MAX, int C = 1, typename F>
inline void ds_with_pow2(int n, F&& f) {
  if constexpr (C < MAX) {
    if (n > C) {
      ds_with_pow2<MAX, 2 * C>(n, f);
      return;
    }
  }
  f(std::integral_constant<int, C>{});
}
