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
