// Online-softmax attention over one 64-key block, shared by the paged
// attention and flash forward kernels.
//
// A block of 128 threads owns a tile of ROWS query rows (fp32 in shared
// memory) and walks key blocks of 64.  Per key block:
//   1. scores  S[r][t] = q[r] . k[t]   (thread t = tid % 64 computes a
//      column for every other row; K sits transposed in shared memory
//      so a warp reads 32 consecutive floats, and q[r][d] is a
//      broadcast),
//   2. the caller's Score functor scales, biases and masks S,
//   3. one warp per row updates the running max m and denominator l,
//   4. acc[r][d] = acc[r][d] * alpha[r] + sum_t P[r][t] * v[t][d], with
//      thread d = tid owning column d of every row in registers.
// Everything accumulates in fp32 (m, l, acc, scores, probabilities).
// The multiply-adds are plain FMAs; tensor-core tiles are later work.
#pragma once

#include "common.cuh"

namespace ds_attn {

constexpr int kThreads = 128;
constexpr int kHeadDim = 128;          // == kThreads: one column per thread
constexpr int kKeys = 64;              // keys per block (a KV page or a flash k-block)
constexpr int kKtStride = kKeys + 1;   // padding spreads the transposed stores over banks

template <int ROWS>
struct SmemLayout {
  static constexpr int q = ROWS * kHeadDim;
  static constexpr int kt = kHeadDim * kKtStride;
  static constexpr int v = kKeys * kHeadDim;
  static constexpr int p = ROWS * kKeys;
  static constexpr int floats = q + kt + v + p + 3 * ROWS;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int ROWS>
struct Tile {
  float* qs;     // [ROWS][kHeadDim]
  float* kt;     // [kHeadDim][kKtStride]   K transposed
  float* vs;     // [kKeys][kHeadDim]
  float* ps;     // [ROWS][kKeys]           scores, then probabilities
  float* m;      // [ROWS] running max
  float* l;      // [ROWS] running denominator
  float* alpha;  // [ROWS] rescale of this block

  __device__ explicit Tile(float* smem) {
    using L = SmemLayout<ROWS>;
    qs = smem;
    kt = qs + L::q;
    vs = kt + L::kt;
    ps = vs + L::v;
    m = ps + L::p;
    l = m + ROWS;
    alpha = l + ROWS;
  }

  __device__ void init_stats() {
    for (int r = threadIdx.x; r < ROWS; r += kThreads) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
  }

  // Row r of q (nullptr = padding row, filled with zeros).
  __device__ void store_q_chunk(int r, int chunk, const __nv_bfloat16* row) {
    float f[8];
    if (row != nullptr) {
      ds_bf16x8_to_float(*reinterpret_cast<const uint4*>(row + chunk * 8), f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) qs[r * kHeadDim + chunk * 8 + j] = f[j];
  }

  // Key/value t (nullptr = past the valid keys: zeros, so a masked key
  // multiplies a finite value).
  __device__ void store_kv_chunk(int t, int chunk, const __nv_bfloat16* krow,
                                 const __nv_bfloat16* vrow) {
    float fk[8], fv[8];
    if (krow != nullptr) {
      ds_bf16x8_to_float(*reinterpret_cast<const uint4*>(krow + chunk * 8), fk);
      ds_bf16x8_to_float(*reinterpret_cast<const uint4*>(vrow + chunk * 8), fv);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) fk[j] = fv[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kt[(chunk * 8 + j) * kKtStride + t] = fk[j];
      vs[t * kHeadDim + chunk * 8 + j] = fv[j];
    }
  }
};

// One key block.  Expects q, K and V of the block in shared memory and a
// __syncthreads() after they were stored.  score(r, t, dot) returns the
// scaled, biased score or DS_MASK_VALUE.
template <int ROWS, class Score>
__device__ __forceinline__ void attend_block(Tile<ROWS>& T, float (&acc)[ROWS],
                                             const Score& score) {
  const int tid = threadIdx.x;
  const int t = tid & (kKeys - 1);
  const int rg = tid >> 6;  // 0 or 1: even or odd rows
  for (int r0 = rg; r0 < ROWS; r0 += 16) {
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; ++d) {
      const float kd = T.kt[d * kKtStride + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = r0 + 2 * j;
        if (r < ROWS) s[j] = fmaf(T.qs[r * kHeadDim + d], kd, s[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = r0 + 2 * j;
      if (r < ROWS) T.ps[r * kKeys + t] = score(r, t, s[j]);
    }
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < ROWS; r += kThreads / 32) {
    float a = T.ps[r * kKeys + lane];
    float b = T.ps[r * kKeys + lane + 32];
    const float m_old = T.m[r];
    const float m_new = fmaxf(m_old, ds_warp_max(fmaxf(a, b)));
    a = expf(a - m_new);
    b = expf(b - m_new);
    T.ps[r * kKeys + lane] = a;
    T.ps[r * kKeys + lane + 32] = b;
    const float sum = ds_warp_sum(a + b);
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);  // 0 on the first block
      T.alpha[r] = alpha;
      T.l[r] = T.l[r] * alpha + sum;
      T.m[r] = m_new;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] *= T.alpha[r];
  for (int k = 0; k < kKeys; ++k) {
    const float v = T.vs[k * kHeadDim + tid];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(T.ps[r * kKeys + k], v, acc[r]);
  }
}

}  // namespace ds_attn
