// Online-softmax attention over one 64-key block, shared by the paged
// attention kernels (bf16 and int8 pages) and the flash forward kernel.
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

// Staging of one int8 KV page (block-scaled codes, one fp32 scale per
// token and kv head) into a Tile's fp32 K^T and V.
//
// Two steps, so that both the global loads and the shared-memory stores
// are regular.  load_chunk: 8 neighbouring threads read one 128-byte row
// of codes as 16-byte loads (a row of int8 codes is 128 B, half a bf16
// row) and drop the words into rows of 33 words -- the odd stride puts
// word g of key t in bank (t + g) % 32.  dequantize, after a barrier:
// for K a warp takes 32 keys at one word, reads banks t + g, and writes
// kt[d][t] along t, all without conflicts; for V a warp takes the 32
// words of one key and writes its 512 bytes of fp32 in one sweep.  The
// dequantised page exists only in shared memory: device memory traffic
// stays int8-sized.
//
// Numerics follow the TPU kernel: K is float(code) * scale rounded to
// bf16 (it meets a bf16 q), V is float(code) * scale kept in fp32 (it
// meets fp32 probabilities).  A row never written has codes 0 and scale
// 0 and dequantises to exactly 0.
constexpr int kCodeWords = kHeadDim / 4;        // 32 words of 4 codes per row
constexpr int kCodeStride = kCodeWords + 1;

struct Int8Stage {
  uint32_t* k;     // [kKeys][kCodeStride]
  uint32_t* v;     // [kKeys][kCodeStride]
  float* k_scale;  // [kKeys]
  float* v_scale;  // [kKeys]

  static constexpr int words = 2 * kKeys * kCodeStride + 2 * kKeys;
  static constexpr size_t bytes = words * sizeof(uint32_t);

  __device__ explicit Int8Stage(float* smem) {
    k = reinterpret_cast<uint32_t*>(smem);
    v = k + kKeys * kCodeStride;
    k_scale = reinterpret_cast<float*>(v + kKeys * kCodeStride);
    v_scale = k_scale + kKeys;
  }

  // 16 codes of key t (chunk in [0, 8)); nullptr = past the page: zeros.
  __device__ void load_chunk(int t, int chunk, const int8_t* krow,
                             const int8_t* vrow) {
    uint4 kq = make_uint4(0u, 0u, 0u, 0u), vq = kq;
    if (krow != nullptr) {
      kq = *reinterpret_cast<const uint4*>(krow + chunk * 16);
      vq = *reinterpret_cast<const uint4*>(vrow + chunk * 16);
    }
    uint32_t* kd = k + t * kCodeStride + chunk * 4;
    uint32_t* vd = v + t * kCodeStride + chunk * 4;
    kd[0] = kq.x; kd[1] = kq.y; kd[2] = kq.z; kd[3] = kq.w;
    vd[0] = vq.x; vd[1] = vq.y; vd[2] = vq.z; vd[3] = vq.w;
  }

  // Code j (0..3) of a little-endian word, as a float.
  __device__ static float code(uint32_t word, int j) {
    return static_cast<float>(static_cast<signed char>(word >> (8 * j)));
  }

  template <int ROWS>
  __device__ void dequantize(Tile<ROWS>& T) const {
    for (int c = threadIdx.x; c < kKeys * kCodeWords; c += kThreads) {
      const int t = c % kKeys, g = c / kKeys;  // a warp: 32 keys, one word
      const uint32_t word = k[t * kCodeStride + g];
      const float scale = k_scale[t];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        T.kt[(4 * g + j) * kKtStride + t] =
            __bfloat162float(__float2bfloat16(code(word, j) * scale));
    }
    for (int c = threadIdx.x; c < kKeys * kCodeWords; c += kThreads) {
      const int g = c % kCodeWords, t = c / kCodeWords;  // a warp: one key
      const uint32_t word = v[t * kCodeStride + g];
      const float scale = v_scale[t];
      *reinterpret_cast<float4*>(T.vs + t * kHeadDim + 4 * g) =
          make_float4(code(word, 0) * scale, code(word, 1) * scale,
                      code(word, 2) * scale, code(word, 3) * scale);
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
