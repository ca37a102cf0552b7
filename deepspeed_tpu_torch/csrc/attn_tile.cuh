// Tensor-core attention tile, shared by the flash forward and backward
// kernels and the multi-row path of the paged attention kernels (bf16 and
// int8 pages).
//
// One warpgroup (128 threads) owns 64 query rows at head_dim 128 and walks
// key blocks of 64 (a flash k-block, or one KV page zero-padded to 64):
//   1. S = Q . K^T with wgmma.mma_async m64n64k16 (bf16 in, fp32 out):
//      Q and K are bf16 tiles in 128-byte-swizzled shared memory, K-major;
//   2. the caller's score functor scales, biases and masks S in the
//      accumulator registers (only on blocks that cross a boundary: the
//      interior ones take the unmasked form), the row max and sum come
//      from quad shuffles, m and l stay fp32;
//   3. O += P . V with wgmma m64n128k16: P goes from the fp32 score
//      fragment to bf16 in registers as the A operand (the accumulator
//      fragment of m64n64 is, four columns at a time, the A fragment of
//      k16), V is [keys, D] bf16 in swizzled shared memory read MN-major
//      through the descriptor's transpose bit; O stays in 64 fp32
//      registers per thread.
// Callers stage tiles with 16-byte cp.async (zero-filled past the valid
// rows) through a 2-stage ring, so one block's copy overlaps the previous
// block's compute; fence_proxy_async() makes the copies visible to the
// tensor cores.
//
// Numerics: scores, the running max and the denominator are fp32; P is
// rounded to bf16 before P . V, as in both TPU kernels
// (flash_attention.py:120, paged_attention.py:336) and the plain
// versions.  With VSCALE (int8 V codes as the bf16 operand) the rounded
// value is p * v_scale[t]: codes of magnitude <= 127 are exact in bf16,
// and the denominator sums the unscaled p.
//
// Accumulator layout (fp32, m64nN): thread t of the warpgroup, warp
// w = t / 32, lane l, holds rows r0 = 16 w + l / 4 and r0 + 8; register
// i holds row r0 + 8 ((i >> 1) & 1), column 2 (l % 4) + (i & 1) + 8 (i >> 2).
// The backward (flash_bwd.cu) reads the same operands both ways: a tile
// stored [rows][128] is K-major where the product sums over head dims
// (S = Q . K^T) and MN-major where it sums over the tile's rows (dV +=
// P^T . dO), through two descriptors of the one stored tile.
#pragma once

#include "common.cuh"

namespace ds_attn {

constexpr int kThreads = 128;
constexpr int kHeadDim = 128;
constexpr int kKeys = 64;                   // keys per block
constexpr int kRows = 64;                   // query rows per tile
constexpr int kPanelBytes = 64 * 128;       // 64 rows of 64 bf16 (128 B)
constexpr int kTileBytes = 2 * kPanelBytes; // [64][128] bf16, two panels
constexpr float kLog2e = 1.4426950408889634f;

// Byte offset of 16-byte chunk c (0..15, 8 bf16 each) of row r in a
// [64][128] bf16 tile: two column panels of [64][64], each row 128 B,
// chunks XOR-swizzled by r % 8 (the wgmma 128-byte swizzle; a panel
// starts on a 1024-byte boundary).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * kPanelBytes + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; valid == false fills zeros and reads nothing.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows (row0 ..) of a [.., S, 128] bf16 operand with row stride
// `row_stride` elements into the swizzled tile at `dst`; rows at or past
// n_rows are zero-filled and read nothing.  Every thread of the
// warpgroup issues 8 of the 1024 16-byte copies; the loop is unrolled,
// so each copy's addresses are a per-thread base plus a constant (the
// kernels issue these every block, and a rolled loop's arithmetic showed
// in their time).  The caller commits.
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int n_rows) {
#pragma unroll
  for (int i = 0; i < kRows * 16 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c >> 4, chunk = c & 15;
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + swz(r, chunk),
               src + (ok ? (row0 + r) * row_stride : 0) + chunk * 8, ok);
  }
}

// The same 64 rows of two operands (K and V, or Q and dO) into two tiles
// in one loop, as load_tile does for one: the row arithmetic is shared
// (two load_tile calls ran the flash kernels slower).
__device__ __forceinline__ void load_tile_pair(
    uint32_t dst_a, const __nv_bfloat16* src_a, long long stride_a,
    uint32_t dst_b, const __nv_bfloat16* src_b, long long stride_b, int row0,
    int n_rows) {
#pragma unroll
  for (int i = 0; i < kRows * 16 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c >> 4, chunk = c & 15;
    const bool ok = row0 + r < n_rows;
    const long long row = ok ? row0 + r : 0;
    cp_async16(dst_a + swz(r, chunk), src_a + row * stride_a + chunk * 8, ok);
    cp_async16(dst_b + swz(r, chunk), src_b + row * stride_b + chunk * 8, ok);
  }
}

// Writes of the generic proxy (cp.async, st.shared) -> reads of the
// async proxy (wgmma); each writer fences before the barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (bits
// 62-63).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major operand (Q, K): 8-row groups 1024 B apart; the leading offset
// is unused when a k16 step lies inside one 128-byte row.  k-step kk
// (16 of the 128 head dims) starts in panel kk / 4, 32 B per step in.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + (kk >> 2) * kPanelBytes + (kk & 3) * 32, 16, 1024);
}

// MN-major operand (V as [keys][D], D contiguous): the two 64-column
// panels are kPanelBytes apart (leading offset), 8-key groups 1024 B
// apart (stride offset); k-step kk covers keys 16 kk .. 16 kk + 15.
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 2048, kPanelBytes, 1024);
}

// S[64 x 64] (+)= A[64 x 16] . B[16 x 64]: A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O[64 x 128] += A[64 x 16] . B[16 x 128]: A in registers (the bf16 fragment
// of the m16n8k16 layout, per warp), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An fp32 m64n64 accumulator fragment as the bf16 A operand of four k16
// steps of an m64n128k16 product (its 64 columns are the product's sum
// index): four columns at a time the accumulator layout is the A
// fragment's, so register i goes to step i / 8, pair (i / 2) % 4.
__device__ __forceinline__ void pack_a_frag(const float (&s)[32],
                                            uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Accumulator register i of a packed fragment, as the fp32 value of its
// bf16 (exact).
__device__ __forceinline__ float frag_elem(const uint32_t (&a)[4][4], int i) {
  const uint32_t w = a[i >> 3][(i >> 1) & 3];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// Per-thread softmax state of the thread's two rows, and its 64 output
// accumulators (row r0 + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 (l % 4)
// + (i & 1)).
struct RowState {
  float m[2];
  float l[2];
  float o[64];

  __device__ void init() {
    m[0] = m[1] = -INFINITY;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
  }
};

// This thread's first row in the tile, and its first column in each
// group of 8.
__device__ __forceinline__ int frag_row() {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2);
}
__device__ __forceinline__ int frag_col() { return 2 * (threadIdx.x & 3); }

// One key block.  q, k, v: shared addresses of swizzled [64][128] bf16
// tiles, written and fenced (fence_proxy_async + __syncthreads) by the
// caller.  score.apply<MASK>(j, t, dot) returns the scaled (and biased)
// score of the thread's row j (0: r0, 1: r0 + 8) and key t, or
// DS_MASK_VALUE; MASK == false promises that every key is visible.
// v_scale (VSCALE only): 64 fp32 scales of the block's V rows.
template <bool MASK, bool VSCALE, class Score>
__device__ __forceinline__ void attend_block(uint32_t q, uint32_t k,
                                             uint32_t v, const float* v_scale,
                                             RowState& st, const Score& score) {
  float s[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk)
    wgmma_m64n64k16_ss(s, kmajor_desc(q, kk), kmajor_desc(k, kk), kk > 0);
  wgmma_commit();
  wgmma_wait0();
  fence_operands(s);

  const int c0 = frag_col();
  float mx[2] = {st.m[0], st.m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = (i >> 1) & 1, t = c0 + (i & 1) + 8 * (i >> 2);
    s[i] = score.template apply<MASK>(j, t, s[i]);
    mx[j] = fmaxf(mx[j], s[i]);
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
    mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
    alpha[j] = exp2f((st.m[j] - mx[j]) * kLog2e);  // 0 on the first block
    st.m[j] = mx[j];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int j = (i >> 1) & 1;
    s[i] = exp2f((s[i] - mx[j]) * kLog2e);
    sum[j] += s[i];
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) st.l[j] = st.l[j] * alpha[j] + sum[j];
#pragma unroll
  for (int i = 0; i < 64; ++i) st.o[i] *= alpha[(i >> 1) & 1];

  if (VSCALE) {
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= v_scale[c0 + (i & 1) + 8 * (i >> 2)];
  }
  uint32_t a[4][4];
  pack_a_frag(s, a);

  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_m64n128k16_rs(st.o, a[kk], mnmajor_desc(v, kk));
  wgmma_commit();
  wgmma_wait0();
  fence_operands(st.o);
}

// After the last block: each row's denominator summed over its quad.
__device__ __forceinline__ void finish_rows(RowState& st) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    st.l[j] += __shfl_xor_sync(0xffffffffu, st.l[j], 1);
    st.l[j] += __shfl_xor_sync(0xffffffffu, st.l[j], 2);
  }
}

// An m64n128 fp32 accumulator fragment times inv[row half] as bf16 into
// the swizzled [64][128] tile at `stage` (16 KB of shared memory that no
// wgmma reads any more; the caller syncs before and after), to leave as
// 16-byte chunks (swz gives row r's chunk c).
__device__ __forceinline__ void store_tile(const float (&o)[64],
                                           const float (&inv)[2],
                                           uint8_t* stage) {
  const int r0 = frag_row(), c0 = frag_col();
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int j = (i >> 1) & 1, r = r0 + 8 * j, col = c0 + 8 * (i >> 2);
    *reinterpret_cast<uint32_t*>(stage + swz(r, col >> 3) + (col & 7) * 2) =
        pack_bf16(o[i] * inv[j], o[i + 1] * inv[j]);
  }
}

// o / l of the attention rows, as store_tile.
__device__ __forceinline__ void store_out_tile(const RowState& st,
                                               uint8_t* stage) {
  const float inv[2] = {1.f / fmaxf(st.l[0], 1e-30f),
                        1.f / fmaxf(st.l[1], 1e-30f)};
  store_tile(st.o, inv, stage);
}

// The staged tile's rows row0 + r < n_rows to dst (row stride
// `row_stride` elements), one 16-byte store per chunk.
__device__ __forceinline__ void copy_out_tile(const uint8_t* stage,
                                              __nv_bfloat16* dst,
                                              long long row_stride, int row0,
                                              int n_rows) {
#pragma unroll
  for (int i = 0; i < kRows * 16 / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c >> 4, chunk = c & 15;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(dst + (row0 + r) * row_stride + chunk * 8) =
          *reinterpret_cast<const uint4*>(stage + swz(r, chunk));
  }
}

// 1024-byte aligned base of the dynamic shared memory (the swizzle atoms
// must start on 1024-byte boundaries); launches ask for kSmemSlack more.
constexpr int kSmemSlack = 1024;
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

}  // namespace ds_attn
