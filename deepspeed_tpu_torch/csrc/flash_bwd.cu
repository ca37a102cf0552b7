// Flash attention backward: dK/dV over query blocks, dQ over key blocks,
// recomputing the probabilities from the forward's log-sum-exp so no
// S x S matrix ever reaches device memory.
//
// Replaces: deepspeed_tpu/ops/flash_attention.py:_bwd_dkv_kernel and
// _bwd_dq_kernel (via _flash_bwd).  Training runs both once per layer
// per micro-batch, as the backward of the flash forward.
//
// Layout: q, dO [B, H, S, D] and k, v [B, Kh, S, D] by element strides
// (transposed views of the model's [B, S, H, D] activations, and the
// gradient autograd hands back, are read in place; the last dim must be
// contiguous and rows 16-byte aligned), lse and delta [B, H, S] fp32
// contiguous (lse is the natural-log LSE flash_fwd.cu writes, delta =
// rowsum(dO * O) from the wrapper), dq [B, H, S, D] and dk, dv [B, Kh, S, D]
// bf16 contiguous.  D = 128.
//
// Both kernels run every product on the tensor cores through the wgmma
// tile of attn_tile.cuh: one warpgroup, bf16 operands in 128-byte-
// swizzled shared memory, fp32 accumulators in registers, the streamed
// operands through a 2-stage cp.async ring.  Per (64 queries, 64 keys)
// pair, with p = exp(s - lse) = exp2(s' scale log2e - lse log2e):
//
// dK/dV, grid (ceil(Sk / 64), Kh, B), one warpgroup per 64 keys.  K and
// V stay in shared memory; the block walks the (query head g of the
// group, q block) pairs as one stream, the q blocks from the causal
// diagonal to the window's last block (_bwd_dkv_kernel's bounds), so
// the GQA sum over the group happens in the accumulators, with no
// atomics.  The products are transposed, as in FlashAttention-2/3, so P
// and dS come out of the accumulators already as wgmma A fragments:
//   S^T  = K . Q^T        (m64n64k16, both K-major)
//   P^T  = exp2(...)      lse of each column (query) from shared memory;
//                         rounded to bf16 and packed as the A fragment
//   dV  += P^T . dO       (m64n128k16, P^T in registers, dO MN-major)
//   dP^T = V . dO^T       (m64n64k16, issued with dV: S^T is dead)
//   dS^T = P^T (dP^T - delta) scale, rounded to bf16
//   dK  += dS^T . Q       (m64n128k16, Q MN-major)
// Q and dO are each read K-major and MN-major from one stored tile.
//
// dQ, grid (ceil(Sq / 64), H, B) in reverse order (the longest causal
// rows start first), one warpgroup per 64 query rows.  Q, dO and the
// rows' lse and delta stay; K and V stream over the key blocks from the
// window's first block to the diagonal:
//   S = Q . K^T, dP = dO . V^T   (m64n64k16, one commit group)
//   dS = P (dP - delta) scale    P rounded to bf16 as in dK/dV
//   dQ += dS . K                 (m64n128k16, K MN-major)
//
// Only blocks that cross the diagonal, the window edge, Sq or Sk apply
// the mask (masked p is 0); interior blocks take the unmasked form.
// Padding rows past Sq or Sk are zero-filled by cp.async and masked.
//
// Numerics: fp32 scores and accumulators; P and dS rounded to bf16
// before their products, as the TPU kernel rounds them to the input
// dtype (flash_attention.py:199,205,249) and as flash_bwd_reference
// does; dS takes the bf16 P (the fp32 P is dead once packed).  No
// atomics: the sums run in one fixed order, so two calls are bit-equal.
//
// Bound on the H100: operations.  dK/dV runs four S x S products (s,
// dP, dV, dK) and dQ three (s, dP, dQ), 2 * B * H * D flops per
// attended pair each; the function needs five (s and dP once): at B = 2,
// H = 32, S = 2048 causal that is 172 GFLOP, 0.174 ms at 989 TFLOP/s,
// against 0.08 ms for the ~270 MB of q, k, v, o, dO, lse, delta, dq, dk
// and dv.  Recomputing s and dP in dQ costs two products of seven and
// keeps both kernels free of atomics (a single kernel adding dQ with
// atomics would do five, nondeterministically).
//
// Shared memory: dK/dV K and V 32 KB + 2 stages x (Q, dO 32 KB and 512 B
// of lse and delta); dQ Q and dO 32 KB + 2 stages x (K, V 32 KB): about
// 98 KB each, so two blocks fit on an SM.

#include "attn_tile.cuh"

using namespace ds_attn;

namespace {

struct Band {
  int Sq, Sk, causal, window;  // window <= 0: none

  __device__ __forceinline__ bool keep(int qp, int kp) const {
    bool k = qp < Sq && kp < Sk;
    if (causal) k = k && qp >= kp;
    if (window > 0) k = k && (qp - kp) < window;
    return k;
  }

  // every (query, key) pair of the 64 x 64 block at (q0, k0) visible
  __device__ __forceinline__ bool interior(int q0, int k0) const {
    return q0 + kRows <= Sq && k0 + kKeys <= Sk &&
           (!causal || k0 + kKeys - 1 <= q0) &&
           (window <= 0 || q0 + kRows - 1 - k0 < window);
  }
};

struct Strides {
  long long b, h, s;
};

// [lse 64 | delta 64] fp32 of query rows q0 .. q0 + 63 into `dst` (0 past
// Sq): one 4-byte cp.async per thread.
__device__ __forceinline__ void load_stats(float* dst, const float* lse,
                                           const float* delta, int q0,
                                           int Sq) {
  const int t = threadIdx.x, r = t & (kRows - 1);
  const bool ok = q0 + r < Sq;
  cp_async4(smem_addr(dst + t), (t < kRows ? lse : delta) + (ok ? q0 + r : 0),
            ok);
}

// dK/dV shared memory: K, V, then 2 stages of (Q, dO), then 2 stages of
// the q block's [lse | delta].
constexpr int kDkvSmem = 6 * kTileBytes + 2 * 2 * kRows * 4 + kSmemSlack;

// p^T (MASK: 0 outside the band) for the thread's keys (rows) and
// queries (columns) of the block; lse_s: the q block's lse.
template <bool MASK>
__device__ __forceinline__ void probs_t(float (&s)[32], const float* lse_s,
                                        int q0, int k0, const Band& band,
                                        float scale_log2) {
  const int r0 = frag_row(), c0 = frag_col();
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + 8 * ((i >> 1) & 1), col = c0 + (i & 1) + 8 * (i >> 2);
    const float p = exp2f(fmaf(s[i], scale_log2, -lse_s[col] * kLog2e));
    s[i] = (!MASK || band.keep(q0 + col, k0 + row)) ? p : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int H, int Kh, Strides qst,
                     Strides kst, Strides vst, Strides dost, Band band,
                     float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t k_s = smem_addr(smem), v_s = k_s + kTileBytes;
  auto q_tile = [&](int stage) { return k_s + (2 + 2 * stage) * kTileBytes; };
  auto do_tile = [&](int stage) { return q_tile(stage) + kTileBytes; };
  float* stats = reinterpret_cast<float*>(smem + 6 * kTileBytes);

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int k0 = kb * kKeys;

  load_tile_pair(k_s, k + b * kst.b + kvh * kst.h, kst.s, v_s,
                 v + b * vst.b + kvh * vst.h, vst.s, k0, band.Sk);

  // the q blocks that see this key block (_bwd_dkv_kernel's bounds)
  const int nq = (band.Sq + kRows - 1) / kRows;
  const int q_lo = band.causal ? k0 / kRows : 0;
  int q_hi = nq;
  if (band.window > 0)
    q_hi = min(q_hi, (k0 + kKeys - 1 + band.window - 1) / kRows + 1);
  const int n_q = max(0, q_hi - q_lo);
  const int steps = G * n_q;  // (query head, q block) pairs, head-major

  auto load_step = [&](int i, int stage) {
    const int h = kvh * G + i / n_q, q0 = (q_lo + i % n_q) * kRows;
    load_tile_pair(q_tile(stage), q + b * qst.b + h * qst.h, qst.s,
                   do_tile(stage), dout + b * dost.b + h * dost.h, dost.s, q0,
                   band.Sq);
    const size_t row = (static_cast<size_t>(b) * H + h) * band.Sq;
    load_stats(stats + stage * 2 * kRows, lse + row, delta + row, q0,
               band.Sq);
  };
  if (steps > 0) load_step(0, 0);
  cp_async_commit();  // K, V and the first step

  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;
  const int c0 = frag_col();

  for (int i = 0; i < steps; ++i) {
    const int stage = i & 1;
    if (i + 1 < steps) load_step(i + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the step just requested
    fence_proxy_async();
    __syncthreads();
    const int q0 = (q_lo + i % n_q) * kRows;
    const float* lse_s = stats + stage * 2 * kRows;
    const float* delta_s = lse_s + kRows;
    const uint32_t q_t = q_tile(stage), do_t = do_tile(stage);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(k_s, kk), kmajor_desc(q_t, kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);

    if (band.interior(q0, k0))
      probs_t<false>(s, lse_s, q0, k0, band, scale_log2);
    else
      probs_t<true>(s, lse_s, q0, k0, band, scale_log2);
    uint32_t a[4][4];
    pack_a_frag(s, a);

    float dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs(dv_acc, a[kk], mnmajor_desc(do_t, kk));
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(v_s, kk), kmajor_desc(do_t, kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(dv_acc);
    fence_operands(dp);

#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = c0 + (j & 1) + 8 * (j >> 2);
      dp[j] = frag_elem(a, j) * (dp[j] - delta_s[col]) * scale;
    }
    pack_a_frag(dp, a);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs(dk_acc, a[kk], mnmajor_desc(q_t, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_operands(dk_acc);
    __syncthreads();  // the stage is free for the load two steps on
  }
  cp_async_wait<0>();
  __syncthreads();  // K and V are read by no wgmma any more

  const float one[2] = {1.f, 1.f};
  store_tile(dk_acc, one, smem);
  store_tile(dv_acc, one, smem + kTileBytes);
  __syncthreads();
  const size_t base = (static_cast<size_t>(b) * Kh + kvh) * band.Sk * kHeadDim;
  copy_out_tile(smem, dk + base, kHeadDim, k0, band.Sk);
  copy_out_tile(smem + kTileBytes, dv + base, kHeadDim, k0, band.Sk);
}

// dQ shared memory: Q, dO, then 2 stages of (K, V).
constexpr int kDqSmem = 6 * kTileBytes + kSmemSlack;

__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Kh, Strides qst,
                    Strides kst, Strides vst, Strides dost, Band band,
                    float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_addr(smem), do_s = q_s + kTileBytes;
  auto k_tile = [&](int stage) { return q_s + (2 + 2 * stage) * kTileBytes; };
  auto v_tile = [&](int stage) { return k_tile(stage) + kTileBytes; };

  const int tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int q0 = tile * kRows;

  load_tile_pair(q_s, q + b * qst.b + h * qst.h, qst.s, do_s,
                 dout + b * dost.b + h * dost.h, dost.s, q0, band.Sq);
  const __nv_bfloat16* kb = k + b * kst.b + kvh * kst.h;
  const __nv_bfloat16* vb = v + b * vst.b + kvh * vst.h;
  auto load_kv = [&](int blk, int stage) {
    load_tile_pair(k_tile(stage), kb, kst.s, v_tile(stage), vb, vst.s,
                   blk * kKeys, band.Sk);
  };

  // the key blocks this query block sees (_bwd_dq_kernel's bounds)
  int hi = (band.Sk + kKeys - 1) / kKeys;
  if (band.causal) hi = min(hi, (q0 + kRows + kKeys - 1) / kKeys);
  const int lo = band.window > 0 ? max(0, (q0 - band.window + 1) / kKeys) : 0;

  if (lo < hi) load_kv(lo, 0);
  cp_async_commit();  // Q, dO and the first block

  // the thread's two rows: lse (pre-scaled to base 2) and delta
  const int r0 = frag_row(), c0 = frag_col();
  const size_t row = (static_cast<size_t>(b) * H + h) * band.Sq;
  float lse2[2], dlt[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qp = q0 + r0 + 8 * j;
    lse2[j] = qp < band.Sq ? lse[row + qp] * kLog2e : 0.f;
    dlt[j] = qp < band.Sq ? delta[row + qp] : 0.f;
  }

  float dq_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq_acc[i] = 0.f;
  const float scale_log2 = scale * kLog2e;

  for (int blk = lo; blk < hi; ++blk) {
    const int stage = (blk - lo) & 1;
    if (blk + 1 < hi) load_kv(blk + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the block just requested
    fence_proxy_async();
    __syncthreads();
    const int k0 = blk * kKeys;
    const uint32_t k_t = k_tile(stage), v_t = v_tile(stage);

    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(s, kmajor_desc(q_s, kk), kmajor_desc(k_t, kk),
                         kk > 0);
#pragma unroll
    for (int kk = 0; kk < kHeadDim / 16; ++kk)
      wgmma_m64n64k16_ss(dp, kmajor_desc(do_s, kk), kmajor_desc(v_t, kk),
                         kk > 0);
    wgmma_commit();
    wgmma_wait0();
    fence_operands(s);
    fence_operands(dp);

    const bool mask = !band.interior(q0, k0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = (i >> 1) & 1, t = c0 + (i & 1) + 8 * (i >> 2);
      float p = exp2f(fmaf(s[i], scale_log2, -lse2[j]));
      if (mask && !band.keep(q0 + r0 + 8 * j, k0 + t)) p = 0.f;
      // the bf16 P of the dK/dV kernel
      p = __bfloat162float(__float2bfloat16(p));
      s[i] = p * (dp[i] - dlt[j]) * scale;
    }
    uint32_t a[4][4];
    pack_a_frag(s, a);

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n128k16_rs(dq_acc, a[kk], mnmajor_desc(k_t, kk));
    wgmma_commit();
    wgmma_wait0();
    fence_operands(dq_acc);
    __syncthreads();  // the stage is free for the load two blocks on
  }
  cp_async_wait<0>();
  __syncthreads();  // Q is read by no wgmma any more

  const float one[2] = {1.f, 1.f};
  store_tile(dq_acc, one, smem);
  __syncthreads();
  copy_out_tile(smem, dq + row * kHeadDim, kHeadDim, q0, band.Sq);
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) configured = true;
  return e;
}

}  // namespace

// causal: 0/1; window <= 0: no sliding window.  dk, dv contiguous
// [B, Kh, Sk, D].
DS_EXPORT int flash_bwd_dkv_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int Kh, int Sq, int Sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, float scale, int causal, int window, void* stream) {
  static bool configured = false;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel, kDkvSmem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sk + kKeys - 1) / kKeys, Kh, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, kDkvSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), H, Kh, Strides{q_sb, q_sh, q_ss},
      Strides{k_sb, k_sh, k_ss}, Strides{v_sb, v_sh, v_ss},
      Strides{do_sb, do_sh, do_ss}, Band{Sq, Sk, causal, window}, scale);
  return static_cast<int>(cudaGetLastError());
}

// dq contiguous [B, H, Sq, D].
DS_EXPORT int flash_bwd_dq_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int Kh,
    int Sq, int Sk, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long do_sb, long long do_sh,
    long long do_ss, float scale, int causal, int window, void* stream) {
  static bool configured = false;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel, kDqSmem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_bwd_dq_kernel<<<grid, kThreads, kDqSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), H, Kh,
      Strides{q_sb, q_sh, q_ss}, Strides{k_sb, k_sh, k_ss},
      Strides{v_sb, v_sh, v_ss}, Strides{do_sb, do_sh, do_ss},
      Band{Sq, Sk, causal, window}, scale);
  return static_cast<int>(cudaGetLastError());
}
