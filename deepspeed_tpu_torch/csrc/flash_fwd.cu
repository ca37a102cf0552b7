// Flash attention forward: blockwise causal / sliding-window attention
// that never materialises the S x S score matrix, emitting out and the
// log-sum-exp (which the backward kernels read).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py:_fwd_kernel (via
// _flash_fwd).  Training runs it twice per layer (forward and remat);
// serving runs it on the pure-prefill ("fresh") step, once per layer.
//
// Layout: q [B, H, Sq, D], k / v [B, Kh, Sk, D] given by element strides
// (so transposed views of the model's [B, S, H, D] activations need no
// copy; rows are 16-byte aligned with a contiguous last dim), out
// [B, H, Sq, D] by strides, lse [B, H, Sq] fp32 contiguous.  GQA: query
// head h reads kv head h / (H / Kh) inside the kernel.
//
// Grid (ceil(Sq / 64), H, B), 128 threads: one warpgroup owns 64 query
// rows on the tensor-core tile of attn_tile.cuh.  Tiles launch in reverse
// order, so the causal diagonal's longest tiles start first and do not
// trail.  Each block loads its Q tile once and walks 64-key blocks from
// the window's lower block to the causal diagonal (the _band_keep bounds
// of the TPU kernel), K and V through a 2-stage cp.async ring: block
// n + 1 loads while block n computes.  Only blocks that cross the
// diagonal, the window edge or Sk apply the mask.  Shared memory: Q 16
// KB + 2 x (K 16 KB + V 16 KB), so two blocks fit on an SM.
//
// Numerics: scores, m and l fp32; P rounded to bf16 before P . V (the TPU
// kernel's and the plain version's rounding); lse = m + log(max(l,
// 1e-30)).
//
// Bound on the H100: causal attention does 4 * B * H * D flops per
// attended (query, key) pair against 2 B per element of q, k, v and out:
// ~S / 4 flops per byte, so at S = 2048 the 989 TFLOP/s tensor-core rate
// sets the floor and at S = 1024 the bytes nearly do.

#include "attn_tile.cuh"

using namespace ds_attn;

struct FlashScore {
  int qp[2];   // positions of the thread's two rows
  int k0;      // position of key 0 of the block
  int seq_k;
  int causal;
  int window;  // <= 0: none
  float scale;

  template <bool MASK>
  __device__ __forceinline__ float apply(int j, int t, float dot) const {
    if (!MASK) return dot * scale;
    const int kp = k0 + t;
    bool keep = kp < seq_k;
    if (causal) keep = keep && qp[j] >= kp;
    if (window > 0) keep = keep && (qp[j] - kp) < window;
    return keep ? dot * scale : DS_MASK_VALUE;
  }
};

// Shared memory: the Q tile, then 2 stages of (K, V).
constexpr int kFlashSmem = 5 * kTileBytes + kSmemSlack;

__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Kh, int Sq, int Sk, long long q_sb, long long q_sh,
                 long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                 long long o_sh, long long o_ss, float scale, int causal,
                 int window) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_addr(smem);
  const int tid = threadIdx.x;
  // stage i: K at tile 1 + 2i, V at 2 + 2i
  auto k_tile = [&](int stage) { return q_s + (1 + 2 * stage) * kTileBytes; };
  auto v_tile = [&](int stage) { return k_tile(stage) + kTileBytes; };

  const int tile = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int q0 = tile * kRows;  // the block's first row

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  load_tile(q_s, qb, q_ss, q0, Sq);
  auto load_kv = [&](int blk, int stage) {
    load_tile_pair(k_tile(stage), kb, k_ss, v_tile(stage), vb, v_ss,
                   blk * kKeys, Sk);
  };

  // the band of key blocks the block's rows can see
  int hi = (Sk + kKeys - 1) / kKeys;
  if (causal) hi = min(hi, (q0 + kRows + kKeys - 1) / kKeys);
  const int lo = window > 0 ? max(0, (q0 - window + 1) / kKeys) : 0;

  if (lo < hi) load_kv(lo, 0);
  cp_async_commit();  // Q and the first block

  RowState st;
  st.init();
  const int r0 = frag_row();
  FlashScore score{{q0 + r0, q0 + r0 + 8}, 0, Sk, causal, window, scale};
  for (int blk = lo; blk < hi; ++blk) {
    const int stage = (blk - lo) & 1;
    if (blk + 1 < hi) load_kv(blk + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the block just requested
    fence_proxy_async();
    __syncthreads();
    const int k0 = blk * kKeys;
    score.k0 = k0;
    // every key visible to every row of the tile: no mask
    const bool interior = k0 + kKeys <= Sk &&
                          (!causal || k0 + kKeys - 1 <= q0) &&
                          (window <= 0 || q0 + kRows - 1 - k0 < window);
    if (interior)
      attend_block<false, false>(q_s, k_tile(stage), v_tile(stage), nullptr,
                                 st, score);
    else
      attend_block<true, false>(q_s, k_tile(stage), v_tile(stage), nullptr, st,
                                score);
    __syncthreads();  // the stage is free for the load two blocks on
  }
  cp_async_wait<0>();

  finish_rows(st);
  float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
  if ((tid & 3) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qp = q0 + r0 + 8 * j;
      if (qp < Sq) lb[qp] = st.m[j] + logf(fmaxf(st.l[j], 1e-30f));
    }
  }
  __syncthreads();      // Q is read by no wgmma any more
  store_out_tile(st, smem);
  __syncthreads();
  copy_out_tile(smem, out + b * o_sb + h * o_sh, o_ss, q0, Sq);
}

// causal: 0/1; window <= 0: no sliding window.
DS_EXPORT int flash_fwd_bf16(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int Kh, int Sq,
                             int Sk, long long q_sb, long long q_sh,
                             long long q_ss, long long k_sb, long long k_sh,
                             long long k_ss, long long v_sb, long long v_sh,
                             long long v_ss, long long o_sb, long long o_sh,
                             long long o_ss, float scale, int causal, int window,
                             void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kFlashSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + kRows - 1) / kRows, H, B);
  flash_fwd_kernel<<<grid, kThreads, kFlashSmem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Kh, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh,
      k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}
