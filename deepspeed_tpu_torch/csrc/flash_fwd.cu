// Flash attention forward: blockwise causal / sliding-window attention
// that never materialises the S x S score matrix, emitting out and the
// log-sum-exp (the backward, a later port, needs the LSE).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py:_fwd_kernel (via
// _flash_fwd).  Serving runs it on the pure-prefill ("fresh") step,
// once per layer, where every slot's context is its own new tokens.
//
// Layout: q [B, H, Sq, D], k / v [B, Kh, Sk, D] given by element strides
// (so transposed views of the model's [B, S, H, D] activations need no
// copy; the last dim must be contiguous), out [B, H, Sq, D] by strides,
// lse [B, H, Sq] fp32 contiguous.  GQA: query head h reads kv head
// h / (H / Kh) inside the kernel instead of repeating K and V in memory.
//
// Grid (ceil(Sq / 64), H, B): a block owns 64 query rows in shared
// memory and loops over 64-wide key blocks from the window's lower block
// to the causal diagonal (blocks wholly outside the band are skipped,
// the _band_keep bounds of the TPU kernel).  Scores and the online
// softmax are fp32; the products are plain FMAs.
//
// Bound on the H100: bytes and operations are close.  Causal attention
// does ~2 * B * H * Sq^2 * D flops (QK^T and PV over the lower triangle)
// against 4 * B * H * S * D * 2 bytes of q, k, v and out: S / 4 flop per
// byte, ~256 at S = 1024, just under the ~295 bf16 ridge, so the bytes
// (3.35 TB/s) set the floor there and the 989 TFLOP/s tensor-core rate
// sets it for longer prompts.  This kernel runs on the fp32 FMA pipes
// and reads shared memory once per FMA, so it sits far above either
// floor; mma / wgmma tiles with operands in registers are the later fix.

#include "attn_tile.cuh"

using namespace ds_attn;

struct FlashScore {
  int q0;      // position of the tile's row 0
  int k0;      // position of key 0 of this block
  int seq_k;
  int causal;
  int window;  // <= 0: none
  float scale;

  __device__ float operator()(int r, int t, float dot) const {
    const int qp = q0 + r, kp = k0 + t;
    bool keep = kp < seq_k;
    if (causal) keep = keep && qp >= kp;
    if (window > 0) keep = keep && (qp - kp) < window;
    return keep ? dot * scale : DS_MASK_VALUE;
  }
};

__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 int H, int Kh, int Sq, int Sk, long long q_sb, long long q_sh,
                 long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss, long long o_sb,
                 long long o_sh, long long o_ss, float scale, int causal,
                 int window) {
  constexpr int ROWS = 64;
  extern __shared__ float smem[];
  Tile<ROWS> T(smem);
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int q0 = tile * ROWS;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  for (int c = threadIdx.x; c < ROWS * (kHeadDim / 8); c += kThreads) {
    const int r = c / (kHeadDim / 8), chunk = c % (kHeadDim / 8);
    const int qp = q0 + r;
    T.store_q_chunk(r, chunk, qp < Sq ? qb + qp * q_ss : nullptr);
  }
  T.init_stats();

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  const int n_blocks = (Sk + kKeys - 1) / kKeys;
  int hi = n_blocks;
  if (causal) hi = min(hi, (q0 + ROWS + kKeys - 1) / kKeys);
  int lo = 0;
  if (window > 0) lo = max(0, (q0 - window + 1) / kKeys);

  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
  for (int blk = lo; blk < hi; ++blk) {
    const int k0 = blk * kKeys;
    __syncthreads();
    for (int c = threadIdx.x; c < kKeys * (kHeadDim / 8); c += kThreads) {
      const int t = c / (kHeadDim / 8), chunk = c % (kHeadDim / 8);
      const int kp = k0 + t;
      const bool ok = kp < Sk;
      T.store_kv_chunk(t, chunk, ok ? kb + kp * k_ss : nullptr,
                       ok ? vb + kp * v_ss : nullptr);
    }
    __syncthreads();
    FlashScore score{q0, k0, Sk, causal, window, scale};
    attend_block<ROWS>(T, acc, score);
  }
  __syncthreads();

  __nv_bfloat16* ob = out + b * o_sb + h * o_sh;
  float* lb = lse + (static_cast<size_t>(b) * H + h) * Sq;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qp = q0 + r;
    if (qp < Sq) {
      const float l = fmaxf(T.l[r], 1e-30f);
      ob[qp * o_ss + threadIdx.x] = __float2bfloat16(acc[r] / l);
      if (threadIdx.x == 0) lb[qp] = T.m[r] + logf(l);
    }
  }
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
  constexpr size_t smem = SmemLayout<64>::bytes;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  dim3 grid((Sq + 63) / 64, H, B);
  flash_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Kh, Sq, Sk, q_sb, q_sh, q_ss, k_sb, k_sh,
      k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}
