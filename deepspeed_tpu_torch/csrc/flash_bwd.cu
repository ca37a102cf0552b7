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
// Per (q block, k block) pair both kernels recompute, in fp32:
//   s  = q k^T * scale, masked to DS_MASK_VALUE outside the band
//   p  = exp(s - lse)            dP = dO v^T
//   dS = p * (dP - delta) * scale
// then dK/dV add dS^T q and p^T dO, dQ adds dS k.
//
// dK/dV: grid (ceil(S / 64), Kh, B).  A block keeps its 64 keys and
// values in shared memory and the dK, dV sums in registers, and loops
// over the G = H / Kh query heads of its group and, for each, over the
// query blocks from the causal diagonal to the window's last block: the
// group sum that JAX gets by repeating K and V happens inside the block,
// with no atomics.
// dQ: grid (ceil(S / 64), H, B).  A block keeps 64 query rows, their dO,
// lse and delta, and loops over the key blocks of kv head h / G from the
// window's first block to the diagonal.
// Padding rows (S not a multiple of 64) are zero in shared memory and
// have p = 0, so they add nothing.
//
// Bound on the H100: operations.  The backward does five S x S products
// (s, dV, dP, dK, dQ), 2 * B * H * S^2 * D flops each, halved by the
// causal mask: at B = 2, H = 32, S = 2048 that is 172 GFLOP, 0.17 ms at
// 989 TFLOP/s, against 0.08 ms for the ~270 MB of q, k, v, o, dO, lse,
// delta, dq, dk and dv.  This kernel recomputes s and dP in both passes
// (seven products) on the fp32 FMA pipes, reading shared memory at about
// one load per two FMAs, so it sits far above that floor; mma / wgmma
// tiles with operands in registers are the later fix.  P and dS stay in
// fp32 (the TPU kernel rounds them to the input dtype before the
// products).

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kD = 128;               // head_dim
constexpr int kBlock = 64;            // query rows and keys per block
constexpr int kRow = kD + 1;          // row stride: row r starts r banks over
constexpr int kPRow = kBlock + 1;     // row stride of the p / dS tiles

// 64 rows of a [.., S, D] bf16 operand -> fp32 shared memory, rows at or
// past n_rows zero.
__device__ void load_rows(float* dst, const __nv_bfloat16* src,
                          long long row_stride, int row0, int n_rows) {
  for (int c = threadIdx.x; c < kBlock * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), chunk = c % (kD / 8);
    const int row = row0 + r;
    float f[8];
    if (row < n_rows) {
      ds_bf16x8_to_float(*reinterpret_cast<const uint4*>(
                             src + static_cast<long long>(row) * row_stride +
                             chunk * 8),
                         f);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * kRow + chunk * 8 + j] = f[j];
  }
}

// lse and delta of 64 query rows (0 past the end: those rows have p = 0).
__device__ void load_row_stats(float* lse_s, float* delta_s, const float* lse,
                               const float* delta, int q0, int Sq) {
  for (int r = threadIdx.x; r < kBlock; r += kThreads) {
    const bool ok = q0 + r < Sq;
    lse_s[r] = ok ? lse[q0 + r] : 0.f;
    delta_s[r] = ok ? delta[q0 + r] : 0.f;
  }
}

struct Band {
  int Sq, Sk, causal, window;  // window <= 0: none
  __device__ bool keep(int qp, int kp) const {
    bool k = qp < Sq && kp < Sk;
    if (causal) k = k && qp >= kp;
    if (window > 0) k = k && (qp - kp) < window;
    return k;
  }
};

// Thread (ty, tx) = (tid / 16, tid % 16) owns rows a = ty + 16 i and
// columns b = tx + 16 j (i, j < 4) of the 64 x 64 block: p and dS for
// them, from s = q . k and dP = dO . v over D.  K and V rows sit 129
// floats apart, so the 16 threads reading 16 rows at one d hit 16 banks.
__device__ __forceinline__ void p_and_ds(const float* qs, const float* dos,
                                         const float* ks, const float* vs,
                                         const float* lse_s,
                                         const float* delta_s, int q0, int k0,
                                         const Band& band, float scale,
                                         float (&p)[4][4], float (&ds)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < kD; ++d) {
    float qa[4], da[4], kb[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = qs[(ty + 16 * i) * kRow + d];
      da[i] = dos[(ty + 16 * i) * kRow + d];
      kb[i] = ks[(tx + 16 * i) * kRow + d];
      vb[i] = vs[(tx + 16 * i) * kRow + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
        dp[i][j] = fmaf(da[i], vb[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = tx + 16 * j;
      // masked entries: exp(DS_MASK_VALUE - lse) underflows to 0
      p[i][j] = band.keep(q0 + a, k0 + b) ? expf(s[i][j] * scale - lse_s[a])
                                          : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta_s[a]) * scale;
    }
  }
}

struct DkvSmem {
  static constexpr int tile = kBlock * kRow;
  static constexpr int ptile = kBlock * kPRow;
  static constexpr int floats = 4 * tile + 2 * ptile + 2 * kBlock;
  static constexpr size_t bytes = floats * sizeof(float);
};

struct DqSmem {
  static constexpr int tile = kBlock * kRow;
  static constexpr int ptile = kBlock * kPRow;
  static constexpr int floats = 4 * tile + ptile + 2 * kBlock;
  static constexpr size_t bytes = floats * sizeof(float);
};

struct Strides {
  long long b, h, s;
};

__global__ void __launch_bounds__(kThreads, 1)
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
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + DkvSmem::tile;
  float* ks = dos + DkvSmem::tile;
  float* vs = ks + DkvSmem::tile;
  float* ps = vs + DkvSmem::tile;
  float* dss = ps + DkvSmem::ptile;
  float* lse_s = dss + DkvSmem::ptile;
  float* delta_s = lse_s + kBlock;

  const int kb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / Kh;
  const int k0 = kb * kBlock;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows(ks, k + b * kst.b + kvh * kst.h, kst.s, k0, band.Sk);
  load_rows(vs, v + b * vst.b + kvh * vst.h, vst.s, k0, band.Sk);

  // the q blocks that see this key block (_bwd_dkv_kernel's bounds)
  const int nq = (band.Sq + kBlock - 1) / kBlock;
  const int q_lo = band.causal ? k0 / kBlock : 0;
  int q_hi = nq;
  if (band.window > 0)
    q_hi = min(q_hi, (k0 + kBlock - 1 + band.window - 1) / kBlock + 1);

  // thread owns key rows ty + 16 i and columns tx + 16 j of dK and dV
  float dk_acc[4][8], dv_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float* lse_h = lse + (static_cast<size_t>(b) * H + h) * band.Sq;
    const float* delta_h = delta + (static_cast<size_t>(b) * H + h) * band.Sq;
    for (int qb = q_lo; qb < q_hi; ++qb) {
      const int q0 = qb * kBlock;
      __syncthreads();  // the previous block's readers are done
      load_rows(qs, q + b * qst.b + h * qst.h, qst.s, q0, band.Sq);
      load_rows(dos, dout + b * dost.b + h * dost.h, dost.s, q0, band.Sq);
      load_row_stats(lse_s, delta_s, lse_h, delta_h, q0, band.Sq);
      __syncthreads();
      float p[4][4], ds[4][4];
      p_and_ds(qs, dos, ks, vs, lse_s, delta_s, q0, k0, band, scale, p, ds);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(ty + 16 * i) * kPRow + tx + 16 * j] = p[i][j];
          dss[(ty + 16 * i) * kPRow + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dV += p^T dO, dK += dS^T q over the block's 64 query rows
      for (int r = 0; r < kBlock; ++r) {
        float pk[4], sk[4], od[8], qd[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pk[i] = ps[r * kPRow + ty + 16 * i];
          sk[i] = dss[r * kPRow + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          od[j] = dos[r * kRow + tx + 16 * j];
          qd[j] = qs[r * kRow + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            dv_acc[i][j] = fmaf(pk[i], od[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(sk[i], qd[j], dk_acc[i][j]);
          }
      }
    }
  }

  const size_t base = (static_cast<size_t>(b) * Kh + kvh) * band.Sk;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row < band.Sk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t at = (base + row) * kD + tx + 16 * j;
        dk[at] = __float2bfloat16(dk_acc[i][j]);
        dv[at] = __float2bfloat16(dv_acc[i][j]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dq, int H, int Kh, Strides qst,
                    Strides kst, Strides vst, Strides dost, Band band,
                    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + DqSmem::tile;
  float* ks = dos + DqSmem::tile;
  float* vs = ks + DqSmem::tile;
  float* dss = vs + DqSmem::tile;
  float* lse_s = dss + DqSmem::ptile;
  float* delta_s = lse_s + kBlock;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / Kh);
  const int q0 = qb * kBlock;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  load_rows(qs, q + b * qst.b + h * qst.h, qst.s, q0, band.Sq);
  load_rows(dos, dout + b * dost.b + h * dost.h, dost.s, q0, band.Sq);
  load_row_stats(lse_s, delta_s,
                 lse + (static_cast<size_t>(b) * H + h) * band.Sq,
                 delta + (static_cast<size_t>(b) * H + h) * band.Sq, q0,
                 band.Sq);

  // the key blocks this query block sees (_bwd_dq_kernel's bounds)
  int k_hi = (band.Sk + kBlock - 1) / kBlock;
  if (band.causal) k_hi = min(k_hi, (q0 + 2 * kBlock - 1) / kBlock);
  const int k_lo =
      band.window > 0 ? max(0, (q0 - band.window + 1) / kBlock) : 0;

  // thread owns query rows ty + 16 i and columns tx + 16 j of dQ
  float dq_acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dq_acc[i][j] = 0.f;

  const __nv_bfloat16* kbase = k + b * kst.b + kvh * kst.h;
  const __nv_bfloat16* vbase = v + b * vst.b + kvh * vst.h;
  for (int kb = k_lo; kb < k_hi; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous block's readers are done
    load_rows(ks, kbase, kst.s, k0, band.Sk);
    load_rows(vs, vbase, vst.s, k0, band.Sk);
    __syncthreads();
    float p[4][4], ds[4][4];
    p_and_ds(qs, dos, ks, vs, lse_s, delta_s, q0, k0, band, scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(ty + 16 * i) * kPRow + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dQ += dS k over the block's 64 keys
    for (int t = 0; t < kBlock; ++t) {
      float sq[4], kd[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) sq[i] = dss[(ty + 16 * i) * kPRow + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) kd[j] = ks[t * kRow + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) dq_acc[i][j] = fmaf(sq[i], kd[j], dq_acc[i][j]);
    }
  }

  const size_t base = (static_cast<size_t>(b) * H + h) * band.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < band.Sq) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dq[(base + row) * kD + tx + 16 * j] = __float2bfloat16(dq_acc[i][j]);
    }
  }
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
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
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel, DkvSmem::bytes, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sk + kBlock - 1) / kBlock, Kh, B);
  flash_bwd_dkv_kernel<<<grid, kThreads, DkvSmem::bytes,
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
  cudaError_t e = allow_smem(flash_bwd_dq_kernel, DqSmem::bytes, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((Sq + kBlock - 1) / kBlock, H, B);
  flash_bwd_dq_kernel<<<grid, kThreads, DqSmem::bytes,
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
