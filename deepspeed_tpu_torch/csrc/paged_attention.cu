// Ragged paged attention: [S, Q] new query tokens per slot over their
// paged KV context.
//
// Replaces: deepspeed_tpu/ops/paged_attention.py:_decode_kernel (the
// Pallas kernel behind paged_decode_attention).
//
// Layout (the JAX package's):
//   q          [S, Q, H, D]               bf16, H = K * G
//   kv         [num_pages + 1, page, 2, K, D] bf16, page 0 = null page
//              or, for paged_attention_int8 (the TPU kernel's has_scale
//              specialisation), int8 codes at that shape plus fp32
//              scales [num_pages + 1, page, 2, K], one per token and kv
//              head; the page is dequantised in shared memory
//              (attn_tile.cuh: Int8Stage), never in device memory
//   page_table [S, P] int32, start_pos [S] int32
//   out        [S, Q, H, D]               bf16
// Row r of a slot's (kv head k) problem is query r / G, group r % G
// (head k*G + r%G); its causal limit is start_pos + r/G + 1 keys, and
// with a sliding window it sees keys >= limit - window.
//
// Grid: one block per (tile of up to 64 folded rows, kv head, slot).
// The TPU grid walks pages sequentially with m/l/acc in VMEM scratch;
// here that walk is the loop inside the block, since CUDA blocks run in
// parallel and in no order.  Each block reads its own page_table entries
// (no scalar prefetch) and visits pages from the first page inside the
// window to the last page below start_pos + (last row's query) + 1, so
// pages past a slot's causal limit -- the null page absorbs padding
// writes and holds garbage -- are never read for rows that cannot see
// them.  Each [page=64, D=128] K and V page is staged through shared
// memory once per block and the online softmax runs in fp32.
//
// Bound on the H100: bytes.  A decode step reads every context token's K
// and V once (context tokens x 2 x K x D x 2 B, or x (D + 4) B for int8
// codes with their scales) plus q and out; at 3.35 TB/s that is the
// floor.  The FMA work is ~2 flops per byte read for Q = 1, far below
// the ~295 flop/byte ridge.
// Known weakness: with small S * K and Q = 1 the grid (S * K blocks)
// underfills the 132 SMs and one block walks the whole context; a
// flash-decoding split over page chunks plus a reduce pass is the fix.
// Window and ALiBi are template parameters, as the TPU kernel
// specialises them statically.

#include "attn_tile.cuh"

using namespace ds_attn;

template <bool WINDOW, bool ALIBI>
struct PagedScore {
  int ctx0;          // absolute position of key 0 of this page
  int n_keys;        // valid keys in the page (= page size)
  int start;         // start_pos of the slot
  int row0;          // folded row index of the tile's row 0
  int groups;
  int window;
  float scale;
  const float* slopes;  // [G] for this kv head (ALIBI only)

  __device__ float operator()(int r, int t, float dot) const {
    const int row = row0 + r;
    const int ctx = ctx0 + t;
    const int ctx_len = start + row / groups + 1;
    float s = dot * scale;
    if (ALIBI) s += slopes[row % groups] * static_cast<float>(ctx);
    bool keep = t < n_keys && ctx < ctx_len;
    if (WINDOW) keep = keep && ctx >= ctx_len - window;
    return keep ? s : DS_MASK_VALUE;
  }
};

template <int ROWS, bool WINDOW, bool ALIBI, bool INT8>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const void* __restrict__ kv,
                       const float* __restrict__ kv_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ start_pos,
                       const float* __restrict__ slopes,
                       __nv_bfloat16* __restrict__ out, int Q, int H, int K,
                       int P, int page_size, float scale, int window) {
  extern __shared__ float smem[];
  Tile<ROWS> T(smem);
  const int tile = blockIdx.x, k = blockIdx.y, s = blockIdx.z;
  const int G = H / K;
  const int R = Q * G;
  const int row0 = tile * ROWS;
  const int start = start_pos[s];

  for (int c = threadIdx.x; c < ROWS * (kHeadDim / 8); c += kThreads) {
    const int r = c / (kHeadDim / 8), chunk = c % (kHeadDim / 8);
    const int row = row0 + r;
    const __nv_bfloat16* src = nullptr;
    if (row < R) {
      const int qi = row / G, h = k * G + row % G;
      src = q + ((static_cast<size_t>(s) * Q + qi) * H + h) * kHeadDim;
    }
    T.store_q_chunk(r, chunk, src);
  }
  T.init_stats();

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  const int last_row = min(row0 + ROWS, R) - 1;
  int p_hi = (start + last_row / G + 1 + page_size - 1) / page_size;
  p_hi = min(p_hi, P);
  int p_lo = 0;
  if (WINDOW) {
    const int first_key = start + row0 / G + 1 - window;
    p_lo = first_key > 0 ? first_key / page_size : 0;
  }
  // elements (bf16 values or int8 codes) from one token to the next
  const size_t token_stride = static_cast<size_t>(2) * K * kHeadDim;
  const float* head_slopes = ALIBI ? slopes + k * G : nullptr;

  for (int p = p_lo; p < p_hi; ++p) {
    const int page = page_table[s * P + p];
    const size_t page_off =
        static_cast<size_t>(page) * page_size * token_stride + k * kHeadDim;
    __syncthreads();  // the previous page is no longer read
    if constexpr (INT8) {
      Int8Stage stage(smem + SmemLayout<ROWS>::floats);
      const int8_t* base = static_cast<const int8_t*>(kv) + page_off;
      for (int c = threadIdx.x; c < kKeys * (kHeadDim / 16); c += kThreads) {
        const int t = c / (kHeadDim / 16), chunk = c % (kHeadDim / 16);
        const int8_t* krow = t < page_size ? base + t * token_stride : nullptr;
        stage.load_chunk(t, chunk, krow,
                         krow != nullptr ? krow + K * kHeadDim : nullptr);
      }
      // scales [page, slot, 0|1, k]: no head_dim axis
      const float* sc =
          kv_scale + static_cast<size_t>(page) * page_size * 2 * K + k;
      for (int t = threadIdx.x; t < kKeys; t += kThreads) {
        const bool live = t < page_size;
        stage.k_scale[t] = live ? sc[static_cast<size_t>(t) * 2 * K] : 0.f;
        stage.v_scale[t] = live ? sc[static_cast<size_t>(t) * 2 * K + K] : 0.f;
      }
      __syncthreads();
      stage.dequantize(T);
    } else {
      const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(kv) + page_off;
      for (int c = threadIdx.x; c < kKeys * (kHeadDim / 8); c += kThreads) {
        const int t = c / (kHeadDim / 8), chunk = c % (kHeadDim / 8);
        const __nv_bfloat16* krow = nullptr;
        const __nv_bfloat16* vrow = nullptr;
        if (t < page_size) {
          krow = base + t * token_stride;
          vrow = krow + K * kHeadDim;
        }
        T.store_kv_chunk(t, chunk, krow, vrow);
      }
    }
    __syncthreads();
    PagedScore<WINDOW, ALIBI> score{p * page_size, page_size, start, row0,
                                    G, window, scale, head_slopes};
    attend_block<ROWS>(T, acc, score);
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = row0 + r;
    if (row < R) {
      const int qi = row / G, h = k * G + row % G;
      const float o = acc[r] / fmaxf(T.l[r], 1e-30f);
      out[((static_cast<size_t>(s) * Q + qi) * H + h) * kHeadDim + threadIdx.x] =
          __float2bfloat16(o);
    }
  }
}

// Everything a launch needs besides its template parameters.
struct PagedArgs {
  const void* q;
  const void* kv;
  const void* kv_scale;  // int8 pages only
  const void* page_table;
  const void* start_pos;
  const void* slopes;    // nullptr: no ALiBi
  void* out;
  int S, Q, H, K, P, page_size;
  float scale;
  int window;            // <= 0: no sliding window
  cudaStream_t stream;
};

template <int ROWS, bool WINDOW, bool ALIBI, bool INT8>
static int launch(const PagedArgs& a) {
  auto kernel = paged_attention_kernel<ROWS, WINDOW, ALIBI, INT8>;
  constexpr size_t smem =
      SmemLayout<ROWS>::bytes + (INT8 ? Int8Stage::bytes : 0);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int R = a.Q * (a.H / a.K);
  dim3 grid((R + ROWS - 1) / ROWS, a.K, a.S);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.kv,
      static_cast<const float*>(a.kv_scale),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.start_pos),
      static_cast<const float*>(a.slopes), static_cast<__nv_bfloat16*>(a.out),
      a.Q, a.H, a.K, a.P, a.page_size, a.scale, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <bool WINDOW, bool ALIBI, bool INT8>
static int dispatch_rows(const PagedArgs& a) {
  const int rows = a.Q * (a.H / a.K);
  if (rows <= 1) return launch<1, WINDOW, ALIBI, INT8>(a);
  if (rows <= 4) return launch<4, WINDOW, ALIBI, INT8>(a);
  if (rows <= 16) return launch<16, WINDOW, ALIBI, INT8>(a);
  return launch<64, WINDOW, ALIBI, INT8>(a);
}

template <bool INT8>
static int dispatch(const PagedArgs& a) {
  const bool win = a.window > 0, alibi = a.slopes != nullptr;
  if (win && alibi) return dispatch_rows<true, true, INT8>(a);
  if (win) return dispatch_rows<true, false, INT8>(a);
  if (alibi) return dispatch_rows<false, true, INT8>(a);
  return dispatch_rows<false, false, INT8>(a);
}

// window <= 0: no sliding window; slopes == nullptr: no ALiBi.
DS_EXPORT int paged_attention_bf16(const void* q, const void* kv,
                                   const void* page_table, const void* start_pos,
                                   const void* slopes, void* out, int S, int Q,
                                   int H, int K, int P, int page_size,
                                   float scale, int window, void* stream) {
  return dispatch<false>({q, kv, nullptr, page_table, start_pos, slopes, out, S,
                          Q, H, K, P, page_size, scale, window,
                          static_cast<cudaStream_t>(stream)});
}

// kv: int8 codes [num_pages + 1, page, 2, K, D]; kv_scale: fp32
// [num_pages + 1, page, 2, K].
DS_EXPORT int paged_attention_int8(const void* q, const void* kv,
                                   const void* kv_scale, const void* page_table,
                                   const void* start_pos, const void* slopes,
                                   void* out, int S, int Q, int H, int K, int P,
                                   int page_size, float scale, int window,
                                   void* stream) {
  return dispatch<true>({q, kv, kv_scale, page_table, start_pos, slopes, out, S,
                         Q, H, K, P, page_size, scale, window,
                         static_cast<cudaStream_t>(stream)});
}
