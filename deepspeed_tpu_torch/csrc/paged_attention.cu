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
//              head; pages are dequantised on the chip, never in device
//              memory
//   page_table [S, P] int32, start_pos [S] int32
//   out        [S, Q, H, D]               bf16
// Row r of a slot's (kv head k) problem is query r / G, group r % G
// (head k*G + r%G); its causal limit is start_pos + r/G + 1 keys, and
// with a sliding window it sees keys >= limit - window.  Pages past a
// block's last causal row, or wholly below its first row's window, are
// never read (the null page absorbs padding writes and holds garbage).
// Window and ALiBi are template parameters, as the TPU kernel
// specialises them statically, and so is the head dim D (64, 80, 96 or
// 128: the entry points refuse any other with cudaErrorInvalidValue).
//
// Two regimes, by the folded rows R = Q * G of a (slot, kv head):
//
// * R >= kDecodeRows (prefill chunks, speculative or GQA rows): the
//   tensor-core tile of attn_tile.cuh, grid (ceil(R / 64), K, S).  A key
//   block is one page, gathered through page_table with cp.async into a
//   2-stage ring (the next page loads while this one computes) and
//   zero-padded to 64 keys.  Bound: operations (4 D flops per attended
//   pair, ~Q / 2 flops per byte of KV), at the 989 TFLOP/s bf16 rate.
//   int8 pages: codes and scales go to a staging ring; K is dequantised
//   to bf16(code * scale) into the swizzled K tile, as the TPU kernel
//   does; V's codes become the bf16 operand and its scale is folded into
//   P: P'[r, t] = bf16(p[r, t] * v_scale[t]) (the TPU kernel multiplies
//   fp32 p by fp32 V; codes of magnitude <= 127 are exact in bf16).
//
// * R < kDecodeRows (decode): split-KV (flash-decoding) on the CUDA
//   cores, grid (n_split, K, S), where the wrapper picks n_split from
//   S * K and the page-table width so that the grid covers the SMs
//   several times over.  Bound: bytes (~2 flops per byte of KV at R = 1,
//   against a ~295 flop/byte ridge).  Each block walks its share of the
//   pages through a 2-stage cp.async ring (16-byte copies, neighbouring
//   threads on neighbouring addresses, two pages in flight), the G rows
//   of a kv head sharing each page read, and writes fp32 partials
//   (unnormalised acc, m, l) to a workspace; paged_attention_combine
//   then gives out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i.  A
//   split with no keys writes m = -inf, l = 0 and weighs 0.  With one
//   split (n_split == 1) the kernel writes out = acc / l itself, the
//   combine's result for one split, and no combine runs.  P is
//   rounded to bf16 before P . V over bf16 pages; over int8 pages the
//   codes are dequantised in registers, K to bf16(code * scale) and V
//   times fp32 p * v_scale, as the TPU kernel.
//
// Scores, m and l are fp32 everywhere.
//
// Head dims below 128: the tile path pads its tiles to round_up(D, 64)
// columns of zeros (attn_tile.cuh); the split path's threads d >= D sit
// out the P . V sum; int8 staging keeps 128-byte code rows of which the
// first D bytes are copied.

#include "attn_tile.cuh"

using namespace ds_attn;

constexpr int kDecodeRows = 16;  // R below this takes the split-KV path

template <bool WINDOW, bool ALIBI>
struct PagedScore {
  int ctx_len[2];  // causal limit (keys) of the thread's two rows
  float slope[2];
  int ctx0;        // position of key 0 of the page
  int n_keys;      // keys in a page
  int window;
  float scale;

  template <bool MASK>
  __device__ __forceinline__ float apply(int j, int t, float dot) const {
    const int ctx = ctx0 + t;
    float s = dot * scale;
    if (ALIBI) s += slope[j] * static_cast<float>(ctx);
    if (!MASK) return s;
    bool keep = t < n_keys && ctx < ctx_len[j];
    if (WINDOW) keep = keep && ctx >= ctx_len[j] - window;
    return keep ? s : DS_MASK_VALUE;
  }
};

// Pages [lo, hi) that rows [first, last] of a slot can see.
template <bool WINDOW>
__device__ __forceinline__ void page_range(int start, int first, int last,
                                           int G, int P, int page_size,
                                           int window, int& lo, int& hi) {
  hi = min(P, (start + last / G + 1 + page_size - 1) / page_size);
  lo = 0;
  if (WINDOW) {
    const int first_key = start + first / G + 1 - window;
    lo = first_key > 0 ? first_key / page_size : 0;
  }
}

// One int8 page in staging: K codes [64][128], V codes [64][128] (rows of
// 128 bytes whatever D: the first D hold codes), K and V scales [64] each.
constexpr int kCodeRow = 128;
constexpr int kCodeBytes = kKeys * kCodeRow;
constexpr int kInt8StageBytes = 2 * kCodeBytes + 2 * kKeys * 4;

// 16 int8 codes (one 16-byte word) as floats.  Each 32-bit part is
// picked by a select, never an array index (an indexed local array of
// the four parts went to the stack where a loop around it was not
// unrolled).
__device__ __forceinline__ void codes16(const uint4& w, float* f) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint32_t part = i < 4 ? w.x : i < 8 ? w.y : i < 12 ? w.z : w.w;
    f[i] = static_cast<float>(static_cast<signed char>(part >> (8 * (i & 3))));
  }
}

// Copies one page's int8 codes and scales (kv head k) into a staging
// area, D / 16 16-byte chunks a row; rows past page_size are zero (codes
// 0, scale 0).  With swizzle_k, K's chunk c of row t lands at chunk
// c ^ (t % 8) of its 128-byte row.
template <int D>
__device__ __forceinline__ void stage_int8_page(
    uint32_t stage, const int8_t* codes, const float* scales, int page,
    int page_size, int K, size_t token_stride, int k, bool swizzle_k) {
  constexpr int kChunks = D / 16;
  const int8_t* base =
      codes + static_cast<size_t>(page) * page_size * token_stride + k * D;
  for (unsigned c = threadIdx.x; c < kKeys * kChunks; c += kThreads) {
    const int t = c / kChunks, chunk = c % kChunks;
    const bool ok = t < page_size;
    const int8_t* row = base + (ok ? t : 0) * token_stride + chunk * 16;
    const int kc = swizzle_k ? (chunk ^ (t & 7)) : chunk;
    cp_async16(stage + t * kCodeRow + kc * 16, row, ok);
    cp_async16(stage + kCodeBytes + t * kCodeRow + chunk * 16, row + K * D, ok);
  }
  // scales [page, slot, 0|1, k]: no head_dim axis
  const float* sc = scales + static_cast<size_t>(page) * page_size * 2 * K + k;
  const int t = threadIdx.x & (kKeys - 1), kv = threadIdx.x >> 6;  // 0: K, 1: V
  const bool ok = t < page_size;
  cp_async4(stage + 2 * kCodeBytes + (kv * kKeys + t) * 4,
            sc + static_cast<size_t>(ok ? t : 0) * 2 * K + kv * K, ok);
}

// ---------------------------------------------------------------------------
// multi-row path: the tensor-core tile
// ---------------------------------------------------------------------------

template <int D, bool INT8>
struct TileSmem {
  // bf16: Q, then 2 stages of (K, V).  int8: Q, one (K, V) pair, then a
  // 2-stage staging ring of codes and scales.
  static constexpr int tile = Width<D>::tile_bytes;
  static constexpr int bytes =
      (INT8 ? 3 * tile + 2 * kInt8StageBytes : 5 * tile) + kSmemSlack;
};

template <int D, bool WINDOW, bool ALIBI, bool INT8>
__global__ void __launch_bounds__(kThreads, 2)
paged_tile_kernel(const __nv_bfloat16* __restrict__ q,
                  const void* __restrict__ kv,
                  const float* __restrict__ kv_scale,
                  const int* __restrict__ page_table,
                  const int* __restrict__ start_pos,
                  const float* __restrict__ slopes,
                  __nv_bfloat16* __restrict__ out, int Q, int H, int K, int P,
                  int page_size, float scale, int window) {
  using W = Width<D>;
  constexpr int kTile = W::tile_bytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const uint32_t q_s = smem_addr(smem);
  const int tile = blockIdx.x, k = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int G = H / K, R = Q * G;
  const int row0 = tile * kRows;
  const int last_row = min(row0 + kRows, R) - 1;
  const int start = start_pos[s];
  const int* table = page_table + static_cast<size_t>(s) * P;
  // elements (bf16 values or int8 codes) from one token to the next
  const size_t token_stride = static_cast<size_t>(2) * K * D;

  // Q rows, padding columns D..DP-1 zero-filled
  for (unsigned c = tid; c < kRows * W::tile_chunks; c += kThreads) {
    const int r = c / W::tile_chunks, chunk = c % W::tile_chunks,
              row = row0 + r;
    const bool ok = row < R && chunk < W::chunks;
    const size_t off =
        ok ? ((static_cast<size_t>(s) * Q + row / G) * H + k * G + row % G) *
                     D + chunk * 8
           : 0;
    cp_async16(q_s + swz(r, chunk), q + off, ok);
  }

  // bf16: stage i holds K at tile 1 + 2i and V at 2 + 2i; int8: K and V
  // at tiles 1 and 2, staging after them
  const uint32_t staging = q_s + 3 * kTile;
  auto k_tile = [&](int stage) {
    return INT8 ? q_s + kTile : q_s + (1 + 2 * stage) * kTile;
  };
  auto v_tile = [&](int stage) { return k_tile(stage) + kTile; };
  auto load_page = [&](int p, int stage) {
    const int page = table[p];
    if constexpr (INT8) {
      stage_int8_page<D>(staging + stage * kInt8StageBytes,
                         static_cast<const int8_t*>(kv), kv_scale, page,
                         page_size, K, token_stride, k, false);
    } else {
      const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(kv) +
                                  static_cast<size_t>(page) * page_size *
                                      token_stride +
                                  k * D;
      for (unsigned c = tid; c < kKeys * W::tile_chunks; c += kThreads) {
        const int t = c / W::tile_chunks, chunk = c % W::tile_chunks;
        const bool ok = t < page_size && chunk < W::chunks;
        const __nv_bfloat16* row = base + (ok ? t * token_stride + chunk * 8 : 0);
        cp_async16(k_tile(stage) + swz(t, chunk), row, ok);
        cp_async16(v_tile(stage) + swz(t, chunk), row + K * D, ok);
      }
    }
  };
  if constexpr (INT8 && W::chunks < W::tile_chunks) {
    // the dequantised K and V tiles are written a page at a time, their
    // D columns only: the padding columns are zeroed once (the fence
    // before the first page's barrier publishes them to the tensor cores)
    constexpr int kPad = W::tile_chunks - W::chunks;
    for (unsigned c = tid; c < 2 * kKeys * kPad; c += kThreads) {
      const int t = (c / kPad) % kKeys, chunk = W::chunks + c % kPad;
      *reinterpret_cast<uint4*>(smem + (c < kKeys * kPad ? kTile : 2 * kTile) +
                                swz(t, chunk)) = make_uint4(0, 0, 0, 0);
    }
  }

  int p_lo, p_hi;
  page_range<WINDOW>(start, row0, last_row, G, P, page_size, window, p_lo, p_hi);
  if (p_lo < p_hi) load_page(p_lo, 0);
  cp_async_commit();  // Q and the first page

  RowState<D> st;
  st.init();
  const int r0 = frag_row();
  PagedScore<WINDOW, ALIBI> score;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int row = row0 + r0 + 8 * j;  // rows past R compute unused values
    score.ctx_len[j] = start + row / G + 1;
    score.slope[j] = ALIBI ? slopes[k * G + row % G] : 0.f;
  }
  score.n_keys = page_size;
  score.window = window;
  score.scale = scale;
  const int min_len = start + row0 / G + 1, max_len = start + last_row / G + 1;

  for (int p = p_lo; p < p_hi; ++p) {
    const int stage = (p - p_lo) & 1;
    if (p + 1 < p_hi) load_page(p + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    const float* v_scale = nullptr;
    if constexpr (INT8) {
      __syncthreads();
      // codes -> bf16 tiles: K = bf16(code * scale), V = bf16(code)
      constexpr int kGroups = D / 16;  // 16-code words of a row
      const uint8_t* area = smem + 3 * kTile + stage * kInt8StageBytes;
      const float* k_scale = reinterpret_cast<const float*>(area + 2 * kCodeBytes);
      v_scale = k_scale + kKeys;
      for (unsigned c = tid; c < kKeys * kGroups; c += kThreads) {
        const int t = c / kGroups, g = c % kGroups;
        float f[16];
        codes16(*reinterpret_cast<const uint4*>(area + t * kCodeRow + g * 16),
                f);
        const float ks = k_scale[t];
#pragma unroll
        for (int i = 0; i < 16; ++i) f[i] *= ks;
        *reinterpret_cast<uint4*>(smem + kTile + swz(t, 2 * g)) =
            ds_float8_to_bf16(f);
        *reinterpret_cast<uint4*>(smem + kTile + swz(t, 2 * g + 1)) =
            ds_float8_to_bf16(f + 8);
        codes16(*reinterpret_cast<const uint4*>(area + kCodeBytes +
                                                t * kCodeRow + g * 16), f);
        *reinterpret_cast<uint4*>(smem + 2 * kTile + swz(t, 2 * g)) =
            ds_float8_to_bf16(f);
        *reinterpret_cast<uint4*>(smem + 2 * kTile + swz(t, 2 * g + 1)) =
            ds_float8_to_bf16(f + 8);
      }
    }
    fence_proxy_async();
    __syncthreads();
    const int ctx0 = p * page_size;
    score.ctx0 = ctx0;
    // every key of the page visible to every row of the tile: no mask
    const bool interior = page_size == kKeys && ctx0 + kKeys <= min_len &&
                          (!WINDOW || ctx0 >= max_len - window);
    if (interior)
      attend_block<false, INT8>(q_s, k_tile(stage), v_tile(stage), v_scale, st,
                                score);
    else
      attend_block<true, INT8>(q_s, k_tile(stage), v_tile(stage), v_scale, st,
                               score);
    __syncthreads();  // the stage is free for the load two pages on
  }
  cp_async_wait<0>();

  finish_rows(st);
  __syncthreads();
  store_out_tile(st, smem);
  __syncthreads();
  for (unsigned c = tid; c < kRows * W::chunks; c += kThreads) {
    const int r = c / W::chunks, chunk = c % W::chunks, row = row0 + r;
    if (row < R) {
      const size_t off =
          ((static_cast<size_t>(s) * Q + row / G) * H + k * G + row % G) * D;
      *reinterpret_cast<uint4*>(out + off + chunk * 8) =
          *reinterpret_cast<const uint4*>(smem + swz(r, chunk));
    }
  }
}

// ---------------------------------------------------------------------------
// decode path: split-KV on the CUDA cores, then the combine
// ---------------------------------------------------------------------------

// Workspace (fp32): acc [S, K, n_split, R, D], then (m, l) [S, K,
// n_split, R, 2].
__device__ __forceinline__ size_t part_index(int s, int k, int split, int r,
                                             int K, int n_split, int R) {
  return ((static_cast<size_t>(s) * K + k) * n_split + split) * R + r;
}

// First element of folded row r of (slot s, kv head k) in out [S, Q, H, D].
__device__ __forceinline__ size_t out_index(int s, int k, int r, int Q, int H,
                                            int G, int D) {
  return ((static_cast<size_t>(s) * Q + r / G) * H + k * G + r % G) * D;
}

// One page (kv head k) into a split-KV stage: int8 codes and scales
// through stage_int8_page (K swizzled), or bf16 K as a swizzled [64][DP]
// tile and V row-major [64][D] after it.  Forced inline: out of line, its
// call spilled registers.
template <int D, bool INT8>
__device__ __forceinline__ void split_load_page(
    uint32_t area, const void* kv, const float* kv_scale, int page,
    int page_size, int K, size_t token_stride, int k) {
  if constexpr (INT8) {
    stage_int8_page<D>(area, static_cast<const int8_t*>(kv), kv_scale, page,
                       page_size, K, token_stride, k, true);
  } else {
    constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
    const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(kv) +
                                static_cast<size_t>(page) * page_size *
                                    token_stride +
                                k * D;
    for (unsigned c = threadIdx.x; c < kKeys * kChunks; c += kThreads) {
      const int t = c / kChunks, chunk = c % kChunks;
      const bool ok = t < page_size;
      const __nv_bfloat16* row = base + (ok ? t : 0) * token_stride + chunk * 8;
      cp_async16(area + swz(t, chunk), row, ok);
      cp_async16(area + Width<D>::tile_bytes + t * (2 * D) + chunk * 16,
                 row + K * D, ok);
    }
  }
}

template <int D, int ROWS, bool INT8>
struct SplitSmem {
  // bf16 stage: K as a swizzled [64][DP] tile, then V row-major [64][D]
  static constexpr int tile = Width<D>::tile_bytes;
  static constexpr int stage = INT8 ? kInt8StageBytes : 2 * tile;
  static constexpr int q = 2 * stage;                       // fp32 [ROWS][D]
  static constexpr int sc = q + ROWS * D * 4;               // [2][ROWS][64]
  static constexpr int p = sc + 2 * ROWS * kKeys * 4;       // [ROWS][64]
  static constexpr int stats = p + ROWS * kKeys * 4;        // m, l, alpha
  static constexpr int bytes = stats + 3 * ROWS * 4;
};

// Two blocks an SM at least: without that bound ptxas held these
// instances to 56-96 registers and kept the page loader's hoisted row
// predicates on the stack (32 of the 128 spilled); with it they take
// 85-160 and spill nothing, and shared memory, not registers, still
// sets how many blocks share an SM.
template <int D, int ROWS, bool WINDOW, bool ALIBI, bool INT8>
__global__ void __launch_bounds__(kThreads, 2)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const void* __restrict__ kv,
                   const float* __restrict__ kv_scale,
                   const int* __restrict__ page_table,
                   const int* __restrict__ start_pos,
                   const float* __restrict__ slopes, float* __restrict__ work,
                   __nv_bfloat16* __restrict__ out, int S, int Q, int H, int K,
                   int P, int page_size, float scale, int window) {
  using L = SplitSmem<D, ROWS, INT8>;
  static_assert(D <= kThreads, "a thread per head dim in the P . V sum");
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base_s = smem_addr(smem);
  float* qf = reinterpret_cast<float*>(smem + L::q);
  float* sc = reinterpret_cast<float*>(smem + L::sc);
  float* ps = reinterpret_cast<float*>(smem + L::p);
  float* m_s = reinterpret_cast<float*>(smem + L::stats);
  float* l_s = m_s + ROWS;
  float* alpha_s = l_s + ROWS;

  const int split = blockIdx.x, n_split = gridDim.x, k = blockIdx.y,
            s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = H / K, R = Q * G;
  const int start = start_pos[s];
  const int* table = page_table + static_cast<size_t>(s) * P;
  const size_t token_stride = static_cast<size_t>(2) * K * D;
  const bool owns_dim = tid < D;  // the head dim this thread sums and writes
  float* part_o = work;
  float* part_ml = work + static_cast<size_t>(S) * K * n_split * R * D;

  int p_lo, p_hi;
  page_range<WINDOW>(start, 0, R - 1, G, P, page_size, window, p_lo, p_hi);
  const int per_split = (P + n_split - 1) / n_split;
  const int p_begin = max(p_lo, split * per_split);
  const int p_end = min(p_hi, (split + 1) * per_split);
  if (p_begin >= p_end) {  // no keys here: weight 0 in the combine
    for (int r = 0; r < R; ++r) {
      if (n_split == 1) {
        if (owns_dim)
          out[out_index(s, k, r, Q, H, G, D) + tid] = __float2bfloat16(0.f);
        continue;
      }
      const size_t i = part_index(s, k, split, r, K, n_split, R);
      if (owns_dim) part_o[i * D + tid] = 0.f;
      if (tid == 0) {
        part_ml[2 * i] = -INFINITY;
        part_ml[2 * i + 1] = 0.f;
      }
    }
    return;
  }

  constexpr int kChunks = D / 8;  // 16-byte chunks of a bf16 row
  split_load_page<D, INT8>(base_s, kv, kv_scale, table[p_begin], page_size,
                           K, token_stride, k);
  cp_async_commit();

  for (int c = tid; c < ROWS * D; c += kThreads) {
    const int r = c / D, d = c % D;
    float x = 0.f;
    if (r < R)
      x = __bfloat162float(
          q[((static_cast<size_t>(s) * Q + r / G) * H + k * G + r % G) * D +
            d]);
    qf[c] = x;
  }
  if (tid < ROWS) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  for (int p = p_begin; p < p_end; ++p) {
    const int stage = (p - p_begin) & 1;
    if (p + 1 < p_end)
      split_load_page<D, INT8>(base_s + (stage ^ 1) * L::stage, kv, kv_scale,
                               table[p + 1], page_size, K, token_stride, k);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* area = smem + stage * L::stage;

    // scores: thread (key t, half hh of the head dims), every row
    {
      const int t = tid & (kKeys - 1), hh = tid >> 6;
      float dot[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) dot[r] = 0.f;
      if constexpr (INT8) {
        const float ks =
            reinterpret_cast<const float*>(area + 2 * kCodeBytes)[t];
        constexpr int kWords = D / 16;  // 16-code words of a row
#pragma unroll
        for (int j = 0; j < (kWords + 1) / 2; ++j) {
          const int c = 2 * j + hh;  // 16 codes: dims 16c .. 16c + 15
          if (c >= kWords) break;    // D = 80: half 1 takes two words
          float f[16];
          codes16(*reinterpret_cast<const uint4*>(area + t * kCodeRow +
                                                  ((c ^ (t & 7)) << 4)), f);
#pragma unroll
          for (int i = 0; i < 16; ++i)
            f[i] = __bfloat162float(__float2bfloat16(f[i] * ks));
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4* qv = reinterpret_cast<const float4*>(qf + r * D + 16 * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 a = qv[i];
              dot[r] += a.x * f[4 * i] + a.y * f[4 * i + 1] + a.z * f[4 * i + 2] +
                        a.w * f[4 * i + 3];
            }
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunks / 2; ++j) {
          const int c = kChunks / 2 * hh + j;  // 8 values: dims 8c .. 8c + 7
          float f[8];
          ds_bf16x8_to_float(*reinterpret_cast<const uint4*>(area + swz(t, c)), f);
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float4* qv = reinterpret_cast<const float4*>(qf + r * D + 8 * c);
            const float4 a = qv[0], b = qv[1];
            dot[r] += a.x * f[0] + a.y * f[1] + a.z * f[2] + a.w * f[3] +
                      b.x * f[4] + b.y * f[5] + b.z * f[6] + b.w * f[7];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) sc[(hh * ROWS + r) * kKeys + t] = dot[r];
    }
    __syncthreads();

    // online softmax: a warp per row, two keys per lane
    const float* v_scale =
        INT8 ? reinterpret_cast<const float*>(area + 2 * kCodeBytes) + kKeys
             : nullptr;
    for (int r = warp; r < R; r += kThreads / 32) {
      const int ctx_len = start + r / G + 1;
      const float slope = ALIBI ? slopes[k * G + r % G] : 0.f;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = lane + 32 * j, ctx = p * page_size + t;
        float v = (sc[r * kKeys + t] + sc[(ROWS + r) * kKeys + t]) * scale;
        if (ALIBI) v += slope * static_cast<float>(ctx);
        bool keep = t < page_size && ctx < ctx_len;
        if (WINDOW) keep = keep && ctx >= ctx_len - window;
        x[j] = keep ? v : DS_MASK_VALUE;
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, ds_warp_max(fmaxf(x[0], x[1])));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int t = lane + 32 * j;
        const float pr = exp2f((x[j] - m_new) * kLog2e);
        sum += pr;
        ps[r * kKeys + t] =
            INT8 ? pr * v_scale[t] : __bfloat162float(__float2bfloat16(pr));
      }
      sum = ds_warp_sum(sum);
      if (lane == 0) {
        const float alpha = exp2f((m_old - m_new) * kLog2e);  // 0 at first
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc[r] of head dim d = tid: rescale, then sum over the page's keys
    if (owns_dim) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        if (r < R) acc[r] *= alpha_s[r];
      for (int t = 0; t < kKeys; t += 4) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (INT8)
            v[i] = static_cast<float>(static_cast<const signed char*>(
                static_cast<const void*>(area + kCodeBytes))[(t + i) * kCodeRow +
                                                             tid]);
          else
            v[i] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
                area + L::tile)[(t + i) * D + tid]);
        }
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < R) {
            const float4 pr =
                *reinterpret_cast<const float4*>(ps + r * kKeys + t);
            acc[r] += pr.x * v[0] + pr.y * v[1] + pr.z * v[2] + pr.w * v[3];
          }
        }
      }
    }
    __syncthreads();  // the stage, scores and probabilities are free
  }
  cp_async_wait<0>();

  // __fdividef: no call to the IEEE division's slow path in the kernel;
  // within 2 ulp at the l >= 1 that a row with keys has
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < R && n_split == 1) {
      if (owns_dim)
        out[out_index(s, k, r, Q, H, G, D) + tid] =
            __float2bfloat16(__fdividef(acc[r], fmaxf(l_s[r], 1e-30f)));
    } else if (r < R) {
      const size_t i = part_index(s, k, split, r, K, n_split, R);
      if (owns_dim) part_o[i * D + tid] = acc[r];
      if (tid == 0) {
        part_ml[2 * i] = m_s[r];
        part_ml[2 * i + 1] = l_s[r];
      }
    }
  }
}

// out = sum_i e^(m_i - M) acc_i / sum_i e^(m_i - M) l_i over the splits;
// grid (K, S), thread d = head dim (threads d >= D have nothing to do).
__global__ void __launch_bounds__(kThreads)
paged_combine_kernel(const float* __restrict__ work,
                     __nv_bfloat16* __restrict__ out, int S, int Q, int H,
                     int K, int D, int n_split) {
  const int k = blockIdx.x, s = blockIdx.y, d = threadIdx.x;
  if (d >= D) return;
  const int G = H / K, R = Q * G;
  const float* part_o = work;
  const float* part_ml = work + static_cast<size_t>(S) * K * n_split * R * D;
  for (int r = 0; r < R; ++r) {
    float M = -INFINITY;
    for (int i = 0; i < n_split; ++i)
      M = fmaxf(M, part_ml[2 * part_index(s, k, i, r, K, n_split, R)]);
    float num = 0.f, den = 0.f;
    for (int i = 0; i < n_split; ++i) {
      const size_t j = part_index(s, k, i, r, K, n_split, R);
      const float m = part_ml[2 * j];
      const float w = m == -INFINITY ? 0.f : exp2f((m - M) * kLog2e);
      num += w * part_o[j * D + d];
      den += w * part_ml[2 * j + 1];
    }
    out[out_index(s, k, r, Q, H, G, D) + d] =
        __float2bfloat16(num / fmaxf(den, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// Everything a launch needs besides its template parameters.
struct PagedArgs {
  const void* q;
  const void* kv;
  const void* kv_scale;  // int8 pages only
  const void* page_table;
  const void* start_pos;
  const void* slopes;    // nullptr: no ALiBi
  void* out;
  void* work;            // decode path with n_split > 1: the fp32 partials
  int S, Q, H, K, D, P, page_size;
  float scale;
  int window;            // <= 0: no sliding window
  int n_split;           // decode path: splits per (slot, kv head)
  cudaStream_t stream;
};

template <class Kernel>
static cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  configured = e == cudaSuccess;
  return e;
}

template <int D, bool WINDOW, bool ALIBI, bool INT8>
static int launch_tile(const PagedArgs& a) {
  auto kernel = paged_tile_kernel<D, WINDOW, ALIBI, INT8>;
  constexpr int smem = TileSmem<D, INT8>::bytes;
  static bool configured = false;
  cudaError_t e = allow_smem(kernel, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int R = a.Q * (a.H / a.K);
  dim3 grid((R + kRows - 1) / kRows, a.K, a.S);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.kv,
      static_cast<const float*>(a.kv_scale),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.start_pos),
      static_cast<const float*>(a.slopes), static_cast<__nv_bfloat16*>(a.out),
      a.Q, a.H, a.K, a.P, a.page_size, a.scale, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int ROWS, bool WINDOW, bool ALIBI, bool INT8>
static int launch_split(const PagedArgs& a) {
  auto kernel = paged_split_kernel<D, ROWS, WINDOW, ALIBI, INT8>;
  constexpr int smem = SplitSmem<D, ROWS, INT8>::bytes;
  static bool configured = false;
  cudaError_t e = allow_smem(kernel, smem, configured);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(a.n_split, a.K, a.S);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), a.kv,
      static_cast<const float*>(a.kv_scale),
      static_cast<const int*>(a.page_table), static_cast<const int*>(a.start_pos),
      static_cast<const float*>(a.slopes), static_cast<float*>(a.work),
      static_cast<__nv_bfloat16*>(a.out), a.S, a.Q, a.H, a.K, a.P, a.page_size,
      a.scale, a.window);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool WINDOW, bool ALIBI, bool INT8>
static int dispatch_rows(const PagedArgs& a) {
  const int rows = a.Q * (a.H / a.K);
  if (rows >= kDecodeRows) return launch_tile<D, WINDOW, ALIBI, INT8>(a);
  if (a.n_split < 1 || (a.n_split > 1 && a.work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 1) return launch_split<D, 1, WINDOW, ALIBI, INT8>(a);
  if (rows <= 4) return launch_split<D, 4, WINDOW, ALIBI, INT8>(a);
  if (rows <= 8) return launch_split<D, 8, WINDOW, ALIBI, INT8>(a);
  return launch_split<D, kDecodeRows, WINDOW, ALIBI, INT8>(a);
}

template <int D, bool INT8>
static int dispatch_masks(const PagedArgs& a) {
  const bool win = a.window > 0, alibi = a.slopes != nullptr;
  if (win && alibi) return dispatch_rows<D, true, true, INT8>(a);
  if (win) return dispatch_rows<D, true, false, INT8>(a);
  if (alibi) return dispatch_rows<D, false, true, INT8>(a);
  return dispatch_rows<D, false, false, INT8>(a);
}

// The head dim picks the instantiation; any other is refused.
template <bool INT8>
static int dispatch(const PagedArgs& a) {
  switch (a.D) {
    case 64: return dispatch_masks<64, INT8>(a);
    case 80: return dispatch_masks<80, INT8>(a);
    case 96: return dispatch_masks<96, INT8>(a);
    case 128: return dispatch_masks<128, INT8>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// D: the head dim, 64, 80, 96 or 128 (anything else: cudaErrorInvalidValue,
// nothing launched); window <= 0: no sliding window; slopes == nullptr: no
// ALiBi.  With Q * (H / K) < 16 folded rows this launches the split-KV
// kernel, which with n_split > 1 writes fp32 partials to `work` (see the
// wrapper for its size) and leaves `out` to paged_attention_combine, and
// with n_split == 1 writes `out` (`work` may be null); otherwise the
// tensor-core kernel writes `out` and `work` is not read.
DS_EXPORT int paged_attention_bf16(const void* q, const void* kv,
                                   const void* page_table, const void* start_pos,
                                   const void* slopes, void* out, void* work,
                                   int S, int Q, int H, int K, int D, int P,
                                   int page_size, float scale, int window,
                                   int n_split, void* stream) {
  return dispatch<false>({q, kv, nullptr, page_table, start_pos, slopes, out,
                          work, S, Q, H, K, D, P, page_size, scale, window,
                          n_split, static_cast<cudaStream_t>(stream)});
}

// kv: int8 codes [num_pages + 1, page, 2, K, D]; kv_scale: fp32
// [num_pages + 1, page, 2, K].
DS_EXPORT int paged_attention_int8(const void* q, const void* kv,
                                   const void* kv_scale, const void* page_table,
                                   const void* start_pos, const void* slopes,
                                   void* out, void* work, int S, int Q, int H,
                                   int K, int D, int P, int page_size,
                                   float scale, int window, int n_split,
                                   void* stream) {
  return dispatch<true>({q, kv, kv_scale, page_table, start_pos, slopes, out,
                         work, S, Q, H, K, D, P, page_size, scale, window,
                         n_split, static_cast<cudaStream_t>(stream)});
}

// The decode path's second launch: the n_split partials of each (slot,
// kv head, row) in `work` -> out, at head dim D (as the first launch's).
DS_EXPORT int paged_attention_combine(const void* work, void* out, int S,
                                      int Q, int H, int K, int D, int n_split,
                                      void* stream) {
  if (D != 64 && D != 80 && D != 96 && D != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(K, S);
  paged_combine_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(work), static_cast<__nv_bfloat16*>(out), S, Q,
      H, K, D, n_split);
  return static_cast<int>(cudaGetLastError());
}
