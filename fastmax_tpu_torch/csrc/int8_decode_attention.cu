// Single-token decode attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels int8_decode_attention_stacked and
// int8_decode_attention (fastmax_tpu/ops/decode_attention.py). The caller
// passes pointers to one layer of the (L, B, G, S, D) cache stack, so one
// kernel serves the stacked and the per-layer entry points.
//
// For each (b, g) and each of the R = Hq/G query rows of that group:
//   s[j]  = (q . k_codes[j]) * (scale * k_scale[j])      for j <= pos[b]
//   p     = softmax(s) in f32 (positions j > pos[b] are masked out)
//   out   = sum_j round_to_q_dtype(p[j] * v_scale[j]) * v_codes[j]
// with f32 accumulation and the output in q's dtype: the same arithmetic as
// the Pallas kernel, which masks with -1e30 (exp gives exactly 0 there), so
// these kernels skip the masked positions instead of reading them.
//
// Bound: device-memory bytes (the int8 codes and f32 scales of positions
// 0..pos). Two routes, chosen by the caller (decode_splits in
// ops/decode_attention.py) and passed as nsplit:
//
// nsplit = 1, int8_decode_attention_kernel: one block per (b, g) keeps the
// whole softmax row in shared memory; each thread reads 16 codes per load, 4
// rows deep. At Llama-2-7B batch 1 that is 32 blocks on 132 SMs, each walking
// up to S positions twice.
//
// nsplit > 1, a split of the cache positions into chunks of `chunk` (a multiple
// of 64); an item is one chunk of one (b, g). Three launches:
//   1. int8_decode_split_scores_kernel writes s for its items to an f32 scratch
//      (B, Hq, S) and each item's (max, sum of exp(s - max)) per query row to a
//      (B * Hq, nsplit) scratch.
//   2. int8_decode_split_values_kernel folds the splits' (max, sum) of each row
//      into the row's global max m and sum l (the terms l_i exp(m_i - m) summed
//      in split order, so every item of a (b, g) gets the same bits), rounds
//      p * v_scale = (exp(s - m) / l) * v_scale to q's dtype as the reference
//      does, and writes its item's partial output (R, D) in f32.
//   3. int8_decode_split_combine_kernel sums each output's partials in split
//      order and casts to q's dtype.
// p is normalised by the global max and sum before the rounding, so the split
// computes the reference's function; flash-decoding's usual form, which rounds
// against each split's own max and sum and rescales the partials, would not.
// Launches 1 and 2 are persistent: each block takes items blockIdx.x,
// blockIdx.x + gridDim.x, ... and keeps two items' operands in flight in
// shared memory, every copy a bulk asynchronous copy (TMA's cp.async.bulk)
// completing on an mbarrier, so that one item's copies land while the block
// computes on the one before (codes in tiles of kTile positions, each on its
// own barrier). Launches 2 and 3 are programmatic dependents of the one before
// them: launch 2 starts its V copies while launch 1 runs. No float atomics:
// the same inputs give the same bits on every call. A slot with pos < 0
// attends nothing and gives zeros on both routes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kRowsPerPass = 4;  // query rows reduced together in the value pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The 16 int8 codes of one 16-byte load as floats, without int-to-float
// conversions (a quarter of the FMA issue rate): w ^ 0x80808080 turns each
// code c into c + 128 in [0, 255]; a byte permute places it in the low
// mantissa byte of 2^23 (0x4B000000), giving exactly 2^23 + c + 128.
__device__ __forceinline__ void codes16(const int4& v, float c[16]) {
  const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                         static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      c[4 * i + j] = __int_as_float(__byte_perm(b, 0x4B000000u, 0x7440u | j)) - 8388736.f;
  }
}

// All threads call this; every thread gets the result. red holds kW floats.
template <bool kMax, int kW = kWarps>
__device__ float block_reduce(float val, float* red) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, val, off);
    val = kMax ? fmaxf(val, o) : val + o;
  }
  __syncthreads();  // red may still be read by an earlier call
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = val;
  __syncthreads();
  float r = red[0];
  for (int i = 1; i < kW; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) int8_decode_attention_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kc, const int8_t* __restrict__ vc,
    const float* __restrict__ ks, const float* __restrict__ vs, const int32_t* __restrict__ pos,
    T* __restrict__ out, int hq, int g_count, int s_len, float scale) {
  extern __shared__ float smem[];
  constexpr int kTpr = D / 16;              // threads per cache row (16 codes each)
  constexpr int kRpp = kThreads / kTpr;     // rows per pass
  const int r_count = hq / g_count;
  float* qs = smem;                          // (R, D) f32
  float* sc = qs + r_count * D;              // (R, S): scores, then p * v_scale
  float* red = sc + r_count * s_len;         // (kWarps, kRowsPerPass, D)

  const int tid = threadIdx.x;
  const int bg = blockIdx.x;
  const int b = bg / g_count, g = bg % g_count;
  const int n = max(0, min(pos[b] + 1, s_len));
  const size_t row0 = static_cast<size_t>(bg) * s_len;
  const int8_t* kb = kc + row0 * D;
  const int8_t* vb = vc + row0 * D;
  const float* ksb = ks + row0;
  const float* vsb = vs + row0;
  const size_t head0 = static_cast<size_t>(b) * hq + static_cast<size_t>(g) * r_count;

  for (int i = tid; i < r_count * D; i += kThreads) qs[i] = to_f32(q[head0 * D + i]);
  __syncthreads();

  const int t16 = tid % kTpr, rg = tid / kTpr;
  // ---- scores (the loop bound is uniform so every lane reaches the shuffles)
  for (int jb = 0; jb < n; jb += kRpp * kUnroll) {
    int4 kv[kUnroll];
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const int j = jb + s * kRpp + rg;
      kv[s] = j < n ? __ldg(reinterpret_cast<const int4*>(kb + static_cast<size_t>(j) * D) + t16)
                    : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int s = 0; s < kUnroll; ++s) {
      const int j = jb + s * kRpp + rg;
      float codes[16];
      codes16(kv[s], codes);
      for (int r = 0; r < r_count; ++r) {
        const float* qr = qs + r * D + t16 * 16;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) dot = fmaf(qr[e], codes[e], dot);
#pragma unroll
        for (int off = kTpr / 2; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (t16 == 0 && j < n) sc[r * s_len + j] = dot * (scale * ksb[j]);
      }
    }
  }
  __syncthreads();

  // ---- f32 softmax over j < n, then p * v_scale rounded to q's dtype
  for (int r = 0; r < r_count; ++r) {
    float* row = sc + r * s_len;
    float mx = -INFINITY;
    for (int j = tid; j < n; j += kThreads) mx = fmaxf(mx, row[j]);
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int j = tid; j < n; j += kThreads) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    sum = block_reduce<false>(sum, red);
    for (int j = tid; j < n; j += kThreads)
      row[j] = to_f32(from_f32<T>(row[j] / sum * vsb[j]));
  }
  __syncthreads();

  // ---- out = sum_j pv[j] * v_codes[j], up to kRowsPerPass query rows at a time
  for (int r0 = 0; r0 < r_count; r0 += kRowsPerPass) {
    float acc[kRowsPerPass][16];
#pragma unroll
    for (int i = 0; i < kRowsPerPass; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
    for (int jb = 0; jb < n; jb += kRpp * kUnroll) {
      int4 vv[kUnroll];
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        const int j = jb + s * kRpp + rg;
        vv[s] = j < n ? __ldg(reinterpret_cast<const int4*>(vb + static_cast<size_t>(j) * D) + t16)
                      : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int s = 0; s < kUnroll; ++s) {
        const int j = jb + s * kRpp + rg;
        if (j < n) {
          float codes[16];
          codes16(vv[s], codes);
#pragma unroll
          for (int i = 0; i < kRowsPerPass; ++i) {
            if (r0 + i < r_count) {
              const float pv = sc[(r0 + i) * s_len + j];
#pragma unroll
              for (int e = 0; e < 16; ++e)
                acc[i][e] = fmaf(pv, codes[e], acc[i][e]);
            }
          }
        }
      }
    }
    // row groups of one warp hold the same columns: lanes kTpr, 2*kTpr, ... apart
#pragma unroll
    for (int i = 0; i < kRowsPerPass; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e)
#pragma unroll
        for (int off = kTpr; off < 32; off <<= 1)
          acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
    __syncthreads();  // red was last read by the softmax reductions
    const int lane = tid % 32, warp = tid / 32;
    if (lane < kTpr) {
#pragma unroll
      for (int i = 0; i < kRowsPerPass; ++i)
#pragma unroll
        for (int e = 0; e < 16; ++e) red[(warp * kRowsPerPass + i) * D + t16 * 16 + e] = acc[i][e];
    }
    __syncthreads();
    for (int idx = tid; idx < kRowsPerPass * D; idx += kThreads) {
      const int i = idx / D, d = idx % D;
      if (r0 + i < r_count) {
        float s = 0.f;
        for (int w = 0; w < kWarps; ++w) s += red[(w * kRowsPerPass + i) * D + d];
        out[(head0 + r0 + i) * D + d] = from_f32<T>(s);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const int8_t* kc, const int8_t* vc, const float* ks,
                   const float* vs, const int32_t* pos, void* out, int b, int hq, int g,
                   int s_len, float scale, size_t smem, cudaStream_t stream) {
  auto kernel = int8_decode_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<b * g, kThreads, smem, stream>>>(static_cast<const T*>(q), kc, vc, ks, vs, pos,
                                            static_cast<T*>(out), hq, g, s_len, scale);
  return cudaGetLastError();
}

// Shared memory the kernel needs, in bytes, for R query rows per group
// (one_block_smem in ops/decode_attention.py holds the same formula).
size_t smem_bytes(int r, int s_len, int d) {
  return sizeof(float) * (static_cast<size_t>(r) * d + static_cast<size_t>(r) * s_len +
                          static_cast<size_t>(kWarps) * kRowsPerPass * d);
}

// ------------------------------------------------------------------ split route
constexpr int kSplitThreads = 128;
constexpr int kSplitWarps = kSplitThreads / 32;
constexpr int kTile = 128;      // positions a bulk copy of codes brings, on its own mbarrier
constexpr int kMaxChunk = 512;  // positions an item takes at most
constexpr int kMaxSplits = 64;  // chunks a (b, g) may be split into
constexpr int kTiles = kMaxChunk / kTile;
// A block keeps two items' operands in flight (slots 0 and 1), each slot with
// kBars mbarriers: 0 for the item's small operands that need no earlier pass
// (scales, q), 1 for those the score pass writes (scores, stats), then one per
// tile of codes.
constexpr int kSlots = 2;
constexpr int kBars = 2 + kTiles;
constexpr int kBarBytes = (kSlots * kBars * 8 + 15) / 16 * 16;
constexpr size_t kSmemMax = 232448;  // bytes of shared memory a block may use on sm_90
// The value pass is a programmatic dependent of the score pass, and the combine of the
// value pass: each starts while the pass before it runs (the value pass starts its V
// copies) and waits for it (griddepcontrol.wait) before reading its output.
constexpr bool kUsePdl = true;
constexpr int kCombineThreads = 256;

// Positions of a chunk: the caller's nsplit spread over S, rounded up to 64
// (ops/decode_attention.py's split_chunk holds the same formula).
int split_chunk(int s_len, int nsplit) {
  const int c = (s_len + nsplit - 1) / nsplit;
  return (c + 63) / 64 * 64;
}

// The stats row of a query row holds nsplit (max, sum) pairs, padded to an even
// count so that each row starts on 16 bytes.
__host__ __device__ __forceinline__ int stats_stride(int nsplit) { return (nsplit + 1) / 2 * 2; }

__host__ __device__ __forceinline__ size_t round16(size_t bytes) { return (bytes + 15) / 16 * 16; }

// Positions slot b attends: 0 <= j < n.
__device__ __forceinline__ int attended(int pos_b, int s_len) {
  return max(0, min(pos_b + 1, s_len));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A one-arrival mbarrier in phase 0.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(1)
               : "memory");
}

// The one arrival of a phase, telling the barrier how many bytes its copies bring
// (0: the phase completes at once).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Wait until the phase of the barrier with this parity completes (its copies have
// landed). A copy that never lands traps after ~10 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(const uint64_t* bar, uint32_t parity) {
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// Bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// device memory to shared memory; completion is counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One item of the split: a chunk of `chunk` positions of one (b, g). Items are
// numbered split-major (item = split * B*G + bg) and a block takes items
// blockIdx.x, blockIdx.x + gridDim.x, ...
struct Item {
  int split, n, j0, rows;  // rows: positions j0 <= j < n of the chunk, 0 when idle
  size_t head0, row0;      // the group's first query row; the chunk's first cache row
};

__device__ __forceinline__ Item item_at(int idx, int bg_count, int g_count, int hq,
                                        int s_len, int chunk, const int32_t* pos) {
  Item it;
  it.split = idx / bg_count;
  const int bg = idx % bg_count;
  const int b = bg / g_count, g = bg % g_count;
  it.n = attended(pos[b], s_len);
  it.j0 = it.split * chunk;
  it.rows = max(0, min(chunk, it.n - it.j0));
  it.head0 = static_cast<size_t>(b) * hq + static_cast<size_t>(g) * (hq / g_count);
  it.row0 = static_cast<size_t>(bg) * s_len + it.j0;
  return it;
}

// Arm a slot's barriers for one item: the chunk's codes in tiles of kTile
// positions, tile t on bars[2 + t] (every tile barrier is armed, with 0 bytes past
// the chunk's last tile, so that all of them advance one phase an item). One
// thread calls this.
template <int D>
__device__ __forceinline__ void load_codes(uint64_t* bars, int8_t* codes, const int8_t* src,
                                           int rows) {
  for (int t = 0; t < kTiles; ++t) {
    const int n = min(kTile, rows - t * kTile);
    const uint32_t bytes = n > 0 ? static_cast<uint32_t>(n) * D : 0u;
    mbar_expect(bars + 2 + t, bytes);
    if (bytes) bulk_load(codes + t * kTile * D, src + static_cast<size_t>(t) * kTile * D, bytes,
                         bars + 2 + t);
  }
}

// Bytes of a chunk's f32 per-position values (scales, scores) that a copy brings:
// rows rounded up to whole 16-byte words, still inside the cache row since S - j0
// is a multiple of 64.
__device__ __forceinline__ uint32_t row_bytes(int rows) {
  return static_cast<uint32_t>((rows + 3) / 4) * 16;
}

// A slot of each pass, in bytes, and the pass's shared memory
// (ops/decode_attention.py's split_smem holds the same formulas):
//   scores slot: k_scale (chunk), q (R, D) in q's dtype, the codes (chunk, D);
//     then the chunk's scores (R, chunk), q in f32 where R > 1, the reduction's
//     kSplitWarps;
//   values slot: v_scale (chunk), the scores, then p * v_scale (R, chunk), each
//     row's stats (R, stats_stride) pairs, the codes (chunk, D); then each row's
//     (m, l) and the partial sums (kSplitWarps, value_rows_per_pass(R), D).
int value_rows_per_pass(int r) { return r == 1 ? 1 : kRowsPerPass; }
__host__ __device__ size_t scores_slot(int r, int chunk, int d, int elem) {
  return 4 * static_cast<size_t>(chunk) + round16(static_cast<size_t>(r) * d * elem) +
         static_cast<size_t>(chunk) * d;
}
__host__ __device__ size_t values_slot(int r, int chunk, int d, int nsplit) {
  return 4 * static_cast<size_t>(chunk) * (1 + r) +
         8 * static_cast<size_t>(r) * stats_stride(nsplit) + static_cast<size_t>(chunk) * d;
}
size_t split_scores_smem(int r, int chunk, int d, int elem) {
  return kBarBytes + kSlots * scores_slot(r, chunk, d, elem) +
         4 * (static_cast<size_t>(r) * chunk + (r > 1 ? static_cast<size_t>(r) * d : 0) +
              kSplitWarps);
}
size_t split_values_smem(int r, int chunk, int d, int nsplit) {
  return kBarBytes + kSlots * values_slot(r, chunk, d, nsplit) +
         4 * (2 * static_cast<size_t>(r) +
              static_cast<size_t>(kSplitWarps) * value_rows_per_pass(r) * d);
}

template <typename T, int D, bool kOneRow>
__global__ void __launch_bounds__(kSplitThreads) int8_decode_split_scores_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ kc, const float* __restrict__ ks,
    const int32_t* __restrict__ pos, float* __restrict__ scores, float2* __restrict__ stats,
    int hq, int g_count, int bg_count, int s_len, int nsplit, int chunk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kTpr = D / 16;                 // threads per cache row (16 codes each)
  constexpr int kRpp = kSplitThreads / kTpr;   // rows per pass
  if (kUsePdl) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int r_count = hq / g_count;
  const int n_items = nsplit * bg_count, sst = stats_stride(nsplit);
  const size_t slot_bytes = scores_slot(r_count, chunk, D, sizeof(T));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  unsigned char* slots = smem_raw + kBarBytes;
  float* sc = reinterpret_cast<float*>(slots + kSlots * slot_bytes);  // (R, chunk) scores
  float* qs = sc + r_count * chunk;                                   // (R, D) f32 if R > 1
  float* red = qs + (kOneRow ? 0 : r_count * D);                      // (kSplitWarps,)
  const int tid = threadIdx.x;

  // the slot's operands: k_scale and q on bars[0], the codes on bars[2 + t]
  auto issue = [&](int idx, int slot) {
    const Item it = item_at(idx, bg_count, g_count, hq, s_len, chunk, pos);
    uint64_t* sb = bars + slot * kBars;
    unsigned char* base = slots + slot * slot_bytes;
    const uint32_t scale_bytes = it.rows ? row_bytes(it.rows) : 0u;
    const uint32_t q_bytes = it.rows ? static_cast<uint32_t>(r_count * D * sizeof(T)) : 0u;
    mbar_expect(sb, scale_bytes + q_bytes);
    if (it.rows) {
      bulk_load(base, ks + it.row0, scale_bytes, sb);
      bulk_load(base + 4 * chunk, q + it.head0 * D, q_bytes, sb);
    }
    load_codes<D>(sb, reinterpret_cast<int8_t*>(base + slot_bytes) - chunk * D,
                  kc + it.row0 * D, it.rows);
  };
  if (tid == 0) {
    for (int i = 0; i < kSlots * kBars; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kSlots; ++s)
      if (blockIdx.x + s * gridDim.x < n_items) issue(blockIdx.x + s * gridDim.x, s);
  }
  __syncthreads();

  const int t16 = tid % kTpr, rg = tid / kTpr;
  int k = 0;
  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++k) {
    const int slot = k % kSlots;
    const uint32_t par = (k / kSlots) & 1;
    const Item it = item_at(idx, bg_count, g_count, hq, s_len, chunk, pos);
    const uint64_t* sb = bars + slot * kBars;
    const unsigned char* base = slots + slot * slot_bytes;
    const float* ksb = reinterpret_cast<const float*>(base);
    const T* qraw = reinterpret_cast<const T*>(base + 4 * chunk);
    const int4* k4 = reinterpret_cast<const int4*>(base + slot_bytes - chunk * D);
    if (it.rows == 0) {  // the chunk starts past pos[b]
      for (int r = tid; r < r_count; r += kSplitThreads)
        stats[(it.head0 + r) * sst + it.split] = make_float2(-INFINITY, 0.f);
    } else {
      mbar_wait(sb, par);
      float qf[16];  // R = 1: this thread's 16 entries of q
      if constexpr (kOneRow) {
#pragma unroll
        for (int e = 0; e < 16; ++e) qf[e] = to_f32(qraw[t16 * 16 + e]);
      } else {
        for (int i = tid; i < r_count * D; i += kSplitThreads) qs[i] = to_f32(qraw[i]);
        __syncthreads();
      }
      // ---- scores, tile by tile as the copies land, with the one-block kernel's
      // arithmetic (the loop bounds are uniform so every lane reaches the shuffles)
      for (int t0 = 0; t0 < it.rows; t0 += kTile) {
        mbar_wait(sb + 2 + t0 / kTile, par);
        for (int jb = t0; jb < min(it.rows, t0 + kTile); jb += kRpp) {
          const int j = jb + rg;
          float codes[16];
          codes16(j < it.rows ? k4[j * kTpr + t16] : make_int4(0, 0, 0, 0), codes);
          for (int r = 0; r < (kOneRow ? 1 : r_count); ++r) {
            float dot = 0.f;
            if constexpr (kOneRow) {
#pragma unroll
              for (int e = 0; e < 16; ++e) dot = fmaf(qf[e], codes[e], dot);
            } else {
              const float* qr = qs + r * D + t16 * 16;
#pragma unroll
              for (int e = 0; e < 16; ++e) dot = fmaf(qr[e], codes[e], dot);
            }
#pragma unroll
            for (int off = kTpr / 2; off > 0; off >>= 1)
              dot += __shfl_xor_sync(0xffffffffu, dot, off);
            if (t16 == 0 && j < it.rows) {
              const float s = dot * (scale * ksb[j]);
              sc[r * chunk + j] = s;
              scores[(it.head0 + r) * s_len + it.j0 + j] = s;
            }
          }
        }
      }
      __syncthreads();
      // ---- the chunk's max and sum of exp(s - max), per query row
      for (int r = 0; r < r_count; ++r) {
        const float* row = sc + r * chunk;
        float mx = -INFINITY;
        for (int j = tid; j < it.rows; j += kSplitThreads) mx = fmaxf(mx, row[j]);
        mx = block_reduce<true, kSplitWarps>(mx, red);
        float sum = 0.f;
        for (int j = tid; j < it.rows; j += kSplitThreads) sum += expf(row[j] - mx);
        sum = block_reduce<false, kSplitWarps>(sum, red);
        if (tid == 0) stats[(it.head0 + r) * sst + it.split] = make_float2(mx, sum);
      }
    }
    __syncthreads();  // the slot, sc and red are free
    if (tid == 0 && idx + kSlots * gridDim.x < n_items) issue(idx + kSlots * gridDim.x, slot);
  }
}

// Query rows r0 .. r0 + RP - 1 of the chunk's partial output, summed over its positions
// as the tiles land (tile t on tile_bars[t], this phase's parity), reduced over the
// block and written to part (row i at part + i * part_stride).
template <int RP, int D>
__device__ __forceinline__ void value_rows(const int8_t* vbuf, const float* pv, float* red,
                                           const uint64_t* tile_bars, uint32_t par,
                                           float* part, size_t part_stride, int r0,
                                           int r_count, int rows, int chunk) {
  constexpr int kTpr = D / 16;
  constexpr int kRpp = kSplitThreads / kTpr;
  const int tid = threadIdx.x;
  const int t16 = tid % kTpr, rg = tid / kTpr;
  const int lane = tid % 32, warp = tid / 32;
  const int4* v4 = reinterpret_cast<const int4*>(vbuf);
  float acc[RP][16];
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
  for (int t0 = 0; t0 < rows; t0 += kTile) {
    mbar_wait(tile_bars + t0 / kTile, par);
    for (int j = t0 + rg; j < min(rows, t0 + kTile); j += kRpp) {
      float codes[16];
      codes16(v4[j * kTpr + t16], codes);
#pragma unroll
      for (int i = 0; i < RP; ++i) {
        if (r0 + i < r_count) {
          const float p = pv[(r0 + i) * chunk + j];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[i][e] = fmaf(p, codes[e], acc[i][e]);
        }
      }
    }
  }
  // row groups of one warp hold the same columns: lanes kTpr, 2*kTpr, ... apart
#pragma unroll
  for (int i = 0; i < RP; ++i)
#pragma unroll
    for (int e = 0; e < 16; ++e)
#pragma unroll
      for (int off = kTpr; off < 32; off <<= 1)
        acc[i][e] += __shfl_xor_sync(0xffffffffu, acc[i][e], off);
  if (lane < kTpr) {
#pragma unroll
    for (int i = 0; i < RP; ++i)
#pragma unroll
      for (int e = 0; e < 16; ++e) red[(warp * RP + i) * D + t16 * 16 + e] = acc[i][e];
  }
  __syncthreads();
  for (int idx = tid; idx < RP * D; idx += kSplitThreads) {
    const int i = idx / D, d = idx % D;
    if (r0 + i < r_count) {
      float s = 0.f;
      for (int w = 0; w < kSplitWarps; ++w) s += red[(w * RP + i) * D + d];
      part[i * part_stride + d] = s;
    }
  }
  __syncthreads();  // red is written again by the next rows
}

template <typename T, int D, int RP>
__global__ void __launch_bounds__(kSplitThreads) int8_decode_split_values_kernel(
    const int8_t* __restrict__ vc, const float* __restrict__ vs, const int32_t* __restrict__ pos,
    const float* __restrict__ scores, const float2* __restrict__ stats,
    float* __restrict__ part, int hq, int g_count, int bg_count, int s_len, int nsplit,
    int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int r_count = hq / g_count;
  const int n_items = nsplit * bg_count, sst = stats_stride(nsplit);
  const size_t slot_bytes = values_slot(r_count, chunk, D, nsplit);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  unsigned char* slots = smem_raw + kBarBytes;
  float* ml = reinterpret_cast<float*>(slots + kSlots * slot_bytes);  // (R, 2): global max, sum
  float* red = ml + 2 * r_count;                                      // (kSplitWarps, RP, D)
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;

  // the slot's operands: v_scale on bars[0], the codes on bars[2 + t] (neither written
  // by the score pass), then its scores and the group's stats on bars[1]
  auto issue_cache = [&](int idx, int slot) {
    const Item it = item_at(idx, bg_count, g_count, hq, s_len, chunk, pos);
    uint64_t* sb = bars + slot * kBars;
    unsigned char* base = slots + slot * slot_bytes;
    const uint32_t scale_bytes = it.rows ? row_bytes(it.rows) : 0u;
    mbar_expect(sb, scale_bytes);
    if (it.rows) bulk_load(base, vs + it.row0, scale_bytes, sb);
    load_codes<D>(sb, reinterpret_cast<int8_t*>(base + slot_bytes) - chunk * D,
                  vc + it.row0 * D, it.rows);
  };
  auto issue_pass1 = [&](int idx, int slot) {
    const Item it = item_at(idx, bg_count, g_count, hq, s_len, chunk, pos);
    uint64_t* sb = bars + slot * kBars + 1;
    unsigned char* base = slots + slot * slot_bytes + 4 * chunk;
    const uint32_t s_bytes = it.rows ? row_bytes(it.rows) : 0u;
    const uint32_t st_bytes = it.rows ? static_cast<uint32_t>(8 * sst) : 0u;
    mbar_expect(sb, r_count * (s_bytes + st_bytes));
    for (int r = 0; it.rows && r < r_count; ++r) {
      bulk_load(base + 4 * r * chunk, scores + (it.head0 + r) * s_len + it.j0, s_bytes, sb);
      bulk_load(base + 4 * r_count * chunk + st_bytes * r, stats + (it.head0 + r) * sst,
                st_bytes, sb);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kSlots * kBars; ++i) mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kSlots; ++s)
      if (blockIdx.x + s * gridDim.x < n_items) issue_cache(blockIdx.x + s * gridDim.x, s);
  }
  if (kUsePdl) {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the score pass is done
  }
  if (tid == 0)
    for (int s = 0; s < kSlots; ++s)
      if (blockIdx.x + s * gridDim.x < n_items) issue_pass1(blockIdx.x + s * gridDim.x, s);
  __syncthreads();

  int k = 0;
  for (int idx = blockIdx.x; idx < n_items; idx += gridDim.x, ++k) {
    const int slot = k % kSlots;
    const uint32_t par = (k / kSlots) & 1;
    const Item it = item_at(idx, bg_count, g_count, hq, s_len, chunk, pos);
    const uint64_t* sb = bars + slot * kBars;
    unsigned char* base = slots + slot * slot_bytes;
    const float* vsb = reinterpret_cast<const float*>(base);
    float* pv = reinterpret_cast<float*>(base + 4 * chunk);  // (R, chunk): scores, then pv
    const float2* st = reinterpret_cast<const float2*>(base + 4 * chunk * (1 + r_count));
    const int8_t* vbuf = reinterpret_cast<const int8_t*>(base + slot_bytes) - chunk * D;
    const int nact = (it.n + chunk - 1) / chunk;  // the splits that hold positions j < n
    if (it.rows > 0) {
      mbar_wait(sb + 1, par);
      // each row's global max m and sum l from the splits' own: lane i holds splits i
      // and i + 32 (nsplit <= kMaxSplits) and its terms l_i exp(m_i - m), which are
      // summed in split order
      for (int r = warp; r < r_count; r += kSplitWarps) {
        const float2* sr = st + r * sst;
        const float2 none = make_float2(-INFINITY, 0.f);
        const float2 lo = lane < nact ? sr[lane] : none;
        const float2 hi = lane + 32 < nact ? sr[lane + 32] : none;
        float m = fmaxf(lo.x, hi.x);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
        const float t_lo = lane < nact ? lo.y * expf(lo.x - m) : 0.f;
        const float t_hi = lane + 32 < nact ? hi.y * expf(hi.x - m) : 0.f;
        float l = 0.f;
        for (int i = 0; i < nact; ++i)
          l += __shfl_sync(0xffffffffu, i < 32 ? t_lo : t_hi, i & 31);
        if (lane == 0) {
          ml[2 * r] = m;
          ml[2 * r + 1] = l;
        }
      }
      __syncthreads();
      // p = exp(s - m) / l over the whole row, times v_scale, rounded to q's dtype: the
      // reference's p * v_scale
      mbar_wait(sb, par);
      for (int i = tid; i < r_count * it.rows; i += kSplitThreads) {
        const int r = i / it.rows, j = i % it.rows;
        const float p = expf(pv[r * chunk + j] - ml[2 * r]) / ml[2 * r + 1];
        pv[r * chunk + j] = to_f32(from_f32<T>(p * vsb[j]));
      }
      __syncthreads();
      const size_t stride = static_cast<size_t>(nsplit) * D;  // a row's partials
      float* my_part = part + (it.head0 * nsplit + it.split) * D;
      for (int r0 = 0; r0 < r_count; r0 += RP)
        value_rows<RP, D>(vbuf, pv, red, sb + 2, par, my_part + r0 * stride, stride, r0,
                          r_count, it.rows, chunk);
    }

    __syncthreads();  // the slot is free
    if (tid == 0 && idx + kSlots * gridDim.x < n_items) {
      issue_cache(idx + kSlots * gridDim.x, slot);
      issue_pass1(idx + kSlots * gridDim.x, slot);
    }
  }
}

// Each output element of the split route: the chunks' partials summed in split order,
// cast to q's dtype (a slot with pos < 0 has no chunk and gives 0).
template <typename T, int D>
__global__ void __launch_bounds__(kCombineThreads) int8_decode_split_combine_kernel(
    const float* __restrict__ part, const int32_t* __restrict__ pos, T* __restrict__ out,
    int b_count, int hq, int s_len, int nsplit, int chunk) {
  if (kUsePdl) asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the value pass is done
  const size_t i = static_cast<size_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= static_cast<size_t>(b_count) * hq * D) return;
  const size_t head = i / D;
  const int d = static_cast<int>(i % D);
  const int nact = (attended(pos[head / hq], s_len) + chunk - 1) / chunk;
  float s = 0.f;
  for (int sp = 0; sp < nact; ++sp) s += __ldcg(part + (head * nsplit + sp) * D + d);
  out[i] = from_f32<T>(s);
}

// A launch as a programmatic dependent of the kernel before it on the stream.
template <typename K, typename... Args>
cudaError_t launch_dependent(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t stream,
                             Args... args) {
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  config.attrs = attr;
  config.numAttrs = kUsePdl ? 1 : 0;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

// Blocks of a persistent grid of `items` items: as many as fit on the card at once.
// A kernel's shared-memory limit is raised to kSmemMax, and its blocks per SM at a
// given shared memory are read, once per (kernel, device, bytes): host calls a
// launch would otherwise repeat.
template <typename K>
cudaError_t grid_of(K kernel, size_t smem, int items, int* blocks) {
  struct Seen {
    const void* fn;
    int dev;
    size_t smem;
    int per_sm, sms;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int n_seen = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  bool raised = false;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].fn != fn || seen[i].dev != dev) continue;
    raised = true;
    if (seen[i].smem == smem) {
      *blocks = min(items, seen[i].per_sm * seen[i].sms);
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  if (!raised)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemMax));
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSplitThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  if (n_seen < 64) seen[n_seen++] = {fn, dev, smem, per_sm, sms};
  *blocks = min(items, per_sm * sms);
  return cudaSuccess;
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const int8_t* kc, const int8_t* vc, const float* ks,
                         const float* vs, const int32_t* pos, void* out, float* scores,
                         float2* stats, float* part, int b, int hq, int g, int s_len, float scale,
                         int nsplit, cudaStream_t stream) {
  const int r = hq / g;
  const int chunk = split_chunk(s_len, nsplit);
  const int ns = (s_len + chunk - 1) / chunk;
  const size_t smem1 = split_scores_smem(r, chunk, D, sizeof(T));
  const size_t smem2 = split_values_smem(r, chunk, D, nsplit);
  if (ns != nsplit || ns > kMaxSplits || chunk > kMaxChunk || smem1 > kSmemMax ||
      smem2 > kSmemMax)
    return cudaErrorInvalidValue;
  auto scores_kernel = r == 1 ? int8_decode_split_scores_kernel<T, D, true>
                              : int8_decode_split_scores_kernel<T, D, false>;
  auto values_kernel = r == 1 ? int8_decode_split_values_kernel<T, D, 1>
                              : int8_decode_split_values_kernel<T, D, kRowsPerPass>;
  const int items = b * g * ns;
  int blocks1 = 0, blocks2 = 0;
  cudaError_t err = grid_of(scores_kernel, smem1, items, &blocks1);
  if (err == cudaSuccess) err = grid_of(values_kernel, smem2, items, &blocks2);
  if (err != cudaSuccess) return err;
  scores_kernel<<<blocks1, kSplitThreads, smem1, stream>>>(
      static_cast<const T*>(q), kc, ks, pos, scores, stats, hq, g, b * g, s_len, ns, chunk,
      scale);
  err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_dependent(values_kernel, dim3(blocks2), kSplitThreads, smem2, stream, vc, vs,
                           pos, static_cast<const float*>(scores),
                           static_cast<const float2*>(stats), part, hq, g, b * g, s_len, ns,
                           chunk);
  const size_t outputs = static_cast<size_t>(b) * hq * D;
  if (err == cudaSuccess)
    err = launch_dependent(int8_decode_split_combine_kernel<T, D>,
                           dim3(static_cast<unsigned>((outputs + kCombineThreads - 1) /
                                                      kCombineThreads)),
                           kCombineThreads, 0, stream, static_cast<const float*>(part), pos,
                           static_cast<T*>(out), b, hq, s_len, ns, chunk);
  return err;
}

}  // namespace

extern "C" {

// q: (B, Hq, 1, D) f32 (q_bf16 = 0) or bf16 (q_bf16 = 1); kc/vc: one layer's
// (B, G, S, D) int8 codes; ks/vs: (B, G, S) f32 scales; pos: (B,) int32 on
// the device; out: (B, Hq, 1, D) in q's dtype. D is 64 or 128, S a multiple of
// 64. nsplit = 1 takes the one-block kernel (scratch unused, may be null);
// nsplit > 1 the split route, whose scratch the caller allocates: scores
// (B, Hq, S) f32, stats (B * Hq, nsplit rounded up to even) float pairs, part
// (B * Hq, nsplit, D) f32. nsplit must be S over split_chunk(S, nsplit), rounded
// up, and at most kMaxSplits. Anything else is refused with cudaErrorInvalidValue.
int fm_int8_decode_attention(const void* q, int q_bf16, const int8_t* kc, const int8_t* vc,
                             const float* ks, const float* vs, const int32_t* pos, void* out,
                             float* scores, float* stats, float* part, int b, int hq, int g,
                             int s_len, int d, float scale, int nsplit, cudaStream_t stream) {
  if ((d != 64 && d != 128) || b < 1 || g < 1 || hq % g != 0 || s_len < 64 || s_len % 64 != 0 ||
      nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (nsplit == 1) {
    const size_t smem = smem_bytes(hq / g, s_len, d);
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (q_bf16)
      err = d == 64 ? launch<__nv_bfloat16, 64>(q, kc, vc, ks, vs, pos, out, b, hq, g, s_len,
                                               scale, smem, stream)
                    : launch<__nv_bfloat16, 128>(q, kc, vc, ks, vs, pos, out, b, hq, g, s_len,
                                                scale, smem, stream);
    else
      err = d == 64 ? launch<float, 64>(q, kc, vc, ks, vs, pos, out, b, hq, g, s_len, scale,
                                       smem, stream)
                    : launch<float, 128>(q, kc, vc, ks, vs, pos, out, b, hq, g, s_len, scale,
                                        smem, stream);
    return static_cast<int>(err);
  }
  if (!scores || !stats || !part) return static_cast<int>(cudaErrorInvalidValue);
  float2* st = reinterpret_cast<float2*>(stats);
  if (q_bf16)
    err = d == 64 ? launch_split<__nv_bfloat16, 64>(q, kc, vc, ks, vs, pos, out, scores, st, part,
                                                   b, hq, g, s_len, scale, nsplit, stream)
                  : launch_split<__nv_bfloat16, 128>(q, kc, vc, ks, vs, pos, out, scores, st,
                                                    part, b, hq, g, s_len, scale, nsplit, stream);
  else
    err = d == 64 ? launch_split<float, 64>(q, kc, vc, ks, vs, pos, out, scores, st, part, b, hq,
                                           g, s_len, scale, nsplit, stream)
                  : launch_split<float, 128>(q, kc, vc, ks, vs, pos, out, scores, st, part, b,
                                            hq, g, s_len, scale, nsplit, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
