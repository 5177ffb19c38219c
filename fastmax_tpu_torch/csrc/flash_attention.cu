// Causal flash attention (forward) for KV-cache prefill, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention (fastmax_tpu/ops/flash_attention.py:137).
// q: (B, Hq, T, D); k, v: (B, G, S, D) in q's dtype (float32 or bfloat16), read at
// group granularity: query head h uses kv head h / (Hq / G), with no expanded copy.
// Query row i (absolute position pos0 + i) attends key j iff j <= pos0 + i and
// j < kv_len. The arithmetic is the Pallas kernel's, block for block:
//
//   for each key block of 128 (blocks past the causal frontier or kv_len skipped):
//     s     = (q . k) * scale in f32, masked with -1e30
//     m_new = max(m, rowmax(s));  p = exp(s - m_new);  alpha = exp(m - m_new)
//     l     = l * alpha + rowsum(p)                      (the unrounded f32 p)
//     acc   = acc * alpha + round_to_v_dtype(p) . v       (f32 accumulation)
//   out = acc / (l == 0 ? 1 : l), in q's dtype.
//
// The TPU grid walks the key blocks in order with (m, l, acc) in VMEM scratch; here one CTA
// owns a 64-row query tile of one head and loops over the key blocks itself. Blocks a tile
// does not need are skipped: one past kv_len, or past its last row's causal frontier, is
// masked for every row of it (exp gives 0 and alpha 1: a no-op). Only the T real rows are
// written: a ragged last tile is masked, not padded. The key range of a row is never split
// across CTAs (split-KV): the running max at each 128-key block would change, and with it
// the rounding of p. No atomics: repeated calls give the same bits.
//
// Bound: operations, 4 D flops per visible (row, key) pair, at prefill lengths; for bf16 on
// the tensor cores (7B, T = 512 at pos0 3584: 32.6 us), for f32 on the f32 units. Two
// kernels, chosen statically by type and head size (launch_d):
//
// bf16 with D = 64 or 128 (Llama-2-7B's head): the tensor cores, flash_attention_tc_kernel.
// A CTA of 4 warps owns 64 query rows; a warp owns 16 whole rows, so a row's max and sum
// need only the shuffles within a quad of the mma fragment layout. Q is staged once in
// shared memory; K and V stream in 64-key tiles through mma_bf16.cuh's double-buffered
// cp.async ring (16-byte chunks XOR-swizzled by row, zero-filled past the needed keys), the
// two K tiles of a block and then its two V tiles. Both products are mma.sync m16n8k16
// bf16 x bf16 -> f32; V is read with ldmatrix.trans. One pass a block suffices: the
// reference's block is 128 keys, and a warp holds the f32 scores of all of them (16 x 128:
// 64 registers a thread) beside its accumulator (16 x D), so the row max over the whole
// block is known before any p is formed. (K6's blocks are 512 keys and need a second Q K^T
// for that.) p is rounded against that max, as the reference rounds it: a 64-key tile's
// max would move the output by about 1e-3 of its mean. The arithmetic keeps the
// reference's order: s is multiplied by scale as its own rounded step (__fmul_rn, so that
// nvcc does not contract it with the subtraction of m), p = expf(s - m_new) with neither
// scale nor log2 e folded into q or an exp2, masked entries are -1e30 (never -inf), l sums
// the unrounded p, and cvt.rn (round to nearest even, the reference's cast) turns each
// 16-key slice of the f32 score fragment straight into the bf16 A fragment of P V. acc is
// rescaled by alpha once a block. The mask is tested only in blocks that hold a masked
// pair (the causal frontier and kv_len's last block); a wholly visible block runs an
// unmasked copy that gives the same bits, and a warp skips the products of tiles and
// 16-key slices past its last row. Tiles go heaviest first (the last query tile sees the
// most keys). 233 registers a thread at D = 128 (202 at D = 64), no spills: 2 CTAs an SM.
// Splitting each block's keys between two warps of the same rows (32 score registers a
// warp, twice the warps an SM, the row max exchanged through shared memory), a third ring
// stage, or 3 CTAs an SM measured no faster at the 7B shapes.
//
// f32, and bf16 with D = 192 or 256: f32 FMAs from shared memory, flash_attention_kernel
// (bf16 widened on load). The reference multiplies f32 operands in f32, and TF32 would
// change the results. D = 192 and 256 in bf16 take it by a static choice: they are off
// Llama-2-7B's path, and their accumulators (96 and 128 registers a thread for 16 rows)
// have not been fitted beside the block's scores. A CTA of 256 threads owns a 64-row
// query tile, keeps (m, l) in shared memory and acc in registers, and stages k and v in
// 64-key halves through shared memory, p going through a (64, 132) f32 score tile. It uses
// ~100 KB of shared memory at D = 128, so two CTAs fit on an SM; D = 192 and 256 (134 and
// 167 KB) run one CTA an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBK = 128;   // keys per online-softmax block (the Pallas block_k)
constexpr int kHK = 64;    // keys staged in shared memory at a time
constexpr float kNegInf = -1e30f;

// ------------------------------------------------------------------ bf16 on the tensor cores

constexpr int kTcWarps = 4;                // warps of a CTA, 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;     // query rows of a CTA
constexpr int kStages = 2;                 // 64-key tiles of K or V in flight
static_assert(kTcRows == kHK, "load_tile stages the Q tile");

// shared memory: the CTA's Q tile, then the ring of K/V tiles
template <int D> constexpr int tc_smem_bytes() {
  return (kTcRows + kStages * kHK) * D * static_cast<int>(sizeof(bf16));
}

// rows [r0, r0 + kHK) of a (rows, D) matrix into a tile; rows at or past `rend` zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int rend,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < kHK * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < rend;
    cp_async16(dst + swz<D>(r, c), src + static_cast<size_t>(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// s (warp w's 16 rows x the tile's 64 keys, mma C fragments: s[j][e] is row 16 w + g +
// 8 (e >> 1) of the CTA's tile, key kt + 8 j + 2 t + (e & 1)) = (q . k) * scale, masked with
// kNegInf where the key lies past the row's last key lim[e >> 1]. lo and hi are the least
// and the largest last key of the warp's rows: a tile past hi is masked whole and skips
// its products; a tile at or below lo is visible whole and tests no mask.
template <int D>
__device__ __forceinline__ void tile_scores(float s[8][4], const bf16* qs, const bf16* ks,
                                            int kt, int w, const int lim[2], int lo, int hi,
                                            float scale, int lane) {
  if (kt > hi) {  // warp-uniform
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = kNegInf;
    return;
  }
  const int t = lane & 3;
  const int qrow = 16 * w + (lane & 15);  // this lane's ldmatrix rows
  const int krow = (lane & 7) + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t qa[4];
    ldsm_x4(qa, qs + swz<D>(qrow, 2 * kk + (lane >> 4)));
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      uint32_t b[4];
      ldsm_x4(b, ks + swz<D>(16 * jp + krow, 2 * kk + ((lane >> 3) & 1)));
      mma_bf16(s[2 * jp], qa, b[0], b[1]);
      mma_bf16(s[2 * jp + 1], qa, b[2], b[3]);
    }
  }
  if (kt + kHK - 1 <= lo) {  // warp-uniform: every pair of the tile is visible
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt + 8 * j + 2 * t + (e & 1);
        const float v = __fmul_rn(s[j][e], scale);
        s[j][e] = key > lim[e >> 1] ? kNegInf : v;
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2) flash_attention_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, int hq, int g_count, int t_len, int s_len, int pos0, int kv_len,
    float scale) {
  constexpr int kTile = kHK * D;  // elements of one stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + kTcRows * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int kvh = (bh / hq) * g_count + (bh % hq) / (hq / g_count);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest tiles first
  const int last_row = min(q0 + kTcRows, t_len) - 1;
  // the keys some real row of the tile attends: below kv_len and at or below the last
  // row's position
  const int kv_hi = min(kv_len, pos0 + last_row + 1);
  const bf16* kb = k + static_cast<size_t>(kvh) * s_len * D;
  const bf16* vb = v + static_cast<size_t>(kvh) * s_len * D;
  // the last key each of this thread's rows (q0 + 16 warp + g, + 8) attends, and the least
  // and the largest of the warp's
  const int p0 = pos0 + q0 + 16 * warp;
  const int lim[2] = {min(p0 + g, kv_len - 1), min(p0 + g + 8, kv_len - 1)};
  const int lo = min(p0, kv_len - 1), hi = min(p0 + 15, kv_len - 1);

  // the ring: item i in stage i % kStages; kStages - 1 items in flight ahead of use. Per
  // block [k0, kend): its K tiles, then its V tiles. The Q tile goes with the first group.
  int c_k0 = 0, c_kt = 0, c_v = 0;
  int issued = 0, used = 0;
  auto issue = [&]() {
    if (c_k0 < kv_hi) {
      const int kend = min(c_k0 + kBK, kv_hi);
      load_tile<D>(ring + (issued % kStages) * kTile, c_v ? vb : kb, c_kt, kend, tid);
      c_kt += kHK;
      if (c_kt >= kend) {
        if (c_v) c_k0 += kBK;
        c_kt = c_k0;
        c_v ^= 1;
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count of groups
    ++issued;
  };
  auto acquire = [&]() -> const bf16* {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the item is everyone's; the stage read last is free
    issue();
    return ring + (used++ % kStages) * kTile;
  };
  load_tile<D>(qs, q + static_cast<size_t>(bh) * t_len * D, q0, t_len, tid);
  for (int i = 0; i < kStages - 1; ++i) issue();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < kv_hi; k0 += kBK) {
    const int kend = min(k0 + kBK, kv_hi);  // keys past it are masked for every real row
    // ---- the block's scores, s[8 h + j] from its 64-key tile h (a tile past kend is not
    // loaded: masked whole)
    float s[2 * 8][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kt = k0 + h * kHK;
      if (kt < kend) {  // CTA-uniform
        tile_scores<D>(s + 8 * h, qs, acquire(), kt, warp, lim, lo, hi, scale, lane);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[8 * h + j][e] = kNegInf;
      }
    }
    // ---- the row max over the whole block, then p against it, l and the rescaled acc
    float m_new[2] = {m[0], m[1]}, alpha[2], bs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      alpha[h] = expf(__fsub_rn(m[h], m_new[h]));
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(__fsub_rn(s[j][e], m_new[e >> 1]));
        bs[e >> 1] += p;
        s[j][e] = p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bs[h] += __shfl_xor_sync(0xffffffffu, bs[h], 1);
      bs[h] += __shfl_xor_sync(0xffffffffu, bs[h], 2);
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), bs[h]);
      m[h] = m_new[h];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = __fmul_rn(acc[n][e], alpha[e >> 1]);
    // ---- acc += bf16(p) . v, one 64-key tile at a time; a 16-key slice past kend or past
    // the warp's last key holds p = 0 only and is skipped
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kt = k0 + h * kHK;
      if (kt >= kend) continue;  // CTA-uniform
      const bf16* vs = acquire();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int j = 8 * h + 2 * kk;
        if (kt + 16 * kk > min(hi, kend - 1)) continue;  // warp-uniform
        uint32_t a[4];  // rows g, g + 8 of keys 2 t, 2 t + 1; then of keys 2 t + 8, 2 t + 9
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[r] = pack_bf16x2(s[j + (r >> 1)][2 * (r & 1)], s[j + (r >> 1)][2 * (r & 1) + 1]);
        const int key = 16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldsm_x4_trans(b, vs + swz<D>(key, 2 * np + (lane >> 4)));
          mma_bf16(acc[2 * np], a, b[0], b[1]);
          mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  bf16* ob = out + static_cast<size_t>(bh) * t_len * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + g + 8 * h;
    if (row >= t_len) continue;
    const float den = l[h] == 0.f ? 1.f : l[h];
    bf16* orow = ob + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] / den, acc[n][2 * h + 1] / den);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int b, int hq,
                      int g, int t_len, int s_len, int pos0, int kv_len, float scale,
                      cudaStream_t stream) {
  auto kernel = flash_attention_tc_kernel<D>;
  constexpr int kSmem = tc_smem_bytes<D>();
  static bool smem_set = false;  // set once, before any CUDA-graph capture of a launch
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(b * hq, (t_len + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), hq, g, t_len, s_len, pos0, kv_len, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32 FMAs

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;    // query rows per CTA
constexpr int kSS = kBK + 4;  // padded row stride of the score tile

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kHK * (D + 1) + kBQ * kSS + 3 * kBQ;
}

// Thread layout: ty = tid / 16 owns query rows 4*ty .. 4*ty+3 of the tile;
// tx = tid % 16 owns key columns tx + 16*c of a staged half (scores) and
// head-dim columns tx + 16*c (the accumulator).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int hq, int g_count, int t_len, int s_len, int pos0, int kv_len,
    float scale) {
  constexpr int QS = D + 4;   // padded row strides: the two row groups of a warp
  constexpr int KS = D + 1;   // and the 16 key columns fall on distinct banks
  constexpr int CD = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // (kBQ, QS)  query tile
  float* kvs = qs + kBQ * QS;       // (kHK, KS)  half a key block of k, then of v
  float* ss = kvs + kHK * KS;       // (kBQ, kSS) scores, then p rounded to T
  float* m_s = ss + kBQ * kSS;      // (kBQ) running max
  float* l_s = m_s + kBQ;           // (kBQ) running sum
  float* a_s = l_s + kBQ;           // (kBQ) this block's alpha

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int kvh = b * g_count + h / (hq / g_count);
  const int q0 = blockIdx.x * kBQ;
  const int rows = min(kBQ, t_len - q0);
  const T* qb = q + (static_cast<size_t>(bh) * t_len + q0) * D;
  const T* kb = k + static_cast<size_t>(kvh) * s_len * D;
  const T* vb = v + static_cast<size_t>(kvh) * s_len * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * QS + c] = r < rows ? to_f32(qb[static_cast<size_t>(r) * D + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  // key blocks needed by some real row of the tile: below kv_len and at or
  // below the last row's causal frontier (a skipped block is one the Pallas
  // kernel skips, or one whose every score is masked: exp gives 0, alpha 1)
  const int frontier = pos0 + q0 + rows - 1;
  const int n_blocks = max(0, min((min(kv_len, s_len) + kBK - 1) / kBK, frontier / kBK + 1));

  for (int jb = 0; jb < n_blocks; ++jb) {
    const int k0 = jb * kBK;
    // ---- scores of this block, one staged half at a time
    for (int half = 0; half < kBK / kHK; ++half) {
      const int kh0 = k0 + half * kHK;
      __syncthreads();  // kvs is free (last read by the previous value pass)
      for (int i = tid; i < kHK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kh0 + r;
        kvs[r * KS + c] = key < s_len ? to_f32(kb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = kvs[(tx + 16 * c) * KS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = pos0 + q0 + 4 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kh0 + tx + 16 * c;
          const bool ok = key <= qpos && key < kv_len;
          ss[(4 * ty + i) * kSS + half * kHK + tx + 16 * c] = ok ? sc[i][c] * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    // ---- online softmax: warp w takes rows 8w .. 8w+7, each lane 4 columns
    const int lane = tid % 32, warp = tid / 32;
    for (int r = warp * (kBQ / kWarps); r < (warp + 1) * (kBQ / kWarps); ++r) {
      float* row = ss + r * kSS;
      float s4[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s4[c] = row[lane + 32 * c];
        mx = fmaxf(mx, s4[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s4[c] - m_new);
        sum += p;
        row[lane + 32 * c] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[4 * ty + i];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    // ---- acc += p . v, one staged half at a time
    for (int half = 0; half < kBK / kHK; ++half) {
      const int kh0 = k0 + half * kHK;
      __syncthreads();  // kvs was last read by the score pass
      for (int i = tid; i < kHK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kh0 + r;
        kvs[r * KS + c] = key < s_len ? to_f32(vb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kHK; ++j) {
        float pv[4], vv[CD];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ss[(4 * ty + i) * kSS + half * kHK + j];
#pragma unroll
        for (int c = 0; c < CD; ++c) vv[c] = kvs[j * KS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<size_t>(bh) * t_len + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r < rows) {
      const float l = l_s[r];
      const float inv_l = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int c = 0; c < CD; ++c)
        ob[static_cast<size_t>(r) * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int g, int t_len, int s_len, int pos0, int kv_len, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = sizeof(float) * smem_floats<D>();
  static bool smem_set = false;  // set once, before any CUDA-graph capture of a launch
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((t_len + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, g, t_len, s_len, pos0, kv_len, scale);
  return cudaGetLastError();
}

// The kernel for a type and head size, chosen statically: bf16 at D = 64 and 128 on the
// tensor cores, everything else on the FMA kernel.
template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int b, int hq,
                     int g, int t_len, int s_len, int d, int pos0, int kv_len, float scale,
                     cudaStream_t stream);

template <>
cudaError_t launch_d<bf16>(const void* q, const void* k, const void* v, void* out, int b, int hq,
                           int g, int t_len, int s_len, int d, int pos0, int kv_len, float scale,
                           cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_tc<64>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale, stream);
    case 128:
      return launch_tc<128>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale, stream);
    case 192:
      return launch_fma<bf16, 192>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale,
                                   stream);
    case 256:
      return launch_fma<bf16, 256>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale,
                                   stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_d<float>(const void* q, const void* k, const void* v, void* out, int b,
                            int hq, int g, int t_len, int s_len, int d, int pos0, int kv_len,
                            float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_fma<float, 64>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale,
                                   stream);
    case 128:
      return launch_fma<float, 128>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale,
                                    stream);
    case 192:
      return launch_fma<float, 192>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale,
                                    stream);
    case 256:
      return launch_fma<float, 256>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, Hq, T, D); k, v: (B, G, S, D); out: (B, Hq, T, D); all contiguous, in
// f32 (bf16 = 0) or bf16 (bf16 = 1). D is 64, 128, 192 or 256; Hq % G == 0; T >= 1.
int fm_flash_attention(const void* q, const void* k, const void* v, void* out, int bf16,
                       int b, int hq, int g, int t_len, int s_len, int d, int pos0,
                       int kv_len, float scale, cudaStream_t stream) {
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, b, hq, g, t_len, s_len, d, pos0, kv_len,
                                     scale, stream)
           : launch_d<float>(q, k, v, out, b, hq, g, t_len, s_len, d, pos0, kv_len, scale,
                             stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
