// Trainable causal softmax attention, forward (out and log-sum-exp), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _whole_fwd (fastmax_tpu/ops/flash_attention.py:561, entry
// flash_attention_fused) and _fwd_lse (:230, entry flash_attention_trainable). The two
// compute one function and differ only in the key block of their online softmax: 512 keys
// (or the whole T when T <= 512) for the fused entry, block_k (128) for the other. The
// block matters in bfloat16, where p is rounded against the running max of the blocks seen
// so far, so it is a run-time argument here ("ob") and this kernel serves both entries.
//
// q, k, v: (BH, T, D), k/v already repeated to the query heads; out (BH, T, D) in q's type;
// lse (BH, T) f32. Row i attends key j iff j <= i. Per row, as the reference does:
//
//   for each online block of ob keys (blocks past the row skipped: all masked, a no-op):
//     s     = (q . k) * scale in f32, masked with -1e30
//     m_new = max(m, rowmax s);  p = exp(s - m_new);  alpha = exp(m - m_new)
//     l     = l * alpha + rowsum p                (the unrounded f32 p)
//     acc   = acc * alpha + round_to_v_type(p) . v  (f32 sums)
//   out = acc / l in q's type;  lse = m + log(l).
//
// Bound: operations, 4 D flops per visible (row, key) pair; at the finetune shape (B=2,
// H=32, T=2048, D=128) 69.5 us on the bf16 tensor cores. Two kernels, chosen statically:
//
// bf16 with D = 64, 128 or 256 (the finetune's type; Llama-2-7B's head, Gemma's and
// pythia-1b's): the tensor cores. A CTA of 4 warps owns 64 query rows of one head; a warp
// owns 16 whole rows, so a row's max and sum need only the shuffles within a quad of the mma
// fragment layout. Q is staged once in shared memory; K and V stream in 64-key tiles
// through a double-buffered ring (cp.async, 16 B a thread, zero-filled past the block).
// Rows are stored in 16-byte chunks XOR-swizzled by row, so ldmatrix reads are free of bank
// conflicts. Both products are mma.sync m16n8k16 bf16 x bf16 -> f32; V is read with
// ldmatrix.trans. 167 registers a thread at D = 128 let 3 CTAs share an SM. Holding Q's
// fragments in registers, or giving a warp 32 rows (two m16 tiles: each K/V fragment read
// serves both), needs more registers (both spill at D = 128) and measured no faster. At
// D = 256 a warp's O accumulator is 128 f32 registers a thread beside 32 of a tile's scores,
// so the launch bound asks for 2 CTAs an SM (kTcMinCtas: up to 255 registers) and Q's
// fragments are still read from shared memory at each use: 255 registers, no spills, with
// 64-key tiles; the CTA's 96 KB of shared memory lets 2 CTAs share an SM.
//
// p must be rounded to bf16 against the max of the whole online block (up to 512 keys),
// not of a 64-key tile: the rounding of p is part of the reference's function, and a
// tile's max moves the output by about 3e-4 of its mean, six times the check's gate. A
// block's scores do not fit in registers, so each block takes two passes over its keys:
// pass 1 runs the Q K^T products and keeps only the row max; pass 2 runs the very same mma
// sequence again (so s has the same bits and s - m_new <= 0), forms p = exp(s - m_new)
// with s already multiplied by scale (neither scale nor log2 e is folded into q or an
// exp2: either would move the rounding of p), adds the unrounded p to l, and turns the f32
// score fragment straight into the bf16 A fragment of P V (cvt.rn, round to nearest even,
// as the reference's cast). acc is rescaled by alpha once a block. The second Q K^T costs
// half the function's operations again. Keeping the block's f32 scores in shared memory
// instead (64 x 512 x 4 = 128 KB a CTA) would leave one CTA of 4 warps an SM.
//
// f32, and bf16 with D = 192: f32 FMAs from shared memory (bf16 widened on load). The
// reference multiplies f32 operands in f32 (TF32 would change the results). D = 192 is the
// only bf16 head left on this kernel: no model of the registry has it. One CTA owns BQ
// query rows (64, or 32 for D >= 192) and keeps a block's scores whole in shared memory
// (BQ x ob f32) until its row max is known.
//
// Both issue tiles heaviest first (the last query tile sees the most keys). No atomics:
// every sum has one order, so repeated calls give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;        // keys staged in shared memory at a time
constexpr int kMaxBlock = 512; // the largest online block the kernel takes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// ------------------------------------------------------------------ bf16 on the tensor cores

constexpr int kTcWarps = 4;                // warps of a CTA, 16 query rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcRows = 16 * kTcWarps;     // query rows of a CTA
constexpr int kStages = 2;                 // 64-key tiles of K or V in flight
static_assert(kTcRows == kBK, "load_tile stages the Q tile");
// CTAs an SM the launch bound asks for: 3 (at most 170 registers a thread) up to D = 128,
// 2 (255) at D = 256, whose accumulator alone takes 128
template <int D> constexpr int kTcMinCtas = D <= 128 ? 3 : 2;

// shared memory: the CTA's Q tile, then the ring of K/V tiles
template <int D> constexpr size_t tc_smem_bytes() {
  return static_cast<size_t>(kTcRows + kStages * kBK) * D * sizeof(bf16);
}

// rows [r0, r0 + kBK) of a (T, D) head into a tile; rows at or past `rend` zero-filled
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0, int rend,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < kBK * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < rend;
    cp_async16(dst + swz<D>(r, c), src + static_cast<size_t>(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// The order in which a CTA reads 64-key tiles: per online block [k0, kend), pass 1's K
// tiles, then pass 2's K and V tiles in turn.
struct TileCursor {
  int k0, kt, pass, is_v;
  __device__ __forceinline__ void next(int ob, int kend) {
    if (pass == 0) {
      kt += kBK;
      if (kt >= kend) pass = 1, kt = k0, is_v = 0;
    } else if (!is_v) {
      is_v = 1;
    } else {
      is_v = 0;
      kt += kBK;
      if (kt >= kend) k0 += ob, kt = k0, pass = 0;
    }
  }
};

// s (a warp's 16 rows x the tile's 64 keys, mma C fragments: s[j][e] is row w0 + g +
// 8 (e >> 1), key kt + 8 j + 2 t + (e & 1)) = (q . k) * scale, masked with kNegInf where
// key > row or key >= kend. Each d step loads the warp's Q fragment once and issues 8
// independent mma. A tile past every row of the warp skips its products. Pass 1 and pass 2
// call this alike, so both see the same bits.
template <int D>
__device__ __forceinline__ void tile_scores(float s[8][4], const bf16* qs, const bf16* ks,
                                            int kt, int kend, int w0, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int qrow = w0 % kTcRows + (lane & 15);  // this lane's ldmatrix rows
  const int krow = (lane & 7) + (lane >> 4) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
  if (kt <= min(w0 + 15, kend - 1)) {  // warp-uniform
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
  }
  const bool all_visible = kt + kBK - 1 <= min(w0, kend - 1);  // warp-uniform
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = __fmul_rn(s[j][e], scale);
      if (!all_visible) {
        const int key = kt + 8 * j + 2 * t + (e & 1);
        const int row = w0 + g + 8 * (e >> 1);
        const int lim = min(row, kend - 1);
        if (key > lim) v = kNegInf;
      }
      s[j][e] = v;
    }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, kTcMinCtas<D>) flash_train_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    bf16* __restrict__ out, float* __restrict__ lse, int t_len, int ob, float scale) {
  constexpr int kTile = kBK * D;  // elements of one stage
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* ring = qs + kTcRows * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcRows;  // heaviest tiles first
  const int last_row = min(q0 + kTcRows, t_len) - 1;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const bf16* kb = k + head;
  const bf16* vb = v + head;
  const int w0 = q0 + 16 * warp;  // the warp's first row; this thread's are w0 + g (+ 8)

  // the ring: item i in stage i % kStages; kStages - 1 items in flight ahead of use. The Q
  // tile goes with the first group.
  TileCursor cur{0, 0, 0, 0};
  int issued = 0, used = 0;
  auto issue = [&]() {
    if (cur.k0 <= last_row) {
      const int kend = min(cur.k0 + ob, last_row + 1);
      load_tile<D>(ring + (issued % kStages) * kTile, cur.is_v ? vb : kb, cur.kt, kend, tid);
      cur.next(ob, kend);
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
  load_tile<D>(qs, q + head, q0, t_len, tid);
  for (int i = 0; i < kStages - 1; ++i) issue();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float s[8][4];

  for (int k0 = 0; k0 <= last_row; k0 += ob) {
    // keys past the tile's last row are masked for every row of it: leaving them out of
    // the block changes neither its max nor its sums
    const int kend = min(k0 + ob, last_row + 1);
    // ---- pass 1: the block's row max
    float m_new[2] = {kNegInf, kNegInf};
    for (int kt = k0; kt < kend; kt += kBK) {
      tile_scores<D>(s, qs, acquire(), kt, kend, w0, scale, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m_new[e >> 1] = fmaxf(m_new[e >> 1], s[j][e]);
    }
    float alpha[2], bs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 1));
      m_new[h] = fmaxf(m_new[h], __shfl_xor_sync(0xffffffffu, m_new[h], 2));
      m_new[h] = fmaxf(m[h], m_new[h]);
      alpha[h] = expf(m[h] - m_new[h]);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    // ---- pass 2: p against the block's max; l += p; acc += bf16(p) . v
    for (int kt = k0; kt < kend; kt += kBK) {
      tile_scores<D>(s, qs, acquire(), kt, kend, w0, scale, lane);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(__fsub_rn(s[j][e], m_new[e >> 1]));
          bs[e >> 1] += p;
          s[j][e] = p;
        }
      const bf16* vs = acquire();
      const int klim = min(w0 + 15, kend - 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kt + 16 * kk > klim) continue;  // warp-uniform: p is 0 on these keys
        const uint32_t a[4] = {pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bs[h] += __shfl_xor_sync(0xffffffffu, bs[h], 1);
      bs[h] += __shfl_xor_sync(0xffffffffu, bs[h], 2);
      l[h] = l[h] * alpha[h] + bs[h];
      m[h] = m_new[h];
    }
  }
  cp_async_wait<0>();

  bf16* ob_out = out + head;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row >= t_len) continue;
    bf16* orow = ob_out + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] / l[h], acc[n][2 * h + 1] / l[h]);
    if (t == 0) lse[static_cast<size_t>(bh) * t_len + row] = m[h] + logf(l[h]);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, float* lse,
                      int bh, int t_len, int ob, float scale, cudaStream_t stream) {
  // cp.async copies 16-byte chunks of the rows: the bases must be 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (bases % 16 != 0) return cudaErrorMisalignedAddress;
  auto kernel = flash_train_fwd_tc_kernel<D>;
  constexpr int kSmem = static_cast<int>(tc_smem_bytes<D>());
  // set once, before any CUDA-graph capture of a launch
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(bh, (t_len + kTcRows - 1) / kTcRows);
  kernel<<<grid, kTcThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lse, t_len, ob, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32 FMAs

template <int D> __host__ __device__ constexpr int tile_rows() { return D <= 128 ? 64 : 32; }

// shared floats for an online block of `ob_pad` (ob rounded up to 64) keys
template <int D>
size_t smem_bytes(int ob_pad) {
  constexpr int BQ = tile_rows<D>();
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (D + 4) + kBK * (D + 1) + BQ * (ob_pad + 4) + 3 * BQ);
}

// Thread layout: ty = tid / 16 owns query rows R*ty .. R*ty+R-1 (R = BQ / 16) of the tile;
// tx = tid % 16 owns key columns tx + 16c of a staged tile (scores) and head-dim columns
// tx + 16c (the accumulator).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_train_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int t_len, int ob, float scale) {
  constexpr int BQ = tile_rows<D>();
  constexpr int R = BQ / 16;
  constexpr int QS = D + 4;   // padded row strides: the 16 key columns of a warp
  constexpr int KS = D + 1;   // fall on distinct banks
  constexpr int CD = D / 16;  // accumulator columns per thread
  const int ob_pad = (ob + kBK - 1) / kBK * kBK;
  const int SS = ob_pad + 4;
  extern __shared__ float smem[];
  float* qs = smem;                 // (BQ, QS)  query tile
  float* kvs = qs + BQ * QS;        // (kBK, KS) staged keys, then values
  float* ss = kvs + kBK * KS;       // (BQ, SS)  a block's scores, then p rounded to T
  float* m_s = ss + BQ * SS;        // (BQ) running max
  float* l_s = m_s + BQ;            // (BQ) running sum
  float* a_s = l_s + BQ;            // (BQ) this block's alpha

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = tile * BQ;
  const int rows = min(BQ, t_len - q0);
  const int last_row = q0 + rows - 1;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const T* qb = q + head + static_cast<size_t>(q0) * D;
  const T* kb = k + head;
  const T* vb = v + head;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * QS + c] = r < rows ? to_f32(qb[static_cast<size_t>(r) * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 <= last_row; k0 += ob) {
    // keys past the tile's last row are masked for every row of it: leaving them out of
    // the block changes neither its max nor its sums
    const int kend = min(k0 + ob, last_row + 1);
    const int nk = kend - k0;
    // ---- the block's scores, one staged tile of keys at a time
    for (int kt = k0; kt < kend; kt += kBK) {
      __syncthreads();  // kvs is free
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kt + r;
        kvs[r * KS + c] = key < kend ? to_f32(kb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
      float sc[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[R], kv[4];
#pragma unroll
        for (int i = 0; i < R; ++i) qv[i] = qs[(R * ty + i) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = kvs[(tx + 16 * c) * KS + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qpos = q0 + R * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kt + tx + 16 * c;
          const bool ok = key <= qpos && key < kend;
          if (key < kend) ss[(R * ty + i) * SS + key - k0] = ok ? sc[i][c] * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    // ---- online softmax: warp w takes rows w*BQ/8 .. ; lanes stride over the block
    for (int r = warp * (BQ / kWarps); r < (warp + 1) * (BQ / kWarps); ++r) {
      float* row = ss + r * SS;
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = round_to<T>(p);
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
    for (int i = 0; i < R; ++i) {
      const float alpha = a_s[R * ty + i];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    // ---- acc += p . v, one staged tile of values at a time
    for (int kt = k0; kt < kend; kt += kBK) {
      __syncthreads();  // kvs was last read by the score pass or the previous tile
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kt + r;
        kvs[r * KS + c] = key < kend ? to_f32(vb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
      const int nj = min(kBK, kend - kt);
      const float* pb = ss + (kt - k0);
      for (int j = 0; j < nj; ++j) {
        float pv[R], vv[CD];
#pragma unroll
        for (int i = 0; i < R; ++i) pv[i] = pb[(R * ty + i) * SS + j];
#pragma unroll
        for (int c = 0; c < CD; ++c) vv[c] = kvs[j * KS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }
  __syncthreads();
  T* ob_out = out + head + static_cast<size_t>(q0) * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (r < rows) {
      const float l = l_s[r];
#pragma unroll
      for (int c = 0; c < CD; ++c)
        ob_out[static_cast<size_t>(r) * D + tx + 16 * c] = from_f32<T>(acc[i][c] / l);
      if (tx == 0) lse[static_cast<size_t>(bh) * t_len + q0 + r] = m_s[r] + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int t_len, int ob, float scale, cudaStream_t stream) {
  auto kernel = flash_train_fwd_kernel<T, D>;
  // set once for the largest block, before any CUDA-graph capture of a launch
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>(kMaxBlock)));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  constexpr int BQ = tile_rows<D>();
  const dim3 grid((t_len + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem_bytes<D>((ob + kBK - 1) / kBK * kBK), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, t_len, ob, scale);
  return cudaGetLastError();
}

// The kernel for a type and head size, chosen statically: bf16 at D = 64, 128 and 256 on
// the tensor cores, f32 and bf16 at D = 192 on the FMA kernel.
template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                     int t_len, int d, int ob, float scale, cudaStream_t stream);

template <>
cudaError_t launch_d<bf16>(const void* q, const void* k, const void* v, void* out, float* lse,
                           int bh, int t_len, int d, int ob, float scale, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_tc<64>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 128: return launch_tc<128>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 192: return launch_fma<bf16, 192>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 256: return launch_tc<256>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_d<float>(const void* q, const void* k, const void* v, void* out, float* lse,
                            int bh, int t_len, int d, int ob, float scale, cudaStream_t stream) {
  switch (d) {
    case 64: return launch_fma<float, 64>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 128: return launch_fma<float, 128>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 192: return launch_fma<float, 192>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 256: return launch_fma<float, 256>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out: (BH, T, D) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); lse: (BH, T) f32.
// D is 64, 128, 192 or 256; T >= 1; 1 <= ob <= 512 (the online block, in keys).
int fm_flash_train_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int bf16, int bh, int t_len, int d, int ob, float scale,
                       cudaStream_t stream) {
  if (ob < 1 || ob > kMaxBlock || t_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, l, bh, t_len, d, ob, scale, stream)
           : launch_d<float>(q, k, v, out, l, bh, t_len, d, ob, scale, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
