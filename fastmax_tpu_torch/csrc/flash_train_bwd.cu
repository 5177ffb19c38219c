// Trainable causal softmax attention, backward (dq, dk, dv), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _whole_bwd (fastmax_tpu/ops/flash_attention.py:588, entry
// flash_attention_fused: dq, dk, dv in one pass) and _bwd (:358 dq, :380 dk/dv, entry
// flash_attention_trainable). Given do, the forward's lse and delta = rowsum(do * out) (f32,
// formed by the caller), for every visible (row i, key j), j <= i:
//
//   p  = exp(s - lse),  s = (q . k) * scale in f32
//   dp = do . v in f32;  ds = p * (dp - delta)
//   dv += round_to_do_type(p)^T . do;  dk += round_to_q_type(ds)^T . q;
//   dq += round_to_k_type(ds) . k       (every sum in f32)
//   dq, dk scaled by `scale` at the end; all three written in the inputs' type.
//
// q, k, v, do, dq, dk, dv: (BH, T, D), k/v repeated to the query heads; lse, delta (BH, T) f32.
//
// The TPU's fused kernel adds each block pair into a dq scratch that one core owns; on the
// card that sum would cross CTAs and need float atomics, whose order changes between runs.
// So dq is a pass apart, as in _bwd: the launch's CTAs take one of two roles, interleaved
// so the heaviest tiles of both start first. A dq CTA owns a tile of query rows of one
// head and walks the key tiles at or below it; a dk/dv CTA owns a tile of keys and walks
// the query tiles at or above it. Each recomputes p and ds for its block pairs (the dk/dv
// role also forms dv): seven products a pair against the function's five (s and dp twice),
// but each sum has one order, and repeated calls give the same bits.
//
// Bound: operations, 10 D flops per visible (row, key) pair (the two score products and the
// three gradient products); at the finetune shape (B=2, H=32, T=2048, D=128) 173.8 us on the
// bf16 tensor cores. Three kernels, chosen statically by type and D (launch_d):
//
// bf16 with D = 64, 128 or 256 (the finetune's type; Llama-2-7B's head, Gemma's and
// pythia-1b's): every product on the tensor cores, mma.sync m16n8k16 bf16 x bf16 -> f32, with
// K6's helpers (mma_bf16.cuh). A CTA owns a 64-row tile of one head, staged once in shared
// memory (Q and do in the dq role, K and V in the dk/dv role). The other side's 64-row tiles
// stream through a double-buffered cp.async ring, zero-filled past T; the dk/dv role's
// stages carry the query rows' lse and delta beside Q and do. Rows are stored in 16-byte
// chunks XOR-swizzled by row, as in K6, so ldmatrix reads have no bank conflicts. p and ds
// go from their f32 C fragments straight into bf16 A fragments (cvt.rn, round to nearest
// even, as the reference's casts). The causal and T masks are tested only in blocks that
// hold a masked pair (the diagonal tiles, the ragged last one); a wholly visible block takes
// an unmasked copy of the same arithmetic.
//
// D = 64 and 128 (flash_train_bwd_tc_kernel): a CTA of 4 warps, a warp 16 whole rows of the
// own tile. A warp takes a streamed tile 32 rows at a time:
//   dq role:    S = Q K^T and dP = do V^T (16 x 32 C fragments), p and ds = p (dP - delta),
//               then dQ += bf16(dS) K, K read with ldmatrix.trans;
//   dk/dv role: S^T = K Q^T and dP^T = V do^T, p^T and ds^T, then dV += bf16(P^T) do and
//               dK += bf16(dS^T) Q, do and Q read with ldmatrix.trans.
// Registers: a dk/dv warp holds dK and dV of its 16 keys, D f32 a thread, so it streams 32
// query rows at a time (not 64: 32 more score registers) and reads its K/V A fragments
// from shared memory at each use; a dq warp holds its Q/do A fragments in registers (D / 2).
// 246 registers a thread at D = 128, 186 at D = 64, no spills; 99.3 KB of shared memory a
// CTA at D = 128, 2 CTAs an SM. Holding the dk/dv warp's fragments too (16 query rows at a
// time), or 64-key steps in the dq role, measured no faster.
//
// D = 256 (flash_train_bwd_tc_pair_kernel, FlashAttention-2's split for large heads): dK and
// dV of 16 keys would take 256 registers a thread, so a CTA has 8 warps on its 64-row tile.
// Warps w and w + 4 (a pair) own the same 16 rows, and each holds the accumulators (dK and
// dV, or dQ) of one half of D: 128 columns, 128 registers in the dk/dv role, 64 in the dq
// role. Of each streamed 64-row tile, warp w forms p and ds (or their transposes) against
// the first 32 rows and warp w + 4 against the last 32, each contracting over the whole D
// with the own tile's A fragments read from shared memory at each use. Each rounds them to
// bf16 A fragments as above and writes them, lane by lane, to its pair's slots in shared
// memory; after a barrier of the pair (bar.sync of 64 threads), each warp adds all 64 rows
// into its half of D, the first 32 before the last. That adds no product and gives every
// sum one order; p and ds are rounded element by element (below), so rounding them before
// shared memory is rounding them as the reference does. 2 x 64.5 KB of stages, 64 KB of own
// tiles and 16 KB of exchange slots: 209 KB a CTA, one CTA an SM; 244 registers a thread,
// no spills.
//
// Why p and ds need no block-wide rounding, unlike K6's p: here p = exp(s * scale - lse)
// depends on its own element and the forward's lse alone, with no running max, so each
// rounding the reference makes (p to do's type before dv, ds to q's and k's type before dk
// and dq) is elementwise, and a tile of any size rounds the same values. s * scale is its
// own rounded f32 product (__fmul_rn): nvcc would contract s * scale - lse into one FMA.
//
// f32, and bf16 with D = 192: f32 FMAs from shared memory (bf16 widened on load). The
// reference multiplies f32 operands in f32 (TF32 would change the results). D = 192 is the
// only bf16 head left on this kernel: no model of the registry has it. A CTA of 8 warps owns
// BT rows (64, or 32 for D >= 192) and keeps a tile pair's p and ds in shared memory between
// the score and the gradient products.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// ------------------------------------------------------------------ f32 FMAs

constexpr int kThreads = 256;

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

template <int D> __host__ __device__ constexpr int tile_rows() { return D <= 128 ? 64 : 32; }

template <int D>
constexpr size_t smem_bytes() {
  constexpr int BT = tile_rows<D>();
  return sizeof(float) * (4 * BT * (D + 1) + 2 * BT * (BT + 4) + 2 * BT);
}

// rows [r0, r0 + BT) of a (T, D) head into a (BT, D + 1) f32 tile, zero past T
template <typename T, int D, int BT>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0, int t_len) {
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = r0 + r < t_len ? to_f32(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
}

// One (query tile q0, key tile k0) pair: p rounded to do's type into ps and ds rounded to
// q's (= k's) type into dss, both (BT query rows, BT keys). Thread (ty, tx) computes rows
// R*ty + i and keys tx + 16c (R = BT / 16).
template <typename T, int D, int BT>
__device__ __forceinline__ void pair_tile(const float* qs, const float* dos, const float* ks,
                                          const float* vs, const float* lse_s,
                                          const float* delta_s, float* ps, float* dss, int q0,
                                          int k0, int t_len, float scale) {
  constexpr int R = BT / 16;
  constexpr int S = D + 1;
  constexpr int PS = BT + 4;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[R][R], dp[R][R];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < R; ++c) s[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[R], dov[R], kv[R], vv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      qv[i] = qs[(R * ty + i) * S + d];
      dov[i] = dos[(R * ty + i) * S + d];
    }
#pragma unroll
    for (int c = 0; c < R; ++c) {
      kv[c] = ks[(tx + 16 * c) * S + d];
      vv[c] = vs[(tx + 16 * c) * S + d];
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < R; ++c) {
        s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
        dp[i][c] = fmaf(dov[i], vv[c], dp[i][c]);
      }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = R * ty + i;
    const int qpos = q0 + row;
    const float lse = lse_s[row], delta = delta_s[row];
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int col = tx + 16 * c;
      const int kpos = k0 + col;
      const bool ok = kpos <= qpos && qpos < t_len;
      const float p = ok ? expf(s[i][c] * scale - lse) : 0.f;
      const float ds = p * (dp[i][c] - delta);
      ps[row * PS + col] = round_to<T>(p);
      dss[row * PS + col] = round_to<T>(ds);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_train_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, int t_len, float scale) {
  constexpr int BT = tile_rows<D>();
  constexpr int R = BT / 16;
  constexpr int S = D + 1;
  constexpr int PS = BT + 4;
  constexpr int CD = D / 16;  // head-dim columns per thread: tx + 16c
  extern __shared__ float smem[];
  float* own_a = smem;              // dq role: q tile;     dk/dv role: k tile
  float* own_b = own_a + BT * S;    // dq role: do tile;    dk/dv role: v tile
  float* str_a = own_b + BT * S;    // dq role: k tiles;    dk/dv role: q tiles
  float* str_b = str_a + BT * S;    // dq role: v tiles;    dk/dv role: do tiles
  float* ps = str_b + BT * S;       // (BT, PS) p rounded to do's type
  float* dss = ps + BT * PS;        // (BT, PS) ds rounded to q's type
  float* lse_s = dss + BT * PS;     // (BT) lse of the query tile in hand
  float* delta_s = lse_s + BT;      // (BT) delta of the query tile in hand

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int n_tiles = (t_len + BT - 1) / BT;
  const int bh = blockIdx.y;
  const bool dq_role = (blockIdx.x & 1) == 0;
  // heaviest first in both roles: dq tiles from the last, dk/dv tiles from the first
  const int tile = dq_role ? n_tiles - 1 - static_cast<int>(blockIdx.x >> 1)
                           : static_cast<int>(blockIdx.x >> 1);
  if (tile < 0 || tile >= n_tiles) return;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * t_len;
  const float* delta_h = delta + static_cast<size_t>(bh) * t_len;
  const int t0 = tile * BT;

  float acc_a[R][CD], acc_b[R][CD];  // dq role: dq (acc_a); dk/dv role: dk (a), dv (b)
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc_a[i][c] = acc_b[i][c] = 0.f;

  if (dq_role) {
    load_tile<T, D, BT>(own_a, q + head, t0, t_len);
    load_tile<T, D, BT>(own_b, dout + head, t0, t_len);
    if (tid < BT) {
      const bool in = t0 + tid < t_len;
      lse_s[tid] = in ? lse_h[t0 + tid] : 0.f;
      delta_s[tid] = in ? delta_h[t0 + tid] : 0.f;
    }
    for (int kt = 0; kt <= tile; ++kt) {
      __syncthreads();  // the stream tiles and ps/dss are free
      load_tile<T, D, BT>(str_a, k + head, kt * BT, t_len);
      load_tile<T, D, BT>(str_b, v + head, kt * BT, t_len);
      __syncthreads();
      pair_tile<T, D, BT>(own_a, own_b, str_a, str_b, lse_s, delta_s, ps, dss, t0, kt * BT,
                          t_len, scale);
      __syncthreads();
      // dq[row] += ds[row, j] . k[j]
#pragma unroll 4
      for (int j = 0; j < BT; ++j) {
        float dsv[R], kv[CD];
#pragma unroll
        for (int i = 0; i < R; ++i) dsv[i] = dss[(R * ty + i) * PS + j];
#pragma unroll
        for (int c = 0; c < CD; ++c) kv[c] = str_a[j * S + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) acc_a[i][c] = fmaf(dsv[i], kv[c], acc_a[i][c]);
      }
    }
    T* dqb = dq + head + static_cast<size_t>(t0) * D;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = R * ty + i;
      if (t0 + r < t_len) {
#pragma unroll
        for (int c = 0; c < CD; ++c)
          dqb[static_cast<size_t>(r) * D + tx + 16 * c] = from_f32<T>(acc_a[i][c] * scale);
      }
    }
    return;
  }

  // dk/dv role: this tile's keys against every query tile at or above it
  load_tile<T, D, BT>(own_a, k + head, t0, t_len);
  load_tile<T, D, BT>(own_b, v + head, t0, t_len);
  for (int qt = tile; qt < n_tiles; ++qt) {
    const int q0 = qt * BT;
    __syncthreads();
    load_tile<T, D, BT>(str_a, q + head, q0, t_len);
    load_tile<T, D, BT>(str_b, dout + head, q0, t_len);
    if (tid < BT) {
      const bool in = q0 + tid < t_len;
      lse_s[tid] = in ? lse_h[q0 + tid] : 0.f;
      delta_s[tid] = in ? delta_h[q0 + tid] : 0.f;
    }
    __syncthreads();
    pair_tile<T, D, BT>(str_a, str_b, own_a, own_b, lse_s, delta_s, ps, dss, q0, t0, t_len,
                        scale);
    __syncthreads();
    // dv[key] += p[i, key] . do[i];  dk[key] += ds[i, key] . q[i]
#pragma unroll 2
    for (int i_q = 0; i_q < BT; ++i_q) {
      float pv[R], dsv[R], dov[CD], qv[CD];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        pv[i] = ps[i_q * PS + R * ty + i];
        dsv[i] = dss[i_q * PS + R * ty + i];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dov[c] = str_b[i_q * S + tx + 16 * c];
        qv[c] = str_a[i_q * S + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          acc_b[i][c] = fmaf(pv[i], dov[c], acc_b[i][c]);
          acc_a[i][c] = fmaf(dsv[i], qv[c], acc_a[i][c]);
        }
    }
  }
  T* dkb = dk + head + static_cast<size_t>(t0) * D;
  T* dvb = dv + head + static_cast<size_t>(t0) * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (t0 + r < t_len) {
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dkb[static_cast<size_t>(r) * D + tx + 16 * c] = from_f32<T>(acc_a[i][c] * scale);
        dvb[static_cast<size_t>(r) * D + tx + 16 * c] = from_f32<T>(acc_b[i][c]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, void* dk, void* dv, int bh,
                   int t_len, float scale, cudaStream_t stream) {
  auto kernel = flash_train_bwd_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  static bool smem_set = false;  // set once, before any CUDA-graph capture of a launch
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  constexpr int BT = tile_rows<D>();
  const dim3 grid(2 * ((t_len + BT - 1) / BT), bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, delta, static_cast<T*>(dq), static_cast<T*>(dk),
      static_cast<T*>(dv), t_len, scale);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16 on the tensor cores

constexpr int kTcWarps = 4;              // warps of a CTA, 16 own rows each
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTile = 16 * kTcWarps;     // rows of the own tile and of each streamed tile
constexpr int kStages = 2;               // streamed tiles in flight
constexpr int kNC = 2;                   // 16-row blocks of a streamed tile a warp takes at once
static_assert(kTcThreads >= 2 * kTile, "a stage's lse and delta take one thread a value");

// a stage: two (kTile, D) bf16 tiles, then kTile lse and kTile delta (f32)
template <int D> __host__ __device__ constexpr size_t stage_bytes() {
  return 2 * kTile * D * sizeof(bf16) + 2 * kTile * sizeof(float);
}
// shared memory: the CTA's two own tiles, then the ring of stages
template <int D> constexpr size_t tc_smem_bytes() {
  return 2 * kTile * D * sizeof(bf16) + kStages * stage_bytes<D>();
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// rows [r0, r0 + kTile) of a (T, D) head into a swizzled tile; rows at or past T zero-filled
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int r0, int t_len,
                                          int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r0 + r < t_len;
    cp_async16(dst + swz<D>(r, c), src + static_cast<size_t>(ok ? r0 + r : 0) * D + c * 8, ok);
  }
}

// A stage: streamed rows [r0, r0 + kTile) of the two tiles a and b and, where `stats` (the
// dk/dv role), the rows' lse (threads 0 .. kTile - 1) and delta (the next kTile threads)
template <int D, int kThreads>
__device__ __forceinline__ void load_stage(unsigned char* stage, const bf16* a, const bf16* b,
                                           const float* lse_h, const float* delta_h,
                                           bool stats, int r0, int t_len, int tid) {
  bf16* st = reinterpret_cast<bf16*>(stage);
  load_rows<D, kThreads>(st, a, r0, t_len, tid);
  load_rows<D, kThreads>(st + kTile * D, b, r0, t_len, tid);
  if (stats && tid < 2 * kTile) {
    const int r = tid % kTile;
    const bool ok = r0 + r < t_len;
    cp_async4(reinterpret_cast<float*>(st + 2 * kTile * D) + tid,
              (tid < kTile ? lse_h : delta_h) + (ok ? r0 + r : 0), ok);
  }
}

// p of one pair: exp(s * scale - lse), s * scale its own rounded f32 product. kMasked: 0
// where the key lies past the query or the query at or past T.
template <bool kMasked>
__device__ __forceinline__ float pair_p(float s, float lse, int key, int query, int t_len,
                                        float scale) {
  if constexpr (kMasked) {
    const bool visible = key <= query && query < t_len;
    if (!visible) return 0.f;
  }
  return expf(__fmul_rn(s, scale) - lse);
}

// ds of one pair, from the unrounded p
__device__ __forceinline__ float pair_ds(float p, float dp, float delta) {
  return p * (dp - delta);
}

// The dq role's p and ds in place of its block's s and dp (as dots gives them): the warp's
// rows w0 + g (+ 8) against keys k0 + 8 j + 2 t (+ 1); lse_r, delta_r of the thread's rows.
template <bool kMasked>
__device__ __forceinline__ void dq_scores(float s[2 * kNC][4], float dp[2 * kNC][4],
                                          const float lse_r[2], const float delta_r[2], int k0,
                                          int w0, int t_len, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * kNC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const float p = pair_p<kMasked>(s[j][e], lse_r[h], k0 + 8 * j + 2 * t + (e & 1),
                                      w0 + g + 8 * h, t_len, scale);
      dp[j][e] = pair_ds(p, dp[j][e], delta_r[h]);
    }
}

// The dk/dv role's p^T and ds^T in place of its block's s^T and dp^T: the warp's keys
// w0 + g (+ 8) against the stage's query rows c0 + 8 j + 2 t (+ 1), q0 in the head.
template <bool kMasked>
__device__ __forceinline__ void dkv_scores(float s[2 * kNC][4], float dp[2 * kNC][4],
                                           const float* lse_s, const float* delta_s, int c0,
                                           int q0, int w0, int t_len, float scale, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2 * kNC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 8 * j + 2 * t + (e & 1);
      const float p = pair_p<kMasked>(s[j][e], lse_s[col], w0 + g + 8 * (e >> 1), q0 + col,
                                      t_len, scale);
      dp[j][e] = pair_ds(p, dp[j][e], delta_s[col]);
      s[j][e] = p;
    }
}

// p's bf16 pair in dv's A fragment: to nearest even, as the reference's cast to do's type
__device__ __forceinline__ uint32_t pack_p(float lo, float hi) {
  return pack_bf16x2(lo, hi);
}

// The warp's 16 rows of the two own tiles (from row `ar`) as mma A fragments: read from
// shared memory at each use or, kHeld, once into registers after the tiles have landed.
template <int D, bool kHeld>
struct OwnFrags {
  uint32_t r[kHeld ? D / 8 : 1][4];  // kHeld: [2 kk] of tile 1, [2 kk + 1] of tile 2
  const bf16* a1;
  const bf16* a2;
  int arow, half;
  __device__ __forceinline__ void init(const bf16* own1, const bf16* own2, int ar, int lane) {
    a1 = own1;
    a2 = own2;
    arow = ar + (lane & 15);
    half = lane >> 4;
    if constexpr (kHeld) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldsm_x4(r[2 * kk], a1 + swz<D>(arow, 2 * kk + half));
        ldsm_x4(r[2 * kk + 1], a2 + swz<D>(arow, 2 * kk + half));
      }
    }
  }
  __device__ __forceinline__ void get(int kk, uint32_t f1[4], uint32_t f2[4]) const {
    if constexpr (kHeld) {
#pragma unroll
      for (int i = 0; i < 4; ++i) f1[i] = r[2 * kk][i], f2[i] = r[2 * kk + 1][i];
    } else {
      ldsm_x4(f1, a1 + swz<D>(arow, 2 * kk + half));
      ldsm_x4(f2, a2 + swz<D>(arow, 2 * kk + half));
    }
  }
};

// c1 = A1 B1^T and c2 = A2 B2^T over D, interleaved: A the warp's own rows, B 16 kNC rows
// of the two tiles of a stage from row `br`. mma C fragments: c[j][e] is A's row g + 8 (e >> 1)
// against B's row 8 j + 2 t + (e & 1).
template <int D, bool kHeld>
__device__ __forceinline__ void dots(float c1[2 * kNC][4], float c2[2 * kNC][4],
                                     const OwnFrags<D, kHeld>& own, const bf16* b1,
                                     const bf16* b2, int br, int lane) {
#pragma unroll
  for (int j = 0; j < 2 * kNC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c1[j][e] = c2[j][e] = 0.f;
  const int brow = br + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t f1[4], f2[4];
    own.get(kk, f1, f2);
    const int bc = 2 * kk + ((lane >> 3) & 1);
#pragma unroll
    for (int jp = 0; jp < kNC; ++jp) {
      uint32_t g1[4], g2[4];
      ldsm_x4(g1, b1 + swz<D>(brow + 16 * jp, bc));
      ldsm_x4(g2, b2 + swz<D>(brow + 16 * jp, bc));
      mma_bf16(c1[2 * jp], f1, g1[0], g1[1]);
      mma_bf16(c1[2 * jp + 1], f1, g1[2], g1[3]);
      mma_bf16(c2[2 * jp], f2, g2[0], g2[1]);
      mma_bf16(c2[2 * jp + 1], f2, g2[2], g2[3]);
    }
  }
}

// The bf16 A fragments of a 16 x 16 kNC block from its C fragments c (as dots gives them):
// a[kk] holds columns 16 kk .. 16 kk + 15, each pair rounded to nearest even (p's by pack_p).
template <bool kIsP>
__device__ __forceinline__ void a_frags(uint32_t a[kNC][4], const float c[2 * kNC][4]) {
#pragma unroll
  for (int kk = 0; kk < kNC; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2)
        a[kk][2 * h + e2] = kIsP ? pack_p(c[2 * kk + h][2 * e2], c[2 * kk + h][2 * e2 + 1])
                                 : pack_bf16x2(c[2 * kk + h][2 * e2], c[2 * kk + h][2 * e2 + 1]);
}

// acc (the warp's 16 rows x N columns of D from 16-byte chunk `cc`) += A B: A the bf16 A
// fragments of 16 rows x 16 kNC, B those columns of 16 kNC rows of a streamed tile from row
// `br`, read with ldmatrix.trans
template <int D, int N>
__device__ __forceinline__ void acc_rows(float acc[N / 8][4], const uint32_t a[kNC][4],
                                         const bf16* b, int br, int cc, int lane) {
  const int brow = br + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int kk = 0; kk < kNC; ++kk)
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t f[4];
      ldsm_x4_trans(f, b + swz<D>(brow + 16 * kk, cc + 2 * np + (lane >> 4)));
      mma_bf16(acc[2 * np], a[kk], f[0], f[1]);
      mma_bf16(acc[2 * np + 1], a[kk], f[2], f[3]);
    }
}

// rows w0 + g and w0 + g + 8 (those before T) of acc (N columns from column c0), times
// `mul`, into a (T, D) head
template <int D, int N>
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[N / 8][4], int w0,
                                           int t_len, float mul, int c0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = w0 + g + 8 * h;
    if (row >= t_len) continue;
    bf16* out = dst + static_cast<size_t>(row) * D + c0;
#pragma unroll
    for (int n = 0; n < N / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * h] * mul, acc[n][2 * h + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 2) flash_train_bwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int t_len, float scale) {
  constexpr int kElems = kTile * D;  // of one tile
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* own_a = reinterpret_cast<bf16*>(smem_raw);  // dq role: Q;  dk/dv role: K
  bf16* own_b = own_a + kElems;                      // dq role: do; dk/dv role: V
  unsigned char* ring = reinterpret_cast<unsigned char*>(own_b + kElems);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;
  const int n_tiles = (t_len + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  // the roles alternate along y, heaviest tiles first in both: dq tiles from the last,
  // dk/dv tiles from the first
  const bool dq_role = (blockIdx.y & 1) == 0;
  const int tile = dq_role ? n_tiles - 1 - static_cast<int>(blockIdx.y >> 1)
                           : static_cast<int>(blockIdx.y >> 1);
  const int t0 = tile * kTile;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * t_len;
  const float* delta_h = delta + static_cast<size_t>(bh) * t_len;
  const int wl = 16 * warp;  // the warp's first row in the own tiles
  const int w0 = t0 + wl;    // and in the head; this thread's are w0 + g (+ 8)

  // the ring: streamed tile i in stage i % kStages, kStages - 1 tiles in flight ahead of
  // use; the own tiles go with the first group. dq role: key tiles 0 .. tile; dk/dv role:
  // query tiles tile .. n_tiles - 1, each with its rows' lse and delta.
  const int n_items = dq_role ? tile + 1 : n_tiles - tile;
  const int r_first = dq_role ? 0 : t0;
  const bf16* str_a = (dq_role ? k : q) + head;
  const bf16* str_b = (dq_role ? v : dout) + head;
  int issued = 0, used = 0;
  auto issue = [&]() {
    if (issued < n_items)
      load_stage<D, kTcThreads>(ring + (issued % kStages) * stage_bytes<D>(), str_a, str_b,
                                lse_h, delta_h, !dq_role, r_first + issued * kTile, t_len, tid);
    cp_async_commit();  // an empty group past the end keeps the count of groups
    ++issued;
  };
  auto acquire = [&]() -> const bf16* {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the stage is everyone's; the stage read last is free
    issue();
    return reinterpret_cast<const bf16*>(ring + (used++ % kStages) * stage_bytes<D>());
  };
  load_rows<D, kTcThreads>(own_a, (dq_role ? q : k) + head, t0, t_len, tid);
  load_rows<D, kTcThreads>(own_b, (dq_role ? dout : v) + head, t0, t_len, tid);
  for (int i = 0; i < kStages - 1; ++i) issue();

  if (dq_role) {
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + g + 8 * h;
      lse_r[h] = row < t_len ? lse_h[row] : 0.f;
      delta_r[h] = row < t_len ? delta_h[row] : 0.f;
    }
    float acc[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // the last key a row of the warp sees; -1 when its rows all lie at or past T
    const int last = w0 < t_len ? min(w0 + 15, t_len - 1) : -1;
    OwnFrags<D, true> own;  // Q and do held: the dq warp's accumulator leaves room
    for (int it = 0; it < n_items; ++it) {
      const bf16* ks = acquire();
      const bf16* vs = ks + kElems;
      const int kt = it * kTile;
      if (it == 0) own.init(own_a, own_b, wl, lane);  // Q and do landed with the first tile
#pragma unroll 1
      for (int c0 = 0; c0 < kTile; c0 += 16 * kNC) {
        if (kt + c0 > last) break;  // warp-uniform: these keys and the rest are masked
        float s[2 * kNC][4], dp[2 * kNC][4];
        dots<D>(s, dp, own, ks, vs, c0, lane);
        // warp-uniform: a key past the warp's first row, or a row at or past T
        if (kt + c0 + 16 * kNC - 1 > w0 || w0 + 15 >= t_len)
          dq_scores<true>(s, dp, lse_r, delta_r, kt + c0, w0, t_len, scale, lane);
        else
          dq_scores<false>(s, dp, lse_r, delta_r, kt + c0, w0, t_len, scale, lane);
        uint32_t da[kNC][4];
        a_frags<false>(da, dp);
        acc_rows<D, D>(acc, da, ks, c0, 0, lane);
      }
    }
    cp_async_wait<0>();
    store_rows<D, D>(dq + head, acc, w0, t_len, scale, 0, lane);
    return;
  }

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const bool live = w0 < t_len;  // some key of the warp lies before T
  OwnFrags<D, false> own;  // K and V read at each use: dK and dV take D registers
  for (int it = 0; it < n_items; ++it) {
    const bf16* qs = acquire();
    if (it == 0) own.init(own_a, own_b, wl, lane);  // K and V landed with the first tile
    const bf16* dos = qs + kElems;
    const float* lse_s = reinterpret_cast<const float*>(dos + kElems);
    const float* delta_s = lse_s + kTile;
    const int q0 = t0 + it * kTile;
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += 16 * kNC) {
      // warp-uniform: these queries all lie at or past T, or before the warp's first key
      if (!live || q0 + c0 >= t_len || q0 + c0 + 16 * kNC - 1 < w0) continue;
      float s[2 * kNC][4], dp[2 * kNC][4];
      dots<D>(s, dp, own, qs, dos, c0, lane);
      // warp-uniform: a query before the warp's last key, or at or past T
      if (q0 + c0 < w0 + 15 || q0 + c0 + 16 * kNC > t_len)
        dkv_scores<true>(s, dp, lse_s, delta_s, c0, q0, w0, t_len, scale, lane);
      else
        dkv_scores<false>(s, dp, lse_s, delta_s, c0, q0, w0, t_len, scale, lane);
      uint32_t pa[kNC][4], da[kNC][4];
      a_frags<true>(pa, s);
      a_frags<false>(da, dp);
      acc_rows<D, D>(acc_v, pa, dos, c0, 0, lane);
      acc_rows<D, D>(acc_k, da, qs, c0, 0, lane);
    }
  }
  cp_async_wait<0>();
  store_rows<D, D>(dk + head, acc_k, w0, t_len, scale, 0, lane);
  store_rows<D, D>(dv + head, acc_v, w0, t_len, 1.f, 0, lane);
}

// ------------------------------------------------------------------ bf16 at D = 256: warp pairs

constexpr int kPairWarps = 2 * kTcWarps;  // warps w and w + kTcWarps own the same 16 rows
constexpr int kPairThreads = 32 * kPairWarps;
constexpr int kSlotWords = kNC * 4 * 32;  // one warp's A fragments of p or ds
// shared memory: the 4-warp kernel's, then each pair's exchange slots [stage half][p, ds]
template <int D> constexpr size_t pair_smem_bytes() {
  return tc_smem_bytes<D>() + kTcWarps * 4 * kSlotWords * sizeof(uint32_t);
}

// the barrier of warp pair `pair`'s 64 threads (ids 1 .. kTcWarps; 0 is __syncthreads')
__device__ __forceinline__ void pair_sync(int pair) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(pair + 1) : "memory");
}

// a warp's A fragments to and from an exchange slot, 16 bytes a lane, lanes side by side
__device__ __forceinline__ void put_frags(uint32_t* slot, const uint32_t a[kNC][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < kNC; ++kk)
    reinterpret_cast<uint4*>(slot)[kk * 32 + lane] = make_uint4(a[kk][0], a[kk][1], a[kk][2],
                                                                a[kk][3]);
}
__device__ __forceinline__ void get_frags(uint32_t a[kNC][4], const uint32_t* slot, int lane) {
#pragma unroll
  for (int kk = 0; kk < kNC; ++kk) {
    const uint4 w = reinterpret_cast<const uint4*>(slot)[kk * 32 + lane];
    a[kk][0] = w.x, a[kk][1] = w.y, a[kk][2] = w.z, a[kk][3] = w.w;
  }
}

// The 4-warp kernel's roles, ring and products with each warp's accumulators cut to one half
// of D. Per streamed tile, warp w + kTcWarps h forms p and ds against the tile's rows
// 16 kNC h .. 16 kNC (h + 1) - 1, puts their A fragments in its pair's slots, and after the
// pair's barrier both warps add the two halves' rows, in that order, into their columns.
template <int D>
__global__ void __launch_bounds__(kPairThreads, 1) flash_train_bwd_tc_pair_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dq, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int t_len, float scale) {
  constexpr int kElems = kTile * D;  // of one tile
  constexpr int kCols = D / 2;       // a warp's columns of D
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* own_a = reinterpret_cast<bf16*>(smem_raw);  // dq role: Q;  dk/dv role: K
  bf16* own_b = own_a + kElems;                      // dq role: do; dk/dv role: V
  unsigned char* ring = reinterpret_cast<unsigned char*>(own_b + kElems);
  uint32_t* slots = reinterpret_cast<uint32_t*>(ring + kStages * stage_bytes<D>());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pair = warp % kTcWarps, half = warp / kTcWarps;
  const int g = lane >> 2;
  const int n_tiles = (t_len + kTile - 1) / kTile;
  const int bh = blockIdx.x;
  const bool dq_role = (blockIdx.y & 1) == 0;  // as in the 4-warp kernel
  const int tile = dq_role ? n_tiles - 1 - static_cast<int>(blockIdx.y >> 1)
                           : static_cast<int>(blockIdx.y >> 1);
  const int t0 = tile * kTile;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const float* lse_h = lse + static_cast<size_t>(bh) * t_len;
  const float* delta_h = delta + static_cast<size_t>(bh) * t_len;
  const int wl = 16 * pair;  // the pair's first row in the own tiles
  const int w0 = t0 + wl;    // and in the head; this thread's are w0 + g (+ 8)
  const int c0 = 16 * kNC * half;  // the streamed rows this warp forms p and ds against
  const int cc = kCols / 8 * half;  // the warp's first 16-byte chunk of D
  uint32_t* pair_slots = slots + pair * 4 * kSlotWords;
  // the pair's slot of stage half h: p (a = 0) or ds (a = 1)
  auto slot = [&](int h, int a) { return pair_slots + (2 * h + a) * kSlotWords; };

  const int n_items = dq_role ? tile + 1 : n_tiles - tile;
  const int r_first = dq_role ? 0 : t0;
  const bf16* str_a = (dq_role ? k : q) + head;
  const bf16* str_b = (dq_role ? v : dout) + head;
  int issued = 0, used = 0;
  auto issue = [&]() {
    if (issued < n_items)
      load_stage<D, kPairThreads>(ring + (issued % kStages) * stage_bytes<D>(), str_a, str_b,
                                  lse_h, delta_h, !dq_role, r_first + issued * kTile, t_len,
                                  tid);
    cp_async_commit();  // an empty group past the end keeps the count of groups
    ++issued;
  };
  auto acquire = [&]() -> const bf16* {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // the stage is everyone's; the stage and the slots read last are free
    issue();
    return reinterpret_cast<const bf16*>(ring + (used++ % kStages) * stage_bytes<D>());
  };
  load_rows<D, kPairThreads>(own_a, (dq_role ? q : k) + head, t0, t_len, tid);
  load_rows<D, kPairThreads>(own_b, (dq_role ? dout : v) + head, t0, t_len, tid);
  for (int i = 0; i < kStages - 1; ++i) issue();
  OwnFrags<D, false> own;  // read at each use: held, they would take D registers

  if (dq_role) {
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = w0 + g + 8 * h;
      lse_r[h] = row < t_len ? lse_h[row] : 0.f;
      delta_r[h] = row < t_len ? delta_h[row] : 0.f;
    }
    float acc[kCols / 8][4];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    // the last key a row of the pair sees; -1 when its rows all lie at or past T
    const int last = w0 < t_len ? min(w0 + 15, t_len - 1) : -1;
    for (int it = 0; it < n_items; ++it) {
      const bf16* ks = acquire();
      const bf16* vs = ks + kElems;
      const int kt = it * kTile;
      if (it == 0) own.init(own_a, own_b, wl, lane);  // Q and do landed with the first tile
      if (kt + c0 <= last) {  // warp-uniform: some key of this warp's rows is visible
        float s[2 * kNC][4], dp[2 * kNC][4];
        dots<D>(s, dp, own, ks, vs, c0, lane);
        if (kt + c0 + 16 * kNC - 1 > w0 || w0 + 15 >= t_len)
          dq_scores<true>(s, dp, lse_r, delta_r, kt + c0, w0, t_len, scale, lane);
        else
          dq_scores<false>(s, dp, lse_r, delta_r, kt + c0, w0, t_len, scale, lane);
        uint32_t da[kNC][4];
        a_frags<false>(da, dp);
        put_frags(slot(half, 1), da, lane);
      }
      pair_sync(pair);
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        if (kt + 16 * kNC * h > last) break;  // pair-uniform: these keys and the rest masked
        uint32_t da[kNC][4];
        get_frags(da, slot(h, 1), lane);
        acc_rows<D, kCols>(acc, da, ks, 16 * kNC * h, cc, lane);
      }
    }
    cp_async_wait<0>();
    store_rows<D, kCols>(dq + head, acc, w0, t_len, scale, 8 * cc, lane);
    return;
  }

  float acc_k[kCols / 8][4], acc_v[kCols / 8][4];
#pragma unroll
  for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  const bool live = w0 < t_len;  // some key of the pair lies before T
  for (int it = 0; it < n_items; ++it) {
    const bf16* qs = acquire();
    if (it == 0) own.init(own_a, own_b, wl, lane);  // K and V landed with the first tile
    const bf16* dos = qs + kElems;
    const float* lse_s = reinterpret_cast<const float*>(dos + kElems);
    const float* delta_s = lse_s + kTile;
    const int q0 = t0 + it * kTile;
    // pair-uniform: streamed rows c .. c + 16 kNC - 1 hold a query before T at or past the
    // pair's first key
    auto visible = [&](int c) {
      return live && q0 + c < t_len && q0 + c + 16 * kNC - 1 >= w0;
    };
    if (visible(c0)) {
      float s[2 * kNC][4], dp[2 * kNC][4];
      dots<D>(s, dp, own, qs, dos, c0, lane);
      if (q0 + c0 < w0 + 15 || q0 + c0 + 16 * kNC > t_len)
        dkv_scores<true>(s, dp, lse_s, delta_s, c0, q0, w0, t_len, scale, lane);
      else
        dkv_scores<false>(s, dp, lse_s, delta_s, c0, q0, w0, t_len, scale, lane);
      uint32_t pa[kNC][4], da[kNC][4];
      a_frags<true>(pa, s);
      a_frags<false>(da, dp);
      put_frags(slot(half, 0), pa, lane);
      put_frags(slot(half, 1), da, lane);
    }
    pair_sync(pair);
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      if (!visible(16 * kNC * h)) continue;
      uint32_t pa[kNC][4], da[kNC][4];
      get_frags(pa, slot(h, 0), lane);
      get_frags(da, slot(h, 1), lane);
      acc_rows<D, kCols>(acc_v, pa, dos, 16 * kNC * h, cc, lane);
      acc_rows<D, kCols>(acc_k, da, qs, 16 * kNC * h, cc, lane);
    }
  }
  cp_async_wait<0>();
  store_rows<D, kCols>(dk + head, acc_k, w0, t_len, scale, 8 * cc, lane);
  store_rows<D, kCols>(dv + head, acc_v, w0, t_len, 1.f, 8 * cc, lane);
}

// the tensor-core kernel of a head size: warp pairs at D = 256
template <int D> auto tc_kernel() {
  if constexpr (D == 256) return flash_train_bwd_tc_pair_kernel<D>;
  else return flash_train_bwd_tc_kernel<D>;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, void* dq, void* dk, void* dv,
                      int bh, int t_len, float scale, cudaStream_t stream) {
  // cp.async copies 16-byte chunks of the rows: the bases must be 16-byte aligned
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout);
  if (bases % 16 != 0) return cudaErrorMisalignedAddress;
  auto kernel = tc_kernel<D>();
  constexpr bool kPair = D == 256;
  constexpr int kThreads = kPair ? kPairThreads : kTcThreads;
  constexpr int kSmem = static_cast<int>(kPair ? pair_smem_bytes<D>() : tc_smem_bytes<D>());
  static bool smem_set = false;  // set once, before any CUDA-graph capture of a launch
  if (!smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid(bh, 2 * ((t_len + kTile - 1) / kTile));
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), t_len, scale);
  return cudaGetLastError();
}

// The kernel for a type and head size, chosen statically: bf16 at D = 64 and 128 on the
// 4-warp tensor-core kernel, at 256 on its warp pairs; f32 and bf16 at D = 192 on the FMA
// kernel.
template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv, int bh,
                     int t_len, int d, float scale, cudaStream_t stream);

template <>
cudaError_t launch_d<bf16>(const void* q, const void* k, const void* v, const void* dout,
                           const float* lse, const float* delta, void* dq, void* dk, void* dv,
                           int bh, int t_len, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_tc<64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale, stream);
    case 128:
      return launch_tc<128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale, stream);
    case 192:
      return launch_fma<bf16, 192>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale,
                                   stream);
    case 256:
      return launch_tc<256>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <>
cudaError_t launch_d<float>(const void* q, const void* k, const void* v, const void* dout,
                            const float* lse, const float* delta, void* dq, void* dk, void* dv,
                            int bh, int t_len, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch_fma<float, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale,
                                   stream);
    case 128:
      return launch_fma<float, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale,
                                    stream);
    case 192:
      return launch_fma<float, 192>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale,
                                    stream);
    case 256:
      return launch_fma<float, 256>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale,
                                    stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: (BH, T, D) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1);
// lse, delta: (BH, T) f32. D is 64, 128, 192 or 256; T >= 1.
int fm_flash_train_bwd(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dq, void* dk, void* dv,
                       int bf16, int bh, int t_len, int d, float scale, cudaStream_t stream) {
  if (t_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const float* l = static_cast<const float*>(lse);
  const float* de = static_cast<const float*>(delta);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(q, k, v, dout, l, de, dq, dk, dv, bh, t_len, d, scale,
                                     stream)
           : launch_d<float>(q, k, v, dout, l, de, dq, dk, dv, bh, t_len, d, scale, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
