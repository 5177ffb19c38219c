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
// so the heaviest tiles of both start first. A dq CTA owns a tile of BT query rows of one
// head and walks the key tiles at or below it; a dk/dv CTA owns a tile of BT keys and walks
// the query tiles at or above it. Each recomputes p and ds for its block pairs (the dk/dv
// role also forms dv), each sum has one order, and repeated calls give the same bits. BT is
// 64, or 32 for D >= 192, so a launch has 2 * T / BT CTAs a head (4096 at B=2, H=32, T=2048).
//
// Bound: operations, 10 D flops per visible (row, key) pair (the two score products and the
// three gradient products). This version computes seven products a pair (s and dp twice:
// once in each role) with f32 FMAs from shared memory; tensor cores and TMA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

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
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
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

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* dout,
                     const float* lse, const float* delta, void* dq, void* dk, void* dv, int bh,
                     int t_len, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale, stream);
    case 192:
      return launch<T, 192>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, dout, lse, delta, dq, dk, dv, bh, t_len, scale, stream);
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
