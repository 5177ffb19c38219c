// Shared pieces of the fastmax scan kernels (fastmax_fwd.cu, fastmax_bwd.cu).
//
// Both kernels give `nsplit` 256-thread CTAs to one (batch, head) pair, and each
// walks the pair's sequence chunk by chunk, as the TPU grid's sequential chunk axis
// does. The CTAs of a head split the degree-2 pair terms between them (split_pairs):
// each keeps its own rows of the packed state, so they never wait on each other;
// split 0 also does everything else (the intra-chunk block, the D x D state) and
// a second, elementwise kernel sums the splits' partial outputs. A chunk
// is processed in tiles of 64 rows; a 64 x 64 output tile is spread over the
// threads as rows ty + 16 i and columns tx + 16 j (ty = tid / 16, tx = tid % 16,
// i, j < 4), so the 16 threads that share a row are the 16 lanes of a half-warp.
//
// The degree-2 state is kept packed over pairs m <= j, as the reference packs it
// (ops/fastmax_pallas.py _pair_basis_sym_np): pair p = (m, j) in row-major order of
// the upper triangle, P = D (D + 1) / 2 rows of D floats. The pair features are
// formed on the fly, q_m * q_j (times w = 2 off the diagonal where the reference
// weights them), instead of by the reference's 0/1 expansion matmuls, and rounded
// to the pair-operand type exactly where the reference rounds them: the input's
// type, so float32 inputs give exact float32 pair math and bfloat16 inputs round
// the pair features, the state operand and df to bfloat16. Every sum is float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fm {

constexpr int kThreads = 256;
constexpr int kR = 64;                              // rows of a tile
constexpr int kLD = 65;                             // padded row stride of a tile
constexpr int kTile = kR * kLD;                     // floats in one tile
constexpr int kPT = 64;                             // pairs per pair tile
constexpr int kMaxD = 64;
constexpr int kMaxPairs = kMaxD * (kMaxD + 1) / 2;  // 2080 at D = 64

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round to the pair-operand type T and back: the identity for float32.
template <typename T> __device__ __forceinline__ float rnd(float v);
template <> __device__ __forceinline__ float rnd<float>(float v) { return v; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// rows [0, 64) of a (rows, d) row-major matrix -> a (64, kLD) f32 tile, zero past d
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int d) {
  for (int idx = threadIdx.x; idx < kR * kMaxD; idx += kThreads) {
    const int r = idx / kMaxD, c = idx % kMaxD;
    dst[r * kLD + c] = c < d ? to_f32(src[static_cast<size_t>(r) * d + c]) : 0.f;
  }
}

__device__ __forceinline__ void zero_tile(float* dst) {
  for (int idx = threadIdx.x; idx < kTile; idx += kThreads) dst[idx] = 0.f;
}

// pair p -> (pm[p], pj[p]), p = m d - m (m - 1) / 2 + (j - m) for m <= j
__device__ __forceinline__ void build_pairs(uint8_t* pm, uint8_t* pj, int d) {
  for (int idx = threadIdx.x; idx < d * d; idx += kThreads) {
    const int m = idx / d, j = idx % d;
    if (j >= m) {
      const int p = m * d - m * (m - 1) / 2 + (j - m);
      pm[p] = static_cast<uint8_t>(m);
      pj[p] = static_cast<uint8_t>(j);
    }
  }
}

// The pairs [lo, hi) of split `split` of `nsplit` CTAs a head, in whole 64-pair tiles.
// Split 0 also does the work outside the pair terms, so it takes two tiles fewer.
__device__ __forceinline__ void split_pairs(int npairs, int split, int nsplit, int& lo,
                                            int& hi) {
  if (nsplit == 1) {
    lo = 0;
    hi = npairs;
    return;
  }
  const int tiles = (npairs + kPT - 1) / kPT;
  const int first = max(tiles / nsplit - 2, 0);
  auto start = [&](int s) { return s == 0 ? 0 : first + (s - 1) * (tiles - first) / (nsplit - 1); };
  lo = min(start(split) * kPT, npairs);
  hi = min(start(split + 1) * kPT, npairs);
}

// at[pp * kLD + r] = rnd(w_p x[r, m_p] x[r, j_p]) for the pairs p0 .. p0 + kPT below npairs
template <typename T>
__device__ __forceinline__ void pair_features(float* at, const float* x, int p0, int npairs,
                                              bool weighted, const uint8_t* pm,
                                              const uint8_t* pj) {
  for (int idx = threadIdx.x; idx < kPT * kR; idx += kThreads) {
    const int pp = idx / kR, r = idx % kR, p = p0 + pp;
    float a = 0.f;
    if (p < npairs) {
      const int m = pm[p], j = pj[p];
      a = x[r * kLD + m] * x[r * kLD + j];
      if (weighted && m != j) a *= 2.f;
      a = rnd<T>(a);
    }
    at[pp * kLD + r] = a;
  }
}

// bt[pp * kLD + c] = rnd(s[p0 + pp, c]), s a (npairs, d) row-major state in device memory
template <typename T>
__device__ __forceinline__ void pair_rows(float* bt, const float* s, int p0, int npairs, int d) {
  for (int idx = threadIdx.x; idx < kPT * kMaxD; idx += kThreads) {
    const int pp = idx / kMaxD, c = idx % kMaxD, p = p0 + pp;
    bt[pp * kLD + c] = (p < npairs && c < d) ? rnd<T>(s[static_cast<size_t>(p) * d + c]) : 0.f;
  }
}

// acc[r, c] += sum_p rnd(w_p x[r, m_p] x[r, j_p]) rnd(s[p, c]) over the pairs [lo, hi):
// f2 = (Q2 w) @ S3 in the forward, dv += K2 @ dS3 in the backward.
// Uses the tiles at and bt; ends synchronised.
template <typename T>
__device__ void pair_out(float (&acc)[4][4], const float* x, const float* s, int d, int lo,
                         int hi, bool weighted, float* at, float* bt, const uint8_t* pm,
                         const uint8_t* pj) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int p0 = lo; p0 < hi; p0 += kPT) {
    __syncthreads();
    pair_features<T>(at, x, p0, hi, weighted, pm, pj);
    pair_rows<T>(bt, s, p0, hi, d);
    __syncthreads();
    const int np = min(kPT, hi - p0);
    for (int pp = 0; pp < np; ++pp) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = at[pp * kLD + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bt[pp * kLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  __syncthreads();
}

// s[p, c] += alpha * sum_r rnd(w_p x[r, m_p] x[r, j_p]) rnd(y[r, c]), p in [lo, hi), over the 64 rows
// of the tiles x and y: S3 += K2^T v (forward), S3 -= K2^T v (the reverse walk's
// rewind), dS3 += (Q2 w)^T df / (2 z^2) (backward). Uses the tile at; ends synchronised.
template <typename T>
__device__ void pair_update(float* s, const float* x, const float* y, int d, int lo, int hi,
                            bool weighted, float alpha, float* at, const uint8_t* pm,
                            const uint8_t* pj) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int p0 = lo; p0 < hi; p0 += kPT) {
    __syncthreads();
    pair_features<T>(at, x, p0, hi, weighted, pm, pj);
    __syncthreads();
    float acc[4][4] = {};
    for (int r = 0; r < kR; ++r) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = at[(ty + 16 * i) * kLD + r];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = rnd<T>(y[r * kLD + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty + 16 * i;
      if (p >= hi) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (c < d) s[static_cast<size_t>(p) * d + c] += alpha * acc[i][j];
      }
    }
  }
  __syncthreads();
}

// The pair-basis fold-back: t[r, p] = w_p sum_c rnd(y[r, c]) rnd(s[p, c]), then
// out[r, m_p] += rnd(t x[r, j_p]) and out[r, j_p] += rnd(t x[r, m_p]) (both land on m
// for a diagonal pair), the reference's (dq2 * qb) @ E^T + (dq2 * qa) @ F^T with
// dq2 = (df @ S3^T) w, and its dk2 twin over v and dS3, over the pairs [lo, hi). out is a
// shared tile; thread (r, g) owns its row r's columns c = g (mod 4) and adds the pairs in
// their order, so every sum has a fixed order and the result repeats bit for bit. Uses
// the tiles bt and t2; ends synchronised.
template <typename T>
__device__ void pair_fold(float* out, const float* x, const float* y, const float* s, int d,
                          int lo, int hi, bool weighted, float* bt, float* t2, const uint8_t* pm,
                          const uint8_t* pj) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int p0 = lo; p0 < hi; p0 += kPT) {
    __syncthreads();
    pair_rows<T>(bt, s, p0, hi, d);
    __syncthreads();
    float acc[4][4] = {};
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = rnd<T>(y[(ty + 16 * i) * kLD + c]);
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bt[(tx + 16 * j) * kLD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = p0 + tx + 16 * j;
      const float w = (weighted && p < hi && pm[p] != pj[p]) ? 2.f : 1.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) t2[(ty + 16 * i) * kLD + tx + 16 * j] = acc[i][j] * w;
    }
    __syncthreads();
    // a warp is 32 rows of one column class: the branches below are uniform over it
    const int np = min(kPT, hi - p0);
    const int r = threadIdx.x % kR, own = threadIdx.x / kR;
    static_assert(kThreads / kR == 4, "four column classes");
    for (int pp = 0; pp < np; ++pp) {
      const int p = p0 + pp, m = pm[p], j = pj[p];
      const float t = t2[r * kLD + pp];
      if ((m & 3) == own) out[r * kLD + m] += rnd<T>(t * x[r * kLD + j]);
      if ((j & 3) == own) out[r * kLD + j] += rnd<T>(t * x[r * kLD + m]);
    }
  }
  __syncthreads();
}

// sum over the 16 lanes of a half-warp (the threads that share a row)
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace fm
