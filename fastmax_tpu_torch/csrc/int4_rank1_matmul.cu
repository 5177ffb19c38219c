// Rank-1 tiled int4 matmul for Hopper (sm_90a):
//   y[m, n] = (sum_k x[m, k] * u[k] * q[k, n]) * v[n] / 8
// accumulated in f32 and returned in x's dtype (f32 or bf16).
//
// Replaces the Pallas TPU kernels int4_matmul_rank1_tiled_stacked and
// int4_matmul_rank1_tiled (fastmax_tpu/ops/quant_pallas.py). One kernel
// serves both: the caller passes a pointer to one layer of the (L, gk, gn,
// tk, 128) stack, so the stacked entry needs no slice copy and the
// per-layer entry is the same call with layer stride 0.
//
// Weight layout (pack_int4_tiled): the int32 word at (gk_i, gn_i, r, lane)
// holds in nibble p the signed code of row gk_i*tk + r and column
// gn_i*1024 + p*128 + lane. Rows >= k (true k) are skipped: the reference
// zero-pads x and u there, so they add nothing. Columns >= n are not written.
//
// Bound: at decode (m <= 4) the kernel streams 0.5 byte per weight and is
// bound by device-memory bytes; its design keeps many 16-byte loads in
// flight (4-deep unroll) and splits k over enough blocks to cover all SMs
// (the TPU grid of one program per 1024 columns would give 4-22 blocks at
// Llama-2-7B widths). At prefill (m > 4) it is bound by f32 FMA issue: each
// k tile is decoded once into shared memory and reused by 64 rows.
// Split-k partial sums go to a scratch buffer and a second pass adds them in
// a fixed order (no float atomics), so results are the same on every run.

#include "int4_tiled.cuh"

namespace {

using namespace int4t;

// ---------------------------------------------------------------- m <= 4
// Block: 256 threads = 8 column threads (4 lanes each, one 16-byte load)
// x 32 row threads. It covers 32 lanes (256 output columns: 8 planes x 32
// lanes) of one 1024-column tile and rows [k0, k1) of one k split.
constexpr int kGvThreads = 256;
constexpr int kGvRows = 32;
constexpr int kGvUnroll = 4;
constexpr int kGvStrips = kLanes / 32;  // 32-lane strips per tile

template <int MR, typename TX>
__global__ void __launch_bounds__(kGvThreads) int4_gemv_kernel(
    const TX* __restrict__ x, int m, int k, const float* __restrict__ u,
    const int32_t* __restrict__ w, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
  __shared__ float red[kGvThreads / 32][MR][8][32];
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int warp = tid / 32, lane = tid % 32;
  const int gni = blockIdx.x / kGvStrips;
  const int lane0 = (blockIdx.x % kGvStrips) * 32;
  const int split = blockIdx.y;
  const int k0 = split * rows_per_split;
  const int k1 = min(k0 + rows_per_split, k);

  float acc[MR][8][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][p][c] = 0.f;

  for (int kb = k0 + ty; kb < k1; kb += kGvRows * kGvUnroll) {
    uint4 wv[kGvUnroll];
    float xv[kGvUnroll][MR];
#pragma unroll
    for (int s = 0; s < kGvUnroll; ++s) {
      const int krow = kb + s * kGvRows;
      if (krow < k1) {
        wv[s] = __ldg(reinterpret_cast<const uint4*>(word_ptr(w, krow, gni, gk, gn, tk) +
                                                     lane0 + tx * 4));
        const float uu = __ldg(u + krow);
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xv[s][i] = i < m ? to_f32(x[static_cast<size_t>(i) * k + krow]) * uu : 0.f;
      } else {
        wv[s] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < MR; ++i) xv[s][i] = 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < kGvUnroll; ++s) {
      const uint32_t words[4] = {wv[s].x, wv[s].y, wv[s].z, wv[s].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float q[8];
        nibbles8(words[c], q);
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int i = 0; i < MR; ++i) acc[i][p][c] = fmaf(xv[s][i], q[p], acc[i][p][c]);
      }
    }
  }

  // the 4 row threads of a warp hold the same columns: lanes 8 and 16 apart
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[i][p][c];
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        acc[i][p][c] = a;
      }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) red[warp][i][p][tx * 4 + c] = acc[i][p][c];
  }
  __syncthreads();
  // thread -> (plane p, lane l): 32 neighbouring threads write 32 neighbouring columns
  const int p = tid / 32, l = tid % 32;
  const int col = gni * kTileN + p * kLanes + lane0 + l;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i < m) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kGvThreads / 32; ++wi) s += red[wi][i][p][l];
      part[(static_cast<size_t>(split) * m + i) * n_pad + col] = s;
    }
  }
}

// ---------------------------------------------------------------- m > 4
// Block tile: 64 rows x 128 columns (16 lanes x 8 planes) x 32 k per step.
// Thread (ty, tx) owns rows ty*4..ty*4+3 and the 8 planes of lane tx.
constexpr int kGmThreads = 256;
constexpr int kGmM = 64;
constexpr int kGmLanes = 16;
constexpr int kGmN = kGmLanes * 8;
constexpr int kGmK = 32;

template <typename TX>
__global__ void __launch_bounds__(kGmThreads) int4_gemm_kernel(
    const TX* __restrict__ x, int m, int k, const float* __restrict__ u,
    const int32_t* __restrict__ w, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
  __shared__ float xs[kGmK][kGmM + 1];      // x*u, k-major; +1 avoids bank conflicts
  __shared__ float ws[kGmK][kGmN + 16];     // decoded codes, column = p*16 + lane
  const int tid = threadIdx.x;
  const int ty = tid / kGmLanes, tx = tid % kGmLanes;
  const int m0 = blockIdx.x * kGmM;
  const int gni = blockIdx.y / (kLanes / kGmLanes);
  const int lane0 = (blockIdx.y % (kLanes / kGmLanes)) * kGmLanes;
  const int split = blockIdx.z;
  const int k0 = split * rows_per_split;
  const int k1 = min(k0 + rows_per_split, k);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = k0; kt < k1; kt += kGmK) {
    {  // x tile: 32 neighbouring threads read 32 neighbouring k of one row
      const int kk = tid % kGmK;
      const int kr = kt + kk;
      const float uu = kr < k1 ? __ldg(u + kr) : 0.f;
#pragma unroll
      for (int s = 0; s < kGmM / (kGmThreads / kGmK); ++s) {
        const int row = tid / kGmK + s * (kGmThreads / kGmK);
        const int gm = m0 + row;
        float val = 0.f;
        if (gm < m && kr < k1) val = to_f32(x[static_cast<size_t>(gm) * k + kr]) * uu;
        xs[kk][row] = val;
      }
    }
#pragma unroll
    for (int s = 0; s < kGmK / (kGmThreads / kGmLanes); ++s) {  // weight tile
      const int kk = tid / kGmLanes + s * (kGmThreads / kGmLanes);
      const int kr = kt + kk;
      uint32_t word = 0u;
      if (kr < k1) word = __ldg(word_ptr(w, kr, gni, gk, gn, tk) + lane0 + tx);
      float q[8];
      nibbles8(word, q);
#pragma unroll
      for (int p = 0; p < 8; ++p) ws[kk][p * kGmLanes + tx] = q[p];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kGmK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk][j * kGmLanes + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row < m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = gni * kTileN + j * kLanes + lane0 + tx;
        part[(static_cast<size_t>(split) * m + row) * n_pad + col] = acc[i][j];
      }
    }
  }
}

// Adds the split partials in split order and applies the column scale v/8.
template <typename TY>
__global__ void int4_splitk_reduce_kernel(const float* __restrict__ part, int splits, int m,
                                          int n_pad, const float* __restrict__ v, int n,
                                          TY* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m) * n) return;
  const int row = static_cast<int>(idx / n);
  const int col = static_cast<int>(idx % n);
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(static_cast<size_t>(sp) * m + row) * n_pad + col];
  y[idx] = from_f32<TY>(s * (v[col] * 0.125f));
}

template <typename T>
cudaError_t launch(const void* x, int m, int k, const float* u, const int32_t* w, int gk,
                   int gn, int tk, const float* v, int n, void* y, float* part, int splits,
                   int rows_per_split, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int n_pad = gn * kTileN;
  if (m <= 4) {
    const dim3 grid(gn * kGvStrips, splits);
    auto kernel = m == 1 ? int4_gemv_kernel<1, T> : m == 2 ? int4_gemv_kernel<2, T>
                                                           : int4_gemv_kernel<4, T>;
    kernel<<<grid, kGvThreads, 0, stream>>>(xt, m, k, u, w, gk, gn, tk, rows_per_split, part,
                                            n_pad);
  } else {
    const dim3 grid((m + kGmM - 1) / kGmM, gn * (kLanes / kGmLanes), splits);
    int4_gemm_kernel<T><<<grid, kGmThreads, 0, stream>>>(xt, m, k, u, w, gk, gn, tk,
                                                         rows_per_split, part, n_pad);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(m) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  int4_splitk_reduce_kernel<T><<<blocks, threads, 0, stream>>>(part, splits, m, n_pad, v, n,
                                                               static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, k) row-major, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); u: (k,) f32;
// w: one layer's (gk, gn, tk, 128) int32 words; v: (n,) f32;
// y: (m, n) in x's dtype; part: (splits, m, gn*1024) f32 scratch.
// Returns the cudaError_t of the launches.
int fm_int4_rank1_matmul(const void* x, int x_bf16, int m, int k, const float* u,
                         const int32_t* w, int gk, int gn, int tk, const float* v, int n,
                         void* y, float* part, int splits, int rows_per_split,
                         cudaStream_t stream) {
  if (x_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(x, m, k, u, w, gk, gn, tk, v, n, y, part,
                                                  splits, rows_per_split, stream));
  return static_cast<int>(
      launch<float>(x, m, k, u, w, gk, gn, tk, v, n, y, part, splits, rows_per_split, stream));
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
