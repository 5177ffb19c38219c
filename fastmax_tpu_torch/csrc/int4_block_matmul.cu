// Blockwise tiled int4 matmul for Hopper (sm_90a):
//   y[m, n] = sum_k x[m, k] * (q[k, n] * (s[k / 64, n] * 0.125))
// or, without scales, the raw signed nibbles: y[m, n] = sum_k x[m, k] * q[k, n];
// accumulated in f32 and written in f32 or bf16.
//
// Replaces the Pallas TPU kernel int4_matmul_tiled (fastmax_tpu/ops/quant_pallas.py),
// which serves the blockwise int4 format ("preload_int4_block") with its scales
// and the tools/ experiments without them. As the reference, each weight is
// scaled before the product (the scale is not applied to a partial sum).
//
// Layout: the tiled words of K1 (int4_tiled.cuh) and scales s_t (gk, gn,
// tk/64, 1024), column = tile*1024 + plane*128 + lane. Rows >= k (true k) are
// skipped: the reference zero-pads x there. Columns >= n are not written.
//
// Bound: at decode (m <= 4) 0.5 byte per weight plus 1/16 byte of scale, so
// device-memory bytes; the design is K1's: a GEMV that keeps 16-byte loads in
// flight (4-deep unroll) and splits k over enough blocks to cover all SMs; the
// scales are read per 64-row block through L1 (the 32 row threads of a block
// share them). Above m = 4, 64-row tiles decode each weight once into shared
// memory and reuse it for 64 rows: bound by f32 FMA issue. Split-k partial
// sums go to a scratch buffer and a second pass adds them in a fixed order.

#include "int4_tiled.cuh"

namespace {

using namespace int4t;

constexpr int kBlock = 64;  // rows of one scale block

// The scale row of weight row krow in column tile gni: (gk_i, gni, b, :).
__device__ __forceinline__ const float* scale_row(const float* s, int krow, int gni, int gk,
                                                  int gn, int tk) {
  const int gki = gk == 1 ? 0 : krow / tk;
  const int b = (krow - gki * tk) / kBlock;
  return s + (static_cast<size_t>(gki * gn + gni) * (tk / kBlock) + b) * kTileN;
}

// ---------------------------------------------------------------- m <= 4
// Block: 256 threads = 8 column threads (4 lanes each, one 16-byte load)
// x 32 row threads, covering 32 lanes (256 columns) of one tile and rows
// [k0, k1) of one k split, as K1.
constexpr int kGvThreads = 256;
constexpr int kGvRows = 32;
constexpr int kGvUnroll = 4;
constexpr int kGvStrips = kLanes / 32;

template <int MR, bool SCALED, typename TX>
__global__ void __launch_bounds__(kGvThreads) int4_block_gemv_kernel(
    const TX* __restrict__ x, int m, int k, const int32_t* __restrict__ w,
    const float* __restrict__ s, int gk, int gn, int tk, int rows_per_split,
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
    for (int u = 0; u < kGvUnroll; ++u) {
      const int krow = kb + u * kGvRows;
      if (krow < k1) {
        wv[u] = __ldg(reinterpret_cast<const uint4*>(word_ptr(w, krow, gni, gk, gn, tk) +
                                                     lane0 + tx * 4));
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xv[u][i] = i < m ? to_f32(x[static_cast<size_t>(i) * k + krow]) : 0.f;
      } else {
        wv[u] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < MR; ++i) xv[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int krow = min(kb + u * kGvRows, k1 - 1);  // a row past k1 adds x = 0
      const float* srow = SCALED ? scale_row(s, krow, gni, gk, gn, tk) + lane0 + tx * 4
                                 : nullptr;
      const uint32_t words[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
      float q[4][8];
#pragma unroll
      for (int c = 0; c < 4; ++c) nibbles8(words[c], q[c]);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float sc[4] = {1.f, 1.f, 1.f, 1.f};
        if (SCALED) {
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(srow + p * kLanes));
          sc[0] = s4.x * 0.125f;
          sc[1] = s4.y * 0.125f;
          sc[2] = s4.z * 0.125f;
          sc[3] = s4.w * 0.125f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wq = SCALED ? q[c][p] * sc[c] : q[c][p];
#pragma unroll
          for (int i = 0; i < MR; ++i) acc[i][p][c] = fmaf(xv[u][i], wq, acc[i][p][c]);
        }
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
  const int p = tid / 32, l = tid % 32;
  const int col = gni * kTileN + p * kLanes + lane0 + l;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i < m) {
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < kGvThreads / 32; ++wi) sum += red[wi][i][p][l];
      part[(static_cast<size_t>(split) * m + i) * n_pad + col] = sum;
    }
  }
}

// ---------------------------------------------------------------- m > 4
// Block tile: 64 rows x 128 columns (16 lanes x 8 planes) x 32 k per step, as
// K1; the 32 rows of a step lie in one scale block.
constexpr int kGmThreads = 256;
constexpr int kGmM = 64;
constexpr int kGmLanes = 16;
constexpr int kGmN = kGmLanes * 8;
constexpr int kGmK = 32;

template <bool SCALED, typename TX>
__global__ void __launch_bounds__(kGmThreads) int4_block_gemm_kernel(
    const TX* __restrict__ x, int m, int k, const int32_t* __restrict__ w,
    const float* __restrict__ s, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
  __shared__ float xs[kGmK][kGmM + 1];
  __shared__ float ws[kGmK][kGmN + 16];
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
#pragma unroll
      for (int u = 0; u < kGmM / (kGmThreads / kGmK); ++u) {
        const int row = tid / kGmK + u * (kGmThreads / kGmK);
        const int gm = m0 + row;
        xs[kk][row] = (gm < m && kr < k1) ? to_f32(x[static_cast<size_t>(gm) * k + kr]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGmK / (kGmThreads / kGmLanes); ++u) {  // weight tile
      const int kk = tid / kGmLanes + u * (kGmThreads / kGmLanes);
      const int kr = kt + kk;
      uint32_t word = 0u;
      if (kr < k1) word = __ldg(word_ptr(w, kr, gni, gk, gn, tk) + lane0 + tx);
      float q[8];
      nibbles8(word, q);
      const float* srow = SCALED ? scale_row(s, min(kr, k1 - 1), gni, gk, gn, tk) + lane0 + tx
                                 : nullptr;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        ws[kk][p * kGmLanes + tx] = SCALED ? q[p] * (__ldg(srow + p * kLanes) * 0.125f) : q[p];
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

// Adds the split partials in split order.
template <typename TY>
__global__ void int4_block_reduce_kernel(const float* __restrict__ part, int splits, int m,
                                         int n_pad, int n, TY* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m) * n) return;
  const int row = static_cast<int>(idx / n);
  const int col = static_cast<int>(idx % n);
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[(static_cast<size_t>(sp) * m + row) * n_pad + col];
  y[idx] = from_f32<TY>(sum);
}

template <bool SCALED, typename TX>
cudaError_t launch_partials(const TX* x, int m, int k, const int32_t* w, const float* s, int gk,
                            int gn, int tk, float* part, int splits, int rows_per_split,
                            cudaStream_t stream) {
  const int n_pad = gn * kTileN;
  if (m <= 4) {
    const dim3 grid(gn * kGvStrips, splits);
    auto kernel = m == 1   ? int4_block_gemv_kernel<1, SCALED, TX>
                  : m == 2 ? int4_block_gemv_kernel<2, SCALED, TX>
                           : int4_block_gemv_kernel<4, SCALED, TX>;
    kernel<<<grid, kGvThreads, 0, stream>>>(x, m, k, w, s, gk, gn, tk, rows_per_split, part,
                                            n_pad);
  } else {
    const dim3 grid((m + kGmM - 1) / kGmM, gn * (kLanes / kGmLanes), splits);
    int4_block_gemm_kernel<SCALED, TX><<<grid, kGmThreads, 0, stream>>>(
        x, m, k, w, s, gk, gn, tk, rows_per_split, part, n_pad);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const void* x, int m, int k, const int32_t* w, const float* s, int gk, int gn,
                   int tk, int n, void* y, int y_bf16, float* part, int splits,
                   int rows_per_split, cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  cudaError_t err =
      s != nullptr
          ? launch_partials<true>(xt, m, k, w, s, gk, gn, tk, part, splits, rows_per_split, stream)
          : launch_partials<false>(xt, m, k, w, s, gk, gn, tk, part, splits, rows_per_split,
                                   stream);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(m) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  if (y_bf16)
    int4_block_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        part, splits, m, gn * kTileN, n, static_cast<__nv_bfloat16*>(y));
  else
    int4_block_reduce_kernel<float><<<blocks, threads, 0, stream>>>(
        part, splits, m, gn * kTileN, n, static_cast<float*>(y));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, k) row-major, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: (gk, gn, tk,
// 128) int32 words; s: (gk, gn, tk/64, 1024) f32 scales, or null for the raw
// nibbles; y: (m, n) f32 (y_bf16 = 0) or bf16 (y_bf16 = 1), n <= gn*1024;
// part: (splits, m, gn*1024) f32 scratch. Returns the cudaError_t of the launches.
int fm_int4_block_matmul(const void* x, int x_bf16, int m, int k, const int32_t* w,
                         const float* s, int gk, int gn, int tk, int n, void* y, int y_bf16,
                         float* part, int splits, int rows_per_split, cudaStream_t stream) {
  if (x_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(x, m, k, w, s, gk, gn, tk, n, y, y_bf16, part,
                                                  splits, rows_per_split, stream));
  return static_cast<int>(launch<float>(x, m, k, w, s, gk, gn, tk, n, y, y_bf16, part, splits,
                                        rows_per_split, stream));
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
