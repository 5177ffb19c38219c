// Exact 4-bit codebook matmul for Hopper (sm_90a):
//   y[m, n] = sum_b absmax[b, n] * sum_{r < 64} x[m, 64 b + r] * code[q[64 b + r, n]]
// with codes packed two to a byte along k (byte r of a column: the high nibble
// is row 2r, the low nibble row 2r + 1), a 16-entry f32 code table (NF4, FP4 or
// the uniform int4 levels), x in f32 or bf16, accumulated in f32 and written in
// f32 or bf16.
//
// Replaces the Pallas TPU kernel nf4_matmul (fastmax_tpu/ops/quant_pallas.py).
// As the reference, each 64-row quant block's partial sum of unscaled code
// values is multiplied by its absmax and then added to the accumulator.
//
// Bound: at decode (m <= 8) the kernel reads 0.5 byte of codes and 1/16 byte of
// absmax per weight, so device-memory bytes, with one shared-memory lookup per
// weight close behind (the 16-entry table lies in 16 banks, so any pattern of
// indices is conflict-free). Its GEMV gives each thread 4 columns (one 4-byte load
// a packed row, neighbouring threads on neighbouring bytes), keeps 8 loads in
// flight, and splits k over enough blocks to cover all SMs. Above m = 8 it is
// bound by f32 FMA issue: 64-row tiles decode each 32-row half of a quant block
// once into shared memory and reuse it for 64 rows. With more than one split,
// partial sums go to a scratch buffer and a second pass adds them in a fixed
// order (no float atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQB = 64;         // rows of one quant block
constexpr int kQBBytes = kQB / 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store(float* y, size_t i, float v) { y[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* y, size_t i, float v) {
  y[i] = __float2bfloat16(v);
}

// The two code values of one packed byte: even row (high nibble), odd row (low).
__device__ __forceinline__ void decode_byte(const float* code, uint32_t b, float& e, float& o) {
  e = code[(b >> 4) & 0xFu]; o = code[b & 0xFu];
}

// absmax row of quant block b.
__device__ __forceinline__ const float* absmax_row(const float* absmax, int b, int nb, int n) {
  return absmax + static_cast<size_t>(b) * n;
}

// ---------------------------------------------------------------- m <= 8
// Block: 256 threads = 64 column threads (4 columns each) x 4 row threads.
// It covers 256 columns and the quant blocks [b0, b1) of one k split; row
// thread ty takes blocks b0 + ty, b0 + ty + 4, ...
constexpr int kGvThreads = 256;
constexpr int kGvColT = 64;
constexpr int kGvRowT = kGvThreads / kGvColT;
constexpr int kGvN = kGvColT * 4;
constexpr int kGvUnroll = 8;  // packed rows loaded before they are used

template <int MR, typename TX, typename TY>
__global__ void __launch_bounds__(kGvThreads) nf4_gemv_kernel(
    const TX* __restrict__ x, int m, int k, const uint8_t* __restrict__ packed,
    const float* __restrict__ absmax, const float* __restrict__ code, int n,
    int blocks_per_split, float* __restrict__ part, TY* __restrict__ y) {
  __shared__ float code_s[16];
  __shared__ float red[kGvRowT][MR][kGvN];
  const int tid = threadIdx.x;
  const int tx = tid % kGvColT, ty = tid / kGvColT;
  const int col0 = blockIdx.x * kGvN + tx * 4;
  const int split = blockIdx.y;
  const int nb = k / kQB;
  const int b0 = split * blocks_per_split;
  const int b1 = min(b0 + blocks_per_split, nb);
  if (tid < 16) code_s[tid] = code[tid];
  __syncthreads();

  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  if (col0 < n) {
    for (int b = b0 + ty; b < b1; b += kGvRowT) {
      const uint8_t* prow = packed + static_cast<size_t>(b) * kQBBytes * n + col0;
      const TX* xb = x + static_cast<size_t>(b) * kQB;
      float bacc[MR][4];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) bacc[i][c] = 0.f;
      for (int r0 = 0; r0 < kQBBytes; r0 += kGvUnroll) {
        uint32_t wv[kGvUnroll];
#pragma unroll
        for (int u = 0; u < kGvUnroll; ++u)
          wv[u] = __ldg(reinterpret_cast<const uint32_t*>(prow + static_cast<size_t>(r0 + u) * n));
#pragma unroll
        for (int u = 0; u < kGvUnroll; ++u) {
          const int r = r0 + u;
          float xe[MR], xo[MR];
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            xe[i] = i < m ? to_f32(xb[static_cast<size_t>(i) * k + 2 * r]) : 0.f;
            xo[i] = i < m ? to_f32(xb[static_cast<size_t>(i) * k + 2 * r + 1]) : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float we, wo;
            decode_byte(code_s, wv[u] >> (8 * c), we, wo);
#pragma unroll
            for (int i = 0; i < MR; ++i)
              bacc[i][c] = fmaf(xo[i], wo, fmaf(xe[i], we, bacc[i][c]));
          }
        }
      }
      const float4 am = __ldg(reinterpret_cast<const float4*>(absmax_row(absmax, b, nb, n) + col0));
      const float a4[4] = {am.x, am.y, am.z, am.w};
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += bacc[i][c] * a4[c];
    }
  }
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][i][tx * 4 + c] = acc[i][c];
  __syncthreads();
  // thread -> one column; the row threads' sums are added in order
  const int col = blockIdx.x * kGvN + tid;
  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i < m) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < kGvRowT; ++t) s += red[t][i][tid];
      if (gridDim.y == 1)
        store(y, static_cast<size_t>(i) * n + col, s);
      else
        part[(static_cast<size_t>(split) * m + i) * n + col] = s;
    }
  }
}

// ---------------------------------------------------------------- m > 8
// Block tile: 64 rows x 128 columns, 32 k rows (half a quant block) a step.
// Thread (ty, tx) owns rows ty*4..ty*4+3 and columns tx + 16 j, j < 8.
constexpr int kGmThreads = 256;
constexpr int kGmM = 64;
constexpr int kGmN = 128;
constexpr int kGmK = 32;

template <typename TX, typename TY>
__global__ void __launch_bounds__(kGmThreads) nf4_gemm_kernel(
    const TX* __restrict__ x, int m, int k, const uint8_t* __restrict__ packed,
    const float* __restrict__ absmax, const float* __restrict__ code, int n,
    int blocks_per_split, float* __restrict__ part, TY* __restrict__ y) {
  __shared__ float code_s[16];
  __shared__ float xs[kGmK][kGmM + 1];   // x, k-major; +1 avoids bank conflicts
  __shared__ float ws[kGmK][kGmN + 4];   // decoded codes
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kGmM;
  const int n0 = blockIdx.y * kGmN;
  const int split = blockIdx.z;
  const int nb = k / kQB;
  const int b0 = split * blocks_per_split;
  const int b1 = min(b0 + blocks_per_split, nb);
  if (tid < 16) code_s[tid] = code[tid];

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int b = b0; b < b1; ++b) {
    float bacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) bacc[i][j] = 0.f;
    for (int h = 0; h < kQB; h += kGmK) {
      const int kt = b * kQB + h;
      __syncthreads();  // the previous step's tiles are read; code_s is written
      {  // x tile: 32 neighbouring threads read 32 neighbouring k of one row
        const int kk = tid % kGmK;
#pragma unroll
        for (int u = 0; u < kGmM / (kGmThreads / kGmK); ++u) {
          const int row = tid / kGmK + u * (kGmThreads / kGmK);
          const int gm = m0 + row;
          xs[kk][row] = gm < m ? to_f32(x[static_cast<size_t>(gm) * k + kt + kk]) : 0.f;
        }
      }
      {  // weight tile: 16 packed rows x 128 columns, 8 bytes a thread
        const int pr = tid / 16;
        const int cg = (tid % 16) * 8;
        uint2 wv = make_uint2(0u, 0u);
        if (n0 + cg < n)
          wv = __ldg(reinterpret_cast<const uint2*>(
              packed + static_cast<size_t>(kt / 2 + pr) * n + n0 + cg));
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          float e, o;
          decode_byte(code_s, (c < 4 ? wv.x : wv.y) >> (8 * (c % 4)), e, o);
          ws[2 * pr][cg + c] = e;
          ws[2 * pr + 1][cg + c] = o;
        }
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kGmK; ++kk) {
        float a[4], bw[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) bw[j] = ws[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) bacc[i][j] = fmaf(a[i], bw[j], bacc[i][j]);
      }
    }
    const float* am = absmax_row(absmax, b, nb, n);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      const float a = col < n ? __ldg(am + col) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] += bacc[i][j] * a;
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      if (gridDim.z == 1)
        store(y, static_cast<size_t>(row) * n + col, acc[i][j]);
      else
        part[(static_cast<size_t>(split) * m + row) * n + col] = acc[i][j];
    }
  }
}

// Adds the split partials in split order.
template <typename TY>
__global__ void nf4_splitk_reduce_kernel(const float* __restrict__ part, int splits, int m, int n,
                                         TY* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m) * n) return;
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[static_cast<size_t>(sp) * m * n + idx];
  store(y, idx, s);
}

template <typename TX, typename TY>
cudaError_t launch(const void* xv, int m, int k, const uint8_t* packed, const float* absmax,
                   const float* code, int n, void* yv, float* part, int splits,
                   int blocks_per_split, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xv);
  TY* y = static_cast<TY*>(yv);
  if (m <= 8) {
    const dim3 grid((n + kGvN - 1) / kGvN, splits);
    auto kernel = m == 1   ? nf4_gemv_kernel<1, TX, TY>
                  : m == 2 ? nf4_gemv_kernel<2, TX, TY>
                  : m <= 4 ? nf4_gemv_kernel<4, TX, TY>
                           : nf4_gemv_kernel<8, TX, TY>;
    kernel<<<grid, kGvThreads, 0, stream>>>(x, m, k, packed, absmax, code, n, blocks_per_split,
                                            part, y);
  } else {
    const dim3 grid((m + kGmM - 1) / kGmM, (n + kGmN - 1) / kGmN, splits);
    nf4_gemm_kernel<TX, TY><<<grid, kGmThreads, 0, stream>>>(x, m, k, packed, absmax, code, n,
                                                            blocks_per_split, part, y);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t total = static_cast<size_t>(m) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  nf4_splitk_reduce_kernel<TY><<<blocks, threads, 0, stream>>>(part, splits, m, n, y);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, k) row-major, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), k % 64 == 0;
// packed: (k/2, n) uint8, n % 8 == 0; absmax: (k/64, n) f32; code: (16,) f32;
// y: (m, n) f32 (y_bf16 = 0) or bf16 (y_bf16 = 1); part: (splits, m, n) f32
// scratch, unused (may be null) when splits == 1. Returns the cudaError_t of
// the launches.
int fm_nf4_matmul(const void* x, int x_bf16, int m, int k, const uint8_t* packed,
                  const float* absmax, const float* code, int n, void* y, int y_bf16,
                  float* part, int splits, int blocks_per_split, cudaStream_t stream) {
  cudaError_t err;
  if (x_bf16)
    err = y_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, m, k, packed, absmax, code, n, y,
                                                        part, splits, blocks_per_split, stream)
                 : launch<__nv_bfloat16, float>(x, m, k, packed, absmax, code, n, y, part,
                                                splits, blocks_per_split, stream);
  else
    err = y_bf16 ? launch<float, __nv_bfloat16>(x, m, k, packed, absmax, code, n, y, part,
                                                splits, blocks_per_split, stream)
                 : launch<float, float>(x, m, k, packed, absmax, code, n, y, part, splits,
                                        blocks_per_split, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
