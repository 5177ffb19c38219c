// 4-bit codes in the q4 byte layout times x, with a 16-entry value table
// (Hopper, sm_90a):
//   y[m, n] = sum_k x[m, k] * table[q[k, n]] * (absmax[k / 64, n] * scale_mul)
// codes packed two to a byte along k (byte r of a column: the high nibble is row
// 2r, the low nibble row 2r + 1), x in f32, accumulated in f32, in one of two
// orders:
//   per_block = 0: each weight is scaled before the product,
//                  w = table[q] * (absmax * scale_mul), then x * w is summed;
//   per_block = 1: each 64-row block's sum of x * table[q] is multiplied by
//                  absmax * scale_mul once a block and column, then added.
//
// Replaces the Pallas TPU kernels _run (tools/nf4_variants_r04.py, exact NF4:
// v1/v2 scale before the product with f32 code values; v5 per block with bf16
// code values and bf16 x) and _run_int4 (linear int4 on the same bytes, level
// (c - 8) * absmax / 8, x rounded to bf16: v6 scales before the product in f32,
// v7 per block in bf16). The wrapper gives the table (NF4 in f32, NF4 rounded to
// bf16, or c - 8) and x already rounded where the Pallas code rounds it: products
// of bf16 values are exact in f32, so f32 FMAs on the rounded operands give the
// reference's bf16 dots up to the order of the f32 sums. (v3/v4 are K8's
// function and go to K8.)
//
// Bound: at m <= 8, 0.5 byte of codes and 1/16 byte of absmax a weight, so
// device-memory bytes, one shared-memory lookup a weight close behind (the table
// lies in 16 banks: any index pattern is conflict-free). The design is K8's GEMV:
// each thread takes 4 columns (one 4-byte load a packed row, neighbouring
// threads on neighbouring bytes), 4 row threads take whole 64-row blocks, 8
// loads stay in flight, and k splits over enough blocks to cover the SMs; x
// rows go 8 at a time (grid z). Split partials are added in split order by a
// second pass (no float atomics).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQB = 64;  // rows of one absmax block
constexpr int kQBBytes = kQB / 2;
constexpr int kThreads = 256;
constexpr int kColT = 64;
constexpr int kRowT = kThreads / kColT;
constexpr int kN = kColT * 4;  // columns of one block
constexpr int kUnroll = 8;
constexpr int kMChunk = 8;

// The two table values of one packed byte: even row (high nibble), odd row (low).
__device__ __forceinline__ void decode_byte(const float* table, uint32_t b, float& e, float& o) {
  e = table[(b >> 4) & 0xFu]; o = table[b & 0xFu];
}

template <int MR>
__global__ void __launch_bounds__(kThreads) q4_byte_kernel(
    const float* __restrict__ x, int m, int k, const uint8_t* __restrict__ packed,
    const float* __restrict__ absmax, const float* __restrict__ table, float scale_mul,
    int per_block, int n, int blocks_per_split, float* __restrict__ part) {
  __shared__ float table_s[16];
  __shared__ float red[kRowT][MR][kN];
  const int tid = threadIdx.x;
  const int tx = tid % kColT, ty = tid / kColT;
  const int col0 = blockIdx.x * kN + tx * 4;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kMChunk;
  const int mr = min(MR, m - m0);
  const int nb = k / kQB;
  const int b0 = split * blocks_per_split;
  const int b1 = min(b0 + blocks_per_split, nb);
  if (tid < 16) table_s[tid] = table[tid];
  __syncthreads();

  float acc[MR][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  if (col0 < n) {
    for (int b = b0 + ty; b < b1; b += kRowT) {
      const uint8_t* prow = packed + static_cast<size_t>(b) * kQBBytes * n + col0;
      const float* xb = x + static_cast<size_t>(m0) * k + static_cast<size_t>(b) * kQB;
      const float4 am = __ldg(reinterpret_cast<const float4*>(absmax + static_cast<size_t>(b) * n +
                                                              col0));
      const float s[4] = {am.x * scale_mul, am.y * scale_mul, am.z * scale_mul,
                          am.w * scale_mul};
      float bacc[MR][4];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) bacc[i][c] = 0.f;
      for (int r0 = 0; r0 < kQBBytes; r0 += kUnroll) {
        uint32_t wv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          wv[u] = __ldg(reinterpret_cast<const uint32_t*>(prow + static_cast<size_t>(r0 + u) * n));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int r = r0 + u;
          float xe[MR], xo[MR];
#pragma unroll
          for (int i = 0; i < MR; ++i) {
            xe[i] = i < mr ? __ldg(xb + static_cast<size_t>(i) * k + 2 * r) : 0.f;
            xo[i] = i < mr ? __ldg(xb + static_cast<size_t>(i) * k + 2 * r + 1) : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float we, wo;
            decode_byte(table_s, wv[u] >> (8 * c), we, wo);
            if (!per_block) {
              we *= s[c];
              wo *= s[c];
            }
#pragma unroll
            for (int i = 0; i < MR; ++i)
              bacc[i][c] = fmaf(xo[i], wo, fmaf(xe[i], we, bacc[i][c]));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] += per_block ? bacc[i][c] * s[c] : bacc[i][c];
    }
  }
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[ty][i][tx * 4 + c] = acc[i][c];
  __syncthreads();
  const int col = blockIdx.x * kN + tid;  // thread -> one column; row threads added in order
  if (col >= n) return;
  for (int i = 0; i < mr; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kRowT; ++t) sum += red[t][i][tid];
    part[(static_cast<size_t>(split) * m + m0 + i) * n + col] = sum;
  }
}

__global__ void q4_byte_reduce_kernel(const float* __restrict__ part, int splits, size_t total,
                                      float* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[static_cast<size_t>(sp) * total + idx];
  y[idx] = sum;
}

}  // namespace

extern "C" {

// x: (m, k) f32; packed: (k/2, n) u8; absmax: (k/64, n) f32; table: (16,) f32;
// k % 64 == 0, n % 4 == 0, packed and absmax 16-byte aligned; y: (m, n) f32;
// part: (splits, m, n) f32 scratch. Returns the cudaError_t of the launches.
int fm_q4_byte_matmul(const float* x, int m, int k, const uint8_t* packed, const float* absmax,
                      const float* table, float scale_mul, int per_block, int n, float* y,
                      float* part, int splits, int blocks_per_split, cudaStream_t stream) {
  const dim3 grid((n + kN - 1) / kN, splits, (m + kMChunk - 1) / kMChunk);
  if (m == 1)
    q4_byte_kernel<1><<<grid, kThreads, 0, stream>>>(x, m, k, packed, absmax, table, scale_mul,
                                                     per_block, n, blocks_per_split, part);
  else
    q4_byte_kernel<kMChunk><<<grid, kThreads, 0, stream>>>(
        x, m, k, packed, absmax, table, scale_mul, per_block, n, blocks_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  q4_byte_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      part, splits, total, y);
  return static_cast<int>(cudaGetLastError());
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
