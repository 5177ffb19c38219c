// Blockwise int4 in the column-nibble layout times x (Hopper, sm_90a):
//   y[m, n] = sum_k x[m, k] * w[k, n],  w from q[k, n] and s[k / 64, n] by mode,
// with pw (k, n/8) int32: within each 1024-column tile t, word (r, t*128 + l) holds
// in nibble p the code of row r, column t*1024 + p*128 + l; s (k/64, n) f32 in
// real column order. Modes (all sums in f32):
//   0  v8:  q = ((word >> 4p) & 0xF) - 8, w = q * (s * 0.125), f32 x;
//   1  v9:  q the two's-complement nibble, w as v8;
//   2  v10: bf16 x; w = bf16(bf16(q) * bf16(s * 0.125)): the product is rounded
//           to bf16 before it meets x, as the Pallas code's bf16 multiply;
//   3  v11: bf16 x; each 64-row block's sum of x * q is multiplied by s * 0.125
//           in f32 once a block and column, then added.
//
// Replaces the Pallas TPU kernels _run_v8, _run_v9 and _run_v10 (v10, v11) of
// tools/nf4_variants_r04.py. The wrapper gives x as f32, already rounded to bf16
// in modes 2 and 3: a product of bf16 values is exact in f32, so f32 FMAs give
// the bf16 dots up to the order of the sums.
//
// Bound: 0.5 byte of codes and 1/16 byte of scale a weight, device-memory bytes.
// Design: a GEMV. A block of 256 threads is 32 column threads (one word lane each,
// 8 columns; 32 neighbouring words, 128 bytes, a row) by 8 row threads that take
// whole 64-row blocks (so mode 3 scales a thread's own partial), with 8 loads in
// flight; the k axis splits over enough blocks to cover the SMs and x rows go 8
// at a time (grid z). Row threads are added in order in shared memory, split
// partials in split order by a second pass (no float atomics).

#include "int4_tiled.cuh"

namespace {

using namespace int4t;

constexpr int kQB = 64;
constexpr int kColT = 32;
constexpr int kRowT = 8;
constexpr int kThreads = kColT * kRowT;
constexpr int kUnroll = 8;
constexpr int kMChunk = 8;

// The scale of plane p's column for this thread's 64-row block b, as the mode uses it.
__device__ __forceinline__ float plane_scale(const float* s, int b, int n, int col_p, int mode) {
  const float s8 = __ldg(s + static_cast<size_t>(b) * n + col_p) * 0.125f;
  return mode == 2 ? __bfloat162float(__float2bfloat16(s8)) : s8;
}

template <int MR>
__global__ void __launch_bounds__(kThreads) colnibble_kernel(
    const float* __restrict__ x, int m, int k, const int32_t* __restrict__ pw,
    const float* __restrict__ s, int n, int mode, int blocks_per_split,
    float* __restrict__ part) {
  __shared__ float red[kRowT][8][kColT];
  const int tx = threadIdx.x % kColT, ty = threadIdx.x / kColT;
  const int n8 = n / 8;
  const int tile = blockIdx.x / (kLanes / kColT);
  const int lane = (blockIdx.x % (kLanes / kColT)) * kColT + tx;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kMChunk;
  const int mr = min(MR, m - m0);
  const int nb = k / kQB;
  const int b0 = split * blocks_per_split;
  const int b1 = min(b0 + blocks_per_split, nb);
  const int32_t* wcol = pw + tile * kLanes + lane;
  const int colbase = tile * kTileN + lane;  // + p * 128
  const uint32_t flip = mode == 0 ? 0x88888888u : 0u;  // (c & 0xF) - 8 == signed(c ^ 8)

  float acc[MR][8];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int p = 0; p < 8; ++p) acc[i][p] = 0.f;

  for (int b = b0 + ty; b < b1; b += kRowT) {
    float sc[8];
#pragma unroll
    for (int p = 0; p < 8; ++p) sc[p] = plane_scale(s, b, n, colbase + p * kLanes, mode);
    float bacc[MR][8];
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int p = 0; p < 8; ++p) bacc[i][p] = 0.f;
    const float* xb = x + static_cast<size_t>(m0) * k + static_cast<size_t>(b) * kQB;
    for (int r0 = 0; r0 < kQB; r0 += kUnroll) {
      uint32_t wv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        wv[u] = static_cast<uint32_t>(
            __ldg(wcol + (static_cast<size_t>(b) * kQB + r0 + u) * n8));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float q[8];
        nibbles8(wv[u] ^ flip, q);
        float xv[MR];
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xv[i] = i < mr ? __ldg(xb + static_cast<size_t>(i) * k + r0 + u) : 0.f;
#pragma unroll
        for (int p = 0; p < 8; ++p) {
          float wq = q[p];
          if (mode == 2)
            wq = __bfloat162float(__float2bfloat16(wq * sc[p]));
          else if (mode != 3)
            wq *= sc[p];
#pragma unroll
          for (int i = 0; i < MR; ++i) bacc[i][p] = fmaf(xv[i], wq, bacc[i][p]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int p = 0; p < 8; ++p) acc[i][p] += mode == 3 ? bacc[i][p] * sc[p] : bacc[i][p];
  }

  // row threads added in order, one x row at a time (keeps shared memory small)
  const int p_out = threadIdx.x / kColT, l_out = threadIdx.x % kColT;
  const int col = tile * kTileN + p_out * kLanes + (blockIdx.x % (kLanes / kColT)) * kColT + l_out;
  for (int i = 0; i < mr; ++i) {
#pragma unroll
    for (int p = 0; p < 8; ++p) red[ty][p][tx] = acc[i][p];
    __syncthreads();
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kRowT; ++t) sum += red[t][p_out][l_out];
    part[(static_cast<size_t>(split) * m + m0 + i) * n + col] = sum;
    __syncthreads();
  }
}

__global__ void colnibble_reduce_kernel(const float* __restrict__ part, int splits, size_t total,
                                        float* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[static_cast<size_t>(sp) * total + idx];
  y[idx] = sum;
}

}  // namespace

extern "C" {

// x: (m, k) f32; pw: (k, n/8) int32; s: (k/64, n) f32; k % 64 == 0, n % 1024 == 0;
// y: (m, n) f32; part: (splits, m, n) f32 scratch. Returns the cudaError_t of the
// launches.
int fm_int4_colnibble_matmul(const float* x, int m, int k, const int32_t* pw, const float* s,
                             int n, int mode, float* y, float* part, int splits,
                             int blocks_per_split, cudaStream_t stream) {
  const dim3 grid((n / kTileN) * (kLanes / kColT), splits, (m + kMChunk - 1) / kMChunk);
  if (m == 1)
    colnibble_kernel<1><<<grid, kThreads, 0, stream>>>(x, m, k, pw, s, n, mode, blocks_per_split,
                                                       part);
  else
    colnibble_kernel<kMChunk><<<grid, kThreads, 0, stream>>>(x, m, k, pw, s, n, mode,
                                                             blocks_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * n;
  colnibble_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, stream>>>(
      part, splits, total, y);
  return static_cast<int>(cudaGetLastError());
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
