// Raw signed int4 nibbles of tiled words times bf16 x on the tensor cores
// (Hopper, sm_90a):
//   y[m, n] = sum_k x[m, k] * q[k, n],   x bf16, q in [-8, 7], sums in f32,
// for every column of the packed order (column = tile*1024 + plane*128 + lane).
//
// Replaces the Pallas TPU kernels of the tools/ experiments that take this product
// with bf16 operands: bf16_matmul (tools/int4_opt_r05.py, onedot False and True:
// the same function), m8_matmul with dtype=bf16 (tools/int4_opt_r04.py) and
// _run_v12 with bf16=True (tools/nf4_variants_r04.py; its u and v stay outside).
// A nibble is exact in bf16, so the only freedom is the order of the f32 sums.
//
// Layout: the tiled words of K1/K9 (int4_tiled.cuh): word (gk_i, gn_i, r, lane)
// holds in nibble p the code of row gk_i*tk + r, column gn_i*1024 + p*128 + lane.
//
// Design: mma.sync m16n8k16 (bf16 in, f32 sums). The A operand is 16 output
// columns by 16 k: 16 neighbouring lanes of one nibble plane; the B operand is
// 16 k by 8 rows of x, so m = 8 fills it and m = 1 leaves 7 of its 8 columns
// zero (where x in A would waste 15 of 16 rows). Each thread loads the 8 words
// its A fragments need for one 16-row k step (2 lanes x 4 rows) once, takes all
// 8 nibbles of each (int4_tiled.cuh's nibbles8) and feeds 8 mma, one per plane:
// a warp covers 128 columns (16 lanes x 8 planes) and 16 rows a step. The 4 warps
// of a block interleave over the steps of one k split; their sums are added in
// warp order in shared memory, and split-k partials are added in split order by
// a second pass (no float atomics).
//
// Bound: 0.5 byte per weight read from device memory; 2 m k n operations on the
// tensor cores, far below the bytes at m <= 8. This first version loads 4-byte
// words (each 32-byte sector whole) and is not tuned.

#include "int4_tiled.cuh"

namespace {

using namespace int4t;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnitLanes = 16;                  // lanes of one A tile
constexpr int kUnitsPerTile = kLanes / kUnitLanes;
constexpr int kStep = 16;                       // k rows of one mma
constexpr int kMChunk = 8;                      // rows of x in one B tile

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// grid: (gn * 8 units of 16 lanes, splits, m chunks of 8)
__global__ void __launch_bounds__(kThreads) int4_tiled_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, int m, const int32_t* __restrict__ w, int gk, int gn,
    int tk, int rows_per_split, float* __restrict__ part) {
  __shared__ float red[kWarps][8][kUnitLanes][kMChunk];
  const int k_pad = gk * tk;
  const int n_pad = gn * kTileN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int gni = blockIdx.x / kUnitsPerTile;
  const int lane0 = (blockIdx.x % kUnitsPerTile) * kUnitLanes;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kMChunk;
  const int k0 = split * rows_per_split;
  const int k1 = min(k0 + rows_per_split, k_pad);
  const bool xrow_ok = m0 + g < m;
  const __nv_bfloat16* xrow = x + static_cast<size_t>(xrow_ok ? m0 + g : 0) * k_pad;

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  // rows of this thread's fragments within a step: 2t, 2t+1, 2t+8, 2t+9
  const int rofs[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
  for (int ks = k0 + warp * kStep; ks < k1; ks += kWarps * kStep) {
    uint32_t words[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        words[h][r] = static_cast<uint32_t>(
            __ldg(word_ptr(w, ks + rofs[r], gni, gk, gn, tk) + lane0 + g + 8 * h));
    uint32_t b[2] = {0u, 0u};
    if (xrow_ok) {
      b[0] = __ldg(reinterpret_cast<const uint32_t*>(xrow + ks + 2 * t));
      b[1] = __ldg(reinterpret_cast<const uint32_t*>(xrow + ks + 2 * t + 8));
    }
    float q[2][4][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) nibbles8(words[h][r], q[h][r]);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint32_t a[4] = {pack_bf16x2(q[0][0][p], q[0][1][p]),   // row g, k 2t, 2t+1
                             pack_bf16x2(q[1][0][p], q[1][1][p]),   // row g+8
                             pack_bf16x2(q[0][2][p], q[0][3][p]),   // row g, k 2t+8, 2t+9
                             pack_bf16x2(q[1][2][p], q[1][3][p])};  // row g+8
      mma_bf16(acc[p], a, b);
    }
  }

  // acc[p][j]: column lane0 + g + 8 (j >> 1) of plane p, x row m0 + 2t + (j & 1)
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][p][g + 8 * (j >> 1)][2 * t + (j & 1)] = acc[p][j];
  __syncthreads();
  const int p = threadIdx.x / kUnitLanes, l = threadIdx.x % kUnitLanes;
  const int col = gni * kTileN + p * kLanes + lane0 + l;
  for (int i = 0; i < kMChunk && m0 + i < m; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) sum += red[wi][p][l][i];
    part[(static_cast<size_t>(split) * m + m0 + i) * n_pad + col] = sum;
  }
}

// Adds the split partials in split order.
__global__ void int4_tiled_bf16_reduce_kernel(const float* __restrict__ part, int splits,
                                              size_t total, float* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[static_cast<size_t>(sp) * total + idx];
  y[idx] = sum;
}

}  // namespace

extern "C" {

// x: (m, gk*tk) bf16 row-major; w: (gk, gn, tk, 128) int32 words, tk % 16 == 0;
// y: (m, gn*1024) f32; part: (splits, m, gn*1024) f32 scratch; rows_per_split %
// 16 == 0. Returns the cudaError_t of the launches.
int fm_int4_tiled_bf16(const void* x, int m, const int32_t* w, int gk, int gn, int tk, float* y,
                       float* part, int splits, int rows_per_split, cudaStream_t stream) {
  const dim3 grid(gn * kUnitsPerTile, splits, (m + kMChunk - 1) / kMChunk);
  int4_tiled_bf16_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), m, w, gk, gn, tk, rows_per_split, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t total = static_cast<size_t>(m) * gn * kTileN;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  int4_tiled_bf16_reduce_kernel<<<blocks, 256, 0, stream>>>(part, splits, total, y);
  return static_cast<int>(cudaGetLastError());
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
