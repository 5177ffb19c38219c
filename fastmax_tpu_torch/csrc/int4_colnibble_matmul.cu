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
// Bound: up to m = 64, 0.5 byte of codes and 1/16 byte of scale a weight,
// device-memory bytes. Two kernels, chosen by the caller (tools/lab_kernels.lab_path).
// For m <= 4 (and m > 64) a GEMV: a block of 256 threads is 32 column threads (one
// word lane each, 8 columns; 32 neighbouring words, 128 bytes, a row) by 8 row
// threads that take whole 64-row blocks (so mode 3 scales a thread's own partial),
// with 8 loads in flight; the k axis splits over enough blocks to cover the SMs and x
// rows go 8 at a time (grid z). Row threads are added in order in shared memory. At
// m = 8 that design spends 8 f32 FMAs a weight and is bound by the FMA rate, so 4 < m
// <= 64 runs on the bf16 tensor cores (colnibble_tc_kernel below, after K9's
// int4_block_tc_kernel). Split partials are added in split order by a second pass
// (no float atomics).

#include "int4_tiled.cuh"
#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------- 4 < m <= 64
// K9's tensor-core kernel (int4_block_matmul.cu, int4_block_tc_kernel) on the
// column-nibble words: mma.sync m16n8k16, bf16 in, f32 sums. A is 16 output columns
// by 16 k of codes (16 neighbouring word lanes of one nibble plane; a code in [-8, 7]
// is exact in bf16), B 16 k by 8 rows of x. The column mapping is K9's (column =
// tile * 1024 + plane * 128 + lane); only the word address differs: row r of the unit
// (tile, 16 lanes from lane0) is pw + r * (n / 8) + tile * 128 + lane0. The A tile's
// 16 rows are the unit's lanes in the order 0, 2, ..., 14, 1, 3, ..., 15 (A row g is
// lane 2g, row g + 8 lane 2g + 1), so the two words a thread needs of each of its k
// rows (2t, 2t + 1, 2t + 8, 2t + 9) are one 8-byte load; they are decoded straight
// into bf16 pairs (nibble_bytes, code_pair_bf16x2). v8 stores c with (c & 0xF) - 8 its
// code, the two's-complement nibble of c ^ 8: its words are XORed with 0x88888888
// first. By mode:
//   v8, v9: f32 x in three bf16 parts that add up to it exactly (split3_bf16x2),
//     three mma a plane, every product exact; each warp takes whole 64-row scale
//     blocks (the 4 warps of a block interleave over the blocks of one k split),
//     sums a block's four 16-row steps in a fresh f32 sum and adds it times
//     s * 0.125 with one fmaf. This differs from the reference's sum of scaled
//     products in rounding only (c * s is not exact in bf16, so the scale cannot
//     go into A);
//   v10: the reference rounds each weight q * bf16(s * 0.125) to bf16, so the scale
//     cannot leave the product: A is that rounded weight, formed per element, with
//     bf16 x (one part, exact) and one mma straight into the running sum;
//   v11: bf16 x, one mma a plane, the block sum scaled once as v8's.
// The warps' sums are added in warp order in shared memory (tc_store_part).
// grid: (n / 1024 * 8 units of 16 lanes, splits, m chunks of 8 rows); k % 64 == 0.
constexpr int kTcSteps = kQB / kTcStep;  // steps of one scale block

// bf16(q * sb) of each half of a pair of codes, q * sb exact in f32 (an 8-bit by a
// 4-bit significand), rounded to nearest even as the reference's bf16 multiply
__device__ __forceinline__ uint32_t scaled_pair(uint32_t q, float sb) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q));
  return pack_bf16x2(f.x * sb, f.y * sb);
}

template <int MODE>
__global__ void __launch_bounds__(kTcThreads) colnibble_tc_kernel(
    const float* __restrict__ x, int m, int k, const int32_t* __restrict__ pw,
    const float* __restrict__ s, int n, int blocks_per_split, float* __restrict__ part) {
  constexpr int kParts = MODE <= 1 ? 3 : 1;  // bf16 parts of x in B: f32 x (v8, v9) in three
  constexpr bool kScaleInA = MODE == 2;      // v10: the scale goes into A, rounded per weight
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x / kTcUnits;
  const int lane0 = (blockIdx.x % kTcUnits) * kTcUnitLanes;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kTcRows;
  const int n8 = n / 8;
  const int nb = k / kQB;
  const int b0 = split * blocks_per_split;
  const int b1 = min(b0 + blocks_per_split, nb);
  const bool xrow_ok = m0 + g < m;
  const float* xrow = x + static_cast<size_t>(xrow_ok ? m0 + g : 0) * k;
  const int32_t* wcol = pw + tile * kLanes + lane0 + 2 * g;  // lanes 2g, 2g + 1 of the unit
  const float* scol = s + tile * kTileN + lane0 + 2 * g;    // + plane * 128 + h, row b
  const uint32_t flip = MODE == 0 ? 0x88888888u : 0u;  // (c & 0xF) - 8 == signed(c ^ 8)

  float acc[8][4], blk[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  // k rows of this thread's fragments within a step: 2t, 2t+1, 2t+8, 2t+9
  const int rofs[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
  for (int b = b0 + warp; b < b1; b += kTcWarps) {
    const float* srow = scol + static_cast<size_t>(b) * n;
    float sb[8][2];  // v10: bf16(s * 0.125) of lanes 2g, 2g + 1 of each plane
    if constexpr (kScaleInA) {
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          sb[p][h] = __bfloat162float(__float2bfloat16(__ldg(srow + p * kLanes + h) * 0.125f));
    }
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) blk[p][j] = 0.f;  // a fresh sum for each scale block
#pragma unroll
    for (int st = 0; st < kTcSteps; ++st) {
      const int ks = b * kQB + st * kTcStep;
      uint32_t nib[2][4][2];  // nibble_bytes of the 8 words of this thread's A fragments
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // A rows g, g + 8: lanes 2g, 2g + 1 of the unit
        const uint2 wv = __ldg(reinterpret_cast<const uint2*>(
            wcol + static_cast<size_t>(ks + rofs[r]) * n8));
        nibble_bytes(wv.x ^ flip, nib[0][r]);
        nibble_bytes(wv.y ^ flip, nib[1][r]);
      }
      float xv[4];  // B column g: x of row m0 + g at k rows ks + rofs[r]
#pragma unroll
      for (int r = 0; r < 4; ++r) xv[r] = xrow_ok ? __ldg(xrow + ks + rofs[r]) : 0.f;
      uint32_t bx[2][3];  // (k 2t, 2t+1), (k 2t+8, 2t+9): kParts bf16 parts each
      if constexpr (kParts == 3) {
        split3_bf16x2(xv[0], xv[1], bx[0]);
        split3_bf16x2(xv[2], xv[3], bx[1]);
      } else {  // bf16 x: exact in one part
        bx[0][0] = pack_bf16x2(xv[0], xv[1]);
        bx[1][0] = pack_bf16x2(xv[2], xv[3]);
      }
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        uint32_t a[4] = {code_pair_bf16x2(nib[0][0], nib[0][1], p),   // column g, k 2t, 2t+1
                         code_pair_bf16x2(nib[1][0], nib[1][1], p),   // column g+8
                         code_pair_bf16x2(nib[0][2], nib[0][3], p),   // column g, k 2t+8, 2t+9
                         code_pair_bf16x2(nib[1][2], nib[1][3], p)};  // column g+8
        if constexpr (kScaleInA) {
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = scaled_pair(a[r], sb[p][r % 2]);
          mma_bf16(acc[p], a, bx[0][0], bx[1][0]);
        } else {
#pragma unroll
          for (int e = 0; e < kParts; ++e) mma_bf16(blk[p], a, bx[0][e], bx[1][e]);
        }
      }
    }
    // blk[p][j]: lane lane0 + 2g + (j >> 1) of plane p, x row m0 + 2t + (j & 1)
    if constexpr (!kScaleInA) {
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sc = __ldg(srow + p * kLanes + h) * 0.125f;
          acc[p][2 * h] = fmaf(blk[p][2 * h], sc, acc[p][2 * h]);
          acc[p][2 * h + 1] = fmaf(blk[p][2 * h + 1], sc, acc[p][2 * h + 1]);
        }
    }
  }

  tc_store_part(acc, 2 * g, 1, part, split, m, m0, tile, lane0, n);
}

__global__ void colnibble_reduce_kernel(const float* __restrict__ part, int splits, size_t total,
                                        float* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[static_cast<size_t>(sp) * total + idx];
  y[idx] = sum;
}

// the kernels the caller picks (tools/lab_kernels.lab_path)
constexpr int kPathGemv = 0, kPathTc = 1;

}  // namespace

extern "C" {

// x: (m, k) f32, 16-byte aligned; pw: (k, n/8) int32, 16-byte aligned; s: (k/64, n)
// f32; k % 64 == 0, n % 1024 == 0; y: (m, n) f32; part: (splits, m, n) f32 scratch;
// path: 0 the gemv (any m), 1 the tensor cores (m > 4). Returns the cudaError_t of the
// launches.
int fm_int4_colnibble_matmul(const float* x, int m, int k, const int32_t* pw, const float* s,
                             int n, int mode, float* y, float* part, int splits,
                             int blocks_per_split, int path, cudaStream_t stream) {
  if (mode < 0 || mode > 3 || n % kTileN || k % kQB)
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == kPathGemv) {
    const dim3 grid((n / kTileN) * (kLanes / kColT), splits, (m + kMChunk - 1) / kMChunk);
    if (m == 1)
      colnibble_kernel<1><<<grid, kThreads, 0, stream>>>(x, m, k, pw, s, n, mode,
                                                         blocks_per_split, part);
    else
      colnibble_kernel<kMChunk><<<grid, kThreads, 0, stream>>>(x, m, k, pw, s, n, mode,
                                                               blocks_per_split, part);
  } else if (path == kPathTc) {
    if (m <= 4) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((n / kTileN) * kTcUnits, splits, (m + kTcRows - 1) / kTcRows);
    auto kernel = mode == 0   ? colnibble_tc_kernel<0>
                  : mode == 1 ? colnibble_tc_kernel<1>
                  : mode == 2 ? colnibble_tc_kernel<2>
                              : colnibble_tc_kernel<3>;
    kernel<<<grid, kTcThreads, 0, stream>>>(x, m, k, pw, s, n, blocks_per_split, part);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
