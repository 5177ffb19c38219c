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
// Bound: up to m = 64, 0.5 byte of codes and 1/16 byte of absmax a weight, so
// device-memory bytes. Two kernels, chosen by the caller (tools/lab_kernels.lab_path):
// for m <= 4 (and m > 64) a GEMV, K8's old one, one shared-memory lookup a weight
// close behind the bytes (the table lies in 16 banks: any index pattern is
// conflict-free): each thread takes 4 columns (one 4-byte load a packed row,
// neighbouring threads on neighbouring bytes), 4 row threads take whole 64-row
// blocks, 8 loads stay in flight, and k splits over enough blocks to cover the
// SMs; x rows go 8 at a time (grid z). At m = 8 that design spends 8 f32 FMAs a
// weight and is bound by the FMA rate, so 4 < m <= 64 runs on the bf16 tensor cores
// (q4_byte_tc_kernel below, after K8's nf4_tc_kernel). Split partials are added in
// split order by a second pass (no float atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_tiled.cuh"
#include "mma_bf16.cuh"

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

// ---------------------------------------------------------------- 4 < m <= 64
// K8's tensor-core kernel (nf4_matmul.cu, nf4_tc_kernel) on the same bytes, with
// the lab's scale absmax * scale_mul: mma.sync m16n8k16, bf16 in, f32 sums. A is 16
// output columns by 16 k of codes, B 16 k by 8 rows of x (an m = 8 step fills one B
// tile exactly). In this layout the pair of A that a thread holds in one register,
// k rows 2t and 2t + 1 of one column, is one packed byte (row ks/2 + t): its high
// nibble in the low half.
//
// The table values are not all bf16 numbers, so the caller states how many bf16
// parts the products need (PARTS), from what the variant rounds:
//   PARTS = 1 (v5, v6, v7): the values (NF4 rounded to bf16, or c - 8) and x are
//     bf16 numbers: one part of each, one mma a tile, every product exact;
//   PARTS = 3 (v1, v2): f32 NF4 values in three bf16 parts c0 + c1 + c2 that add up
//     to them exactly (split3_bf16x2), f32 x in parts x0 + x1 + x2, of which the
//     kernel keeps x0 c0, x0 c1, x0 c2 and x1 c0, four mma a tile, as K8 for f32 x.
//     The dropped ones (x1 c1, x2 c0 and smaller) lie within 2^-17 of |x c|.
// A block first builds, from the 16-entry table, a table that maps a byte to its A
// register in each part, the bf16 pairs (part of table[hi], part of table[lo]): with
// three parts one 16-byte entry a byte in 8 copies, copy c in bank group c, read by
// lane l from copy l % 8, so that a quarter warp's random bytes meet no bank
// conflict; with one part one 4-byte entry a byte in 32 copies, one a bank, read by
// lane l from copy l (a warp's loads in one pass). 32 KB a block either way; after
// the k loop the same memory takes the warps' sums on their way out.
//
// Each 64-row absmax block (four 16-row steps) goes into a fresh f32 sum, which is
// scaled once by absmax * scale_mul and added to the running sum with one fmaf, for
// both orders of the reference: where it scales each weight before the product
// (v1, v2, v6), the scale comes out of the block's sum, which changes only the f32
// rounding of c * s (tests/test_torch_lab_tc.py holds an emulation of these sums
// within phase 11's gate).
//
// Loads: thread (g, t) reads, of packed rows ks/2 + t and ks/2 + t + 4, the 8 bytes
// of columns 8g..8g+7 of its warp's 64 (one 8-byte load each: n % 8 == 0 keeps them
// aligned). Byte i is A row g + 8 (i % 2) of tile i / 2. A block's 8 loads are started
// before its first step. Columns past n read no bytes and are not written.
//
// Block: 4 warps side by side on 256 columns, each walking the same absmax blocks of
// one k split, so that they read the same x (through L1); each warp writes its own
// columns of the split's partial through shared memory. grid: (m chunks of 8 rows,
// column tiles of 256, splits).
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcWarpN = 64;                 // columns of a warp
constexpr int kTcN = kTcWarps * kTcWarpN;    // columns of a block
constexpr int kTcTiles = kTcWarpN / 16;      // A tiles of a warp
constexpr int kTcRows = 8;                   // rows of x in one B tile
constexpr int kTcStep = 16;                  // k rows of one mma
constexpr int kTcSteps = kQB / kTcStep;      // steps of one absmax block
constexpr int kCodeParts = 3;
constexpr int kTabEntries = 256;
constexpr int kTabWords = 2048;              // 16-byte words of the table: 32 KB
static_assert(kTabEntries * 8 <= kTabWords && kTabEntries * 32 / 4 <= kTabWords, "table");
static_assert(kTcRows * kTcN / 4 <= kTabWords, "the warps' sums");

// B's register pair of f32 x at k rows kr, kr + 1 of one row, in two bf16 parts (the
// third is never multiplied); with bf16 operands the first part is x itself
__device__ __forceinline__ void x_pair(const float* p, bool ok, uint32_t b[2]) {
  const float2 v = ok ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
  uint32_t s[3];
  int4t::split3_bf16x2(v.x, v.y, s);
  b[0] = s[0];
  b[1] = s[1];
}

template <int PARTS>
__global__ void __launch_bounds__(kTcThreads, 4) q4_byte_tc_kernel(
    const float* __restrict__ x, int m, int k, const uint8_t* __restrict__ packed,
    const float* __restrict__ absmax, const float* __restrict__ table, float scale_mul, int n,
    int blocks_per_split, float* __restrict__ part) {
  constexpr int kXParts = PARTS == 3 ? 2 : 1;          // parts of x in B
  constexpr int kCopies = PARTS == 3 ? 8 : 32;         // table copies, one a bank group
  __shared__ uint4 smem[kTabWords];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kTcRows;
  const int nw = blockIdx.y * kTcN + warp * kTcWarpN;  // the warp's first column
  const int split = blockIdx.z;
  const int nb = k / kQB;
  const int b0 = split * blocks_per_split;
  const int b1 = min(b0 + blocks_per_split, nb);

  uint4* tab3 = smem;                                  // PARTS = 3: entry (c0, c1, c2, pad)
  uint32_t* tab1 = reinterpret_cast<uint32_t*>(smem);  // PARTS = 1: entry c0
  for (int i = threadIdx.x; i < kTabEntries; i += kTcThreads) {
    float e, o;
    decode_byte(table, i, e, o);
    uint32_t p[kCodeParts];
    int4t::split3_bf16x2(e, o, p);
#pragma unroll
    for (int c = 0; c < kCopies; ++c) {
      if constexpr (PARTS == 3)
        tab3[i * kCopies + c] = make_uint4(p[0], p[1], p[2], 0u);
      else
        tab1[i * kCopies + c] = p[0];
    }
  }
  __syncthreads();
  const uint4* my3 = tab3 + lane % kCopies;
  const uint32_t* my1 = tab1 + lane % kCopies;

  const bool col_ok = nw + 8 * g < n;
  const uint8_t* pcol = packed + nw + 8 * g;
  const bool xrow_ok = m0 + g < m;
  const float* xrow = x + static_cast<size_t>(xrow_ok ? m0 + g : 0) * k + 2 * t;

  float acc[kTcTiles][4], blk[kTcTiles][4];
#pragma unroll
  for (int j = 0; j < kTcTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int b = b0; b < b1; ++b) {
    uint2 wv[kTcSteps][2];  // [step][packed row ks/2 + t, ks/2 + t + 4]
#pragma unroll
    for (int st = 0; st < kTcSteps; ++st)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        wv[st][r] = col_ok ? __ldg(reinterpret_cast<const uint2*>(
                                 pcol + static_cast<size_t>(b * kQBBytes + st * kTcStep / 2 +
                                                            t + 4 * r) * n))
                           : make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < kTcTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk[j][e] = 0.f;  // a fresh sum for each absmax block
#pragma unroll
    for (int st = 0; st < kTcSteps; ++st) {
      const int ks = b * kQB + st * kTcStep;
      uint32_t bx[2][2];  // [k rows ks + 2t, 2t + 1 | ks + 2t + 8, 2t + 9][part of x]
      x_pair(xrow + ks, xrow_ok, bx[0]);
      x_pair(xrow + ks + 8, xrow_ok, bx[1]);
#pragma unroll
      for (int j = 0; j < kTcTiles; ++j) {
        const int s = (2 * j) % 4;  // bytes 2j, 2j + 1: A rows g and g + 8 of tile j
        const uint32_t w0 = j < 2 ? wv[st][0].x : wv[st][0].y;
        const uint32_t w1 = j < 2 ? wv[st][1].x : wv[st][1].y;
        // the entries of A rows g, g + 8 at k 2t, 2t + 1 (w0) and 2t + 8, 2t + 9 (w1)
        const uint32_t i0 = (w0 >> (8 * s)) & 0xFFu, i1 = (w0 >> (8 * s + 8)) & 0xFFu;
        const uint32_t i2 = (w1 >> (8 * s)) & 0xFFu, i3 = (w1 >> (8 * s + 8)) & 0xFFu;
        if constexpr (PARTS == 3) {
          const uint4 e0 = my3[i0 * kCopies], e1 = my3[i1 * kCopies];
          const uint4 e2 = my3[i2 * kCopies], e3 = my3[i3 * kCopies];
          const uint32_t a[kCodeParts][4] = {{e0.x, e1.x, e2.x, e3.x},
                                             {e0.y, e1.y, e2.y, e3.y},
                                             {e0.z, e1.z, e2.z, e3.z}};
#pragma unroll
          for (int e = 0; e < kCodeParts; ++e) mma_bf16(blk[j], a[e], bx[0][0], bx[1][0]);
          if (kXParts == 2) mma_bf16(blk[j], a[0], bx[0][1], bx[1][1]);
        } else {
          const uint32_t a[4] = {my1[i0 * kCopies], my1[i1 * kCopies], my1[i2 * kCopies],
                                 my1[i3 * kCopies]};
          mma_bf16(blk[j], a, bx[0][0], bx[1][0]);
        }
      }
    }
    // blk[j][e]: column nw + 8g + 2j + (e >> 1), x row m0 + 2t + (e & 1)
    if (col_ok) {
      const float* am = absmax + static_cast<size_t>(b) * n + nw + 8 * g;
      const float4 lo = __ldg(reinterpret_cast<const float4*>(am));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(am + 4));
      const float a8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < kTcTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = fmaf(blk[j][e], a8[2 * j + (e >> 1)] * scale_mul, acc[j][e]);
    }
  }

  __syncthreads();  // every warp is done with the table
  float* red = reinterpret_cast<float*>(smem) + warp * kTcRows * kTcWarpN;  // [x row][column]
#pragma unroll
  for (int j = 0; j < kTcTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      red[(2 * t + (e & 1)) * kTcWarpN + 8 * g + 2 * j + (e >> 1)] = acc[j][e];
  __syncwarp();
  for (int i = 0; i < kTcRows && m0 + i < m; ++i)
#pragma unroll
    for (int h = 0; h < kTcWarpN / 32; ++h) {
      const int col = nw + 32 * h + lane;
      if (col < n)
        part[(static_cast<size_t>(split) * m + m0 + i) * n + col] =
            red[i * kTcWarpN + 32 * h + lane];
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

// the kernels the caller picks (tools/lab_kernels.lab_path)
constexpr int kPathGemv = 0, kPathTc = 1;

}  // namespace

extern "C" {

// x: (m, k) f32, 16-byte aligned; packed: (k/2, n) u8; absmax: (k/64, n) f32; table:
// (16,) f32; k % 64 == 0, n % 4 == 0, packed and absmax 16-byte aligned; y: (m, n)
// f32; part: (splits, m, n) f32 scratch. bf16_operands: x and the table values are
// bf16 numbers (one bf16 part each on the tensor cores; else three of the table, two
// of x). path: 0 the gemv (any m), 1 the tensor cores (m > 4, n % 8 == 0). Returns the
// cudaError_t of the launches.
int fm_q4_byte_matmul(const float* x, int m, int k, const uint8_t* packed, const float* absmax,
                      const float* table, float scale_mul, int per_block, int n, float* y,
                      float* part, int splits, int blocks_per_split, int bf16_operands, int path,
                      cudaStream_t stream) {
  if (path == kPathGemv) {
    const dim3 grid((n + kN - 1) / kN, splits, (m + kMChunk - 1) / kMChunk);
    if (m == 1)
      q4_byte_kernel<1><<<grid, kThreads, 0, stream>>>(x, m, k, packed, absmax, table,
                                                       scale_mul, per_block, n,
                                                       blocks_per_split, part);
    else
      q4_byte_kernel<kMChunk><<<grid, kThreads, 0, stream>>>(
          x, m, k, packed, absmax, table, scale_mul, per_block, n, blocks_per_split, part);
  } else if (path == kPathTc) {
    if (m <= 4 || n % 8 || k % kQB) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((m + kTcRows - 1) / kTcRows, (n + kTcN - 1) / kTcN, splits);
    if (bf16_operands)
      q4_byte_tc_kernel<1><<<grid, kTcThreads, 0, stream>>>(x, m, k, packed, absmax, table,
                                                            scale_mul, n, blocks_per_split,
                                                            part);
    else
      q4_byte_tc_kernel<3><<<grid, kTcThreads, 0, stream>>>(x, m, k, packed, absmax, table,
                                                            scale_mul, n, blocks_per_split,
                                                            part);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
