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
// Bound: up to m = 64 the kernel reads 0.5 byte of codes and 1/16 byte of
// absmax per weight, so device-memory bytes. Three kernels, chosen by the
// caller (ops/quant_kernels.nf4_path): for m <= 4 a GEMV (one shared-memory
// lookup per weight; the 16-entry table lies in 16 banks, so any pattern of
// indices is conflict-free) that gives each thread 4 columns (one 4-byte load
// a packed row, neighbouring threads on neighbouring bytes), keeps 8 loads in
// flight, and splits k over enough blocks to cover all SMs; for 4 < m <= 64 the
// bf16 tensor cores (nf4_tc_kernel below); above that 64-row f32 FMA tiles
// that decode each 32-row half of a quant block once into shared memory and
// reuse it for 64 rows, bound by f32 FMA issue. With more than one split,
// partial sums go to a scratch buffer and a second pass adds them in a fixed
// order (no float atomics).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int4_tiled.cuh"
#include "mma_bf16.cuh"

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
// (the caller routes m <= 4 here; MR = 8 stays for timing the earlier route)
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

// ---------------------------------------------------------------- 4 < m <= 64
// mma.sync m16n8k16, bf16 in, f32 sums, with the operands of K1's and K9's
// tensor-core kernels: A is 16 output columns by 16 k of codes, B 16 k by 8 rows of
// x (an m = 8 step fills one B tile exactly). In this layout the pair of A that a
// thread holds in one register, k rows 2t and 2t + 1 of one column, is one packed
// byte (row ks/2 + t): its high nibble in the low half.
//
// The codes are not bf16 numbers. Each splits exactly into three bf16 parts
// c0 + c1 + c2 (split3_bf16x2; NF4 and FP4 need all three, the int4 levels one).
// A block first builds, from the 16-entry code table, a table that maps a byte to
// its A register in each part, the bf16 pairs (part of code[hi], part of
// code[lo]), one 16-byte entry a byte: one 16-byte shared load gives all three. A
// quarter warp's 8 lanes load together and read random bytes, so the table is kept
// in 8 copies, copy c in bank group c (16 bytes), and lane l reads copy l % 8: no
// two lanes of a quarter warp meet in a bank (one copy took 1.5x the time at m = 8,
// four 1.25x: tools/k8_ab.py). 32 KB a block; after the k loop the same memory
// takes the warps' sums on their way out.
//
// Products: bf16 x is exact in one part, so three mma a tile, x with each code
// part, and every product is exact. f32 x splits into three parts x0 + x1 + x2
// (split3_bf16x2); the kernel keeps x0 c0, x0 c1, x0 c2 and x1 c0, four mma a
// tile. The dropped ones (x1 c1, x2 c0 and smaller) lie within 2^-17 of |x c| and
// change sign with x's rounding residues: emulated at k = 4096 the kernel's sum
// lies within a fifth of the f32 gate (2e-4 + 1e-4 |ref|; tests/test_torch_nf4_tc.py).
// Each quant block's 64 rows (four 16-row steps) go into a fresh f32 sum, which is
// scaled once by the block's absmax and added to the running sum with one fmaf, in
// the reference's order.
//
// Loads: thread (g, t) reads, of packed rows ks/2 + t and ks/2 + t + 4, the 8 bytes
// of columns 8g..8g+7 of its warp's 64 (one 8-byte load each: n % 8 == 0 keeps them
// aligned; a quarter warp reads 64 neighbouring bytes of each row). Byte i is A row
// g + 8 (i % 2) of tile i / 2, so the 8 bytes are the thread's A rows of the warp's
// 4 tiles and no shuffle is needed. A quant block's 8 loads are issued before its
// first step. Columns past n read no bytes and are not written.
//
// Block: 4 warps side by side on 256 columns, each walking the same quant blocks of
// one k split, so that they read the same x (through L1). Each warp writes its own
// columns through shared memory, 128 contiguous bytes a store.
// grid: (m chunks of 8 rows, column tiles of 256, splits).
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcWarpN = 64;                 // columns of a warp
constexpr int kTcN = kTcWarps * kTcWarpN;    // columns of a block
constexpr int kTcTiles = kTcWarpN / 16;      // A tiles of a warp
constexpr int kTcRows = 8;                   // rows of x in one B tile
constexpr int kTcStep = 16;                  // k rows of one mma
constexpr int kTcSteps = kQB / kTcStep;      // steps of one quant block
constexpr int kCodeParts = 3;
constexpr int kTabCopies = 8;
constexpr int kTabEntries = 256;
// shared memory in 16-byte words: the byte table, then the warps' sums
constexpr int kTcSmem = kTabEntries * kTabCopies > kTcRows * kTcN / 4 ? kTabEntries * kTabCopies
                                                                      : kTcRows * kTcN / 4;

// the A register of byte b in each code part (a fourth word pads the entry to 16 bytes)
__device__ __forceinline__ uint4 byte_parts(const float* code, uint32_t b) {
  float e, o;
  decode_byte(code, b, e, o);
  uint32_t p[kCodeParts];
  int4t::split3_bf16x2(e, o, p);
  return make_uint4(p[0], p[1], p[2], 0u);
}

// the table entry of byte s of w in this lane's copy (tab: copy lane % 8)
__device__ __forceinline__ uint4 lookup(const uint4* tab, uint32_t w, int s) {
  return tab[((w >> (8 * s)) & 0xFFu) * kTabCopies];
}

// B's register pair of x at k rows kr, kr + 1 of one row: f32 in two bf16 parts
// (the third is never multiplied), bf16 as it is
__device__ __forceinline__ void x_pair(const float* p, bool ok, uint32_t b[2]) {
  const float2 v = ok ? __ldg(reinterpret_cast<const float2*>(p)) : make_float2(0.f, 0.f);
  uint32_t s[3];
  int4t::split3_bf16x2(v.x, v.y, s);
  b[0] = s[0];
  b[1] = s[1];
}
__device__ __forceinline__ void x_pair(const __nv_bfloat16* p, bool ok, uint32_t b[2]) {
  b[0] = ok ? __ldg(reinterpret_cast<const unsigned int*>(p)) : 0u;
  b[1] = 0u;
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kTcThreads, 4) nf4_tc_kernel(
    const TX* __restrict__ x, int m, int k, const uint8_t* __restrict__ packed,
    const float* __restrict__ absmax, const float* __restrict__ code, int n,
    int blocks_per_split, float* __restrict__ part, TY* __restrict__ y) {
  constexpr int kXParts = sizeof(TX) == 4 ? 2 : 1;  // parts of x in B
  __shared__ uint4 smem[kTcSmem];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kTcRows;
  const int nw = blockIdx.y * kTcN + warp * kTcWarpN;  // the warp's first column
  const int split = blockIdx.z;
  const int nb = k / kQB;
  const int b0 = split * blocks_per_split;
  const int b1 = min(b0 + blocks_per_split, nb);

  for (int i = threadIdx.x; i < kTabEntries; i += kTcThreads) {
    const uint4 e = byte_parts(code, i);
#pragma unroll
    for (int c = 0; c < kTabCopies; ++c) smem[i * kTabCopies + c] = e;
  }
  __syncthreads();
  const uint4* tab = smem + lane % kTabCopies;

  const bool col_ok = nw + 8 * g < n;
  const uint8_t* pcol = packed + nw + 8 * g;
  const bool xrow_ok = m0 + g < m;
  const TX* xrow = x + static_cast<size_t>(xrow_ok ? m0 + g : 0) * k + 2 * t;

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
                                 pcol + static_cast<size_t>(b * kQB / 2 + st * kTcStep / 2 +
                                                            t + 4 * r) * n))
                           : make_uint2(0u, 0u);
#pragma unroll
    for (int j = 0; j < kTcTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) blk[j][e] = 0.f;  // a fresh sum for each quant block
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
        const uint4 e0 = lookup(tab, w0, s), e1 = lookup(tab, w0, s + 1);
        const uint4 e2 = lookup(tab, w1, s), e3 = lookup(tab, w1, s + 1);
        // A rows g, g + 8 at k 2t, 2t + 1 (e0, e1) and 2t + 8, 2t + 9 (e2, e3)
        const uint32_t a[kCodeParts][4] = {{e0.x, e1.x, e2.x, e3.x},
                                           {e0.y, e1.y, e2.y, e3.y},
                                           {e0.z, e1.z, e2.z, e3.z}};
#pragma unroll
        for (int e = 0; e < kCodeParts; ++e) mma_bf16(blk[j], a[e], bx[0][0], bx[1][0]);
        if (kXParts == 2) mma_bf16(blk[j], a[0], bx[0][1], bx[1][1]);
      }
    }
    // blk[j][e]: column nw + 8g + 2j + (e >> 1), x row m0 + 2t + (e & 1)
    if (col_ok) {
      const float* am = absmax_row(absmax, b, nb, n) + nw + 8 * g;
      const float4 lo = __ldg(reinterpret_cast<const float4*>(am));
      const float4 hi = __ldg(reinterpret_cast<const float4*>(am + 4));
      const float a8[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < kTcTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[j][e] = fmaf(blk[j][e], a8[2 * j + (e >> 1)], acc[j][e]);
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
      const float v = red[i * kTcWarpN + 32 * h + lane];
      if (col >= n) continue;
      if (gridDim.z == 1)
        store(y, static_cast<size_t>(m0 + i) * n + col, v);
      else
        part[(static_cast<size_t>(split) * m + m0 + i) * n + col] = v;
    }
}

// ---------------------------------------------------------------- m > 64
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

// the kernels the caller picks (ops/quant_kernels.nf4_path)
constexpr int kPathGemv = 0, kPathTc = 1, kPathFma = 2;

template <typename TX, typename TY>
cudaError_t launch(const void* xv, int m, int k, const uint8_t* packed, const float* absmax,
                   const float* code, int n, void* yv, float* part, int splits,
                   int blocks_per_split, int path, cudaStream_t stream) {
  const TX* x = static_cast<const TX*>(xv);
  TY* y = static_cast<TY*>(yv);
  if (path == kPathGemv) {
    if (m > 8) return cudaErrorInvalidValue;
    const dim3 grid((n + kGvN - 1) / kGvN, splits);
    auto kernel = m == 1   ? nf4_gemv_kernel<1, TX, TY>
                  : m == 2 ? nf4_gemv_kernel<2, TX, TY>
                  : m <= 4 ? nf4_gemv_kernel<4, TX, TY>
                           : nf4_gemv_kernel<8, TX, TY>;
    kernel<<<grid, kGvThreads, 0, stream>>>(x, m, k, packed, absmax, code, n, blocks_per_split,
                                            part, y);
  } else if (path == kPathTc) {
    const dim3 grid((m + kTcRows - 1) / kTcRows, (n + kTcN - 1) / kTcN, splits);
    nf4_tc_kernel<TX, TY><<<grid, kTcThreads, 0, stream>>>(x, m, k, packed, absmax, code, n,
                                                          blocks_per_split, part, y);
  } else if (path == kPathFma) {
    const dim3 grid((m + kGmM - 1) / kGmM, (n + kGmN - 1) / kGmN, splits);
    nf4_gemm_kernel<TX, TY><<<grid, kGmThreads, 0, stream>>>(x, m, k, packed, absmax, code, n,
                                                            blocks_per_split, part, y);
  } else {
    return cudaErrorInvalidValue;
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

// x: (m, k) row-major, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1), k % 64 == 0, 8-byte
// aligned; packed: (k/2, n) uint8, n % 8 == 0; absmax: (k/64, n) f32; code: (16,) f32;
// y: (m, n) f32 (y_bf16 = 0) or bf16 (y_bf16 = 1); part: (splits, m, n) f32
// scratch, unused (may be null) when splits == 1; path: 0 the gemv (m <= 8), 1 the
// tensor cores, 2 the FMA tile. Returns the cudaError_t of the launches.
int fm_nf4_matmul(const void* x, int x_bf16, int m, int k, const uint8_t* packed,
                  const float* absmax, const float* code, int n, void* y, int y_bf16,
                  float* part, int splits, int blocks_per_split, int path,
                  cudaStream_t stream) {
  cudaError_t err;
  if (x_bf16)
    err = y_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, m, k, packed, absmax, code, n, y,
                                                        part, splits, blocks_per_split, path,
                                                        stream)
                 : launch<__nv_bfloat16, float>(x, m, k, packed, absmax, code, n, y, part,
                                                splits, blocks_per_split, path, stream);
  else
    err = y_bf16 ? launch<float, __nv_bfloat16>(x, m, k, packed, absmax, code, n, y, part,
                                                splits, blocks_per_split, path, stream)
                 : launch<float, float>(x, m, k, packed, absmax, code, n, y, part, splits,
                                        blocks_per_split, path, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
