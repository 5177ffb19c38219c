// Shared pieces of the tiled int4 matmul kernels (int4_rank1_matmul.cu, K1, and
// int4_block_matmul.cu, K9).
//
// Weight layout (pack_int4_tiled): the int32 word at (gk_i, gn_i, r, lane) holds
// in nibble p the signed code of row gk_i*tk + r and column gn_i*1024 + p*128 +
// lane.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace int4t {

constexpr int kLanes = 128;   // int32 words per packed row of one 1024-column tile
constexpr int kTileN = 1024;

// All 8 signed nibbles of w as floats, q[p] = code of nibble p, without an
// int-to-float conversion (which issues at a quarter of the FMA rate and
// limited the decode kernel to about a third of the memory rate): w ^ 0x88888888
// turns each code c into c + 8 in [0, 15]; a byte permute places that in the
// low mantissa bits of 2^23 (0x4B000000), so the float is exactly 2^23 + c + 8.
__device__ __forceinline__ void nibbles8(uint32_t w, float q[8]) {
  const uint32_t b = w ^ 0x88888888u;
  const uint32_t lo = b & 0x0F0F0F0Fu;         // nibbles 0, 2, 4, 6 in bytes 0..3
  const uint32_t hi = (b >> 4) & 0x0F0F0F0Fu;  // nibbles 1, 3, 5, 7
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // result bytes: (byte j of lo or hi, 0, 0, 0x4B)
    q[2 * j] = __int_as_float(__byte_perm(lo, 0x4B000000u, 0x7440u | j)) - 8388616.f;
    q[2 * j + 1] = __int_as_float(__byte_perm(hi, 0x4B000000u, 0x7440u | j)) - 8388616.f;
  }
}

// the f32 pair (a, b) as three bf16 pairs that add up to it exactly: each part
// is the nearest bf16 of what the parts before it left, a remainder that is
// exact in f32 and holds 8 fewer significant bits (the last part holds the rest).
// The tensor-core kernels of K1 and K9 feed each part to its own mma, so that
// every product they sum is the f32 product of the reference.
__device__ __forceinline__ void split3_bf16x2(float a, float b, uint32_t parts[3]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    parts[s] = *reinterpret_cast<const uint32_t*>(&h);
    a -= hf.x;
    b -= hf.y;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Row krow of column tile gni. With one k tile (gk == 1, what pack_int4_tiled
// makes by default) the rows of a tile are contiguous and no division is
// needed; an integer division per load cost about a third of the decode
// kernel's time.
__device__ __forceinline__ const int32_t* word_ptr(const int32_t* w, int krow, int gni,
                                                   int gk, int gn, int tk) {
  if (gk == 1) return w + (static_cast<size_t>(gni) * tk + krow) * kLanes;
  const int gki = krow / tk;
  const int r = krow - gki * tk;
  return w + (static_cast<size_t>(gki * gn + gni) * tk + r) * kLanes;
}

// ---------------------------------------------------------------- 4 < m <= 64
// The tensor-core kernels of K1 and K9: mma.sync m16n8k16, bf16 in, f32 sums. The A
// operand is 16 output columns by 16 k of codes (16 neighbouring lanes of one nibble
// plane), the B operand 16 k by 8 rows of x; 4 warps a block.
constexpr int kTcWarps = 4;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTcUnitLanes = 16;                   // lanes of one A tile
constexpr int kTcUnits = kLanes / kTcUnitLanes;    // A tiles across a plane
constexpr int kTcStep = 16;                        // k rows of one mma
constexpr int kTcRows = 8;                         // rows of x in one B tile

// c + 8 in [0, 15] of each nibble of w (c its signed code), one a byte: nibbles
// 0, 2, 4, 6 in n[0], nibbles 1, 3, 5, 7 in n[1]
__device__ __forceinline__ void nibble_bytes(uint32_t w, uint32_t n[2]) {
  const uint32_t b = w ^ 0x88888888u;
  n[0] = b & 0x0F0F0F0Fu;
  n[1] = (b >> 4) & 0x0F0F0F0Fu;
}

// The codes of nibble plane p of two words as a bf16 pair (the first word's in the
// low half), from each word's nibble_bytes: a byte permute takes byte p / 2 of each
// into the low mantissa bits of bf16 128 (0x4300, whose ulp is 1), and subtracting
// 136 leaves c exactly. With p known at compile time (an unrolled loop) this is
// three instructions a pair, and no float of a code is kept.
__device__ __forceinline__ uint32_t code_pair_bf16x2(const uint32_t n0[2], const uint32_t n1[2],
                                                     int p) {
  const unsigned j = p / 2;
  const uint32_t v = (__byte_perm(n0[p % 2], n1[p % 2], j | ((4u + j) << 8)) & 0x00FF00FFu) |
                     0x43004300u;
  const __nv_bfloat162 c = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   __floats2bfloat162_rn(136.f, 136.f));
  return *reinterpret_cast<const uint32_t*>(&c);
}

// Writes a tensor-core block's sums of one k split to part. acc[p][j] is the mma
// fragment of thread (g, t) = (lane / 4, lane % 4): unit lane la + lstep * (j >> 1)
// of plane p (K1: la = g, lstep = 8; K9: la = 2g, lstep = 1) and x row
// m0 + 2t + (j & 1). The warps' sums are added in warp order in shared memory, so
// a repeat gives the same bits.
__device__ __forceinline__ void tc_store_part(const float (&acc)[8][4], int la, int lstep,
                                              float* __restrict__ part, int split, int m,
                                              int m0, int gni, int lane0, int n_pad) {
  __shared__ float red[kTcWarps][8][kTcUnitLanes][kTcRows];
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][p][la + lstep * (j >> 1)][2 * t + (j & 1)] = acc[p][j];
  __syncthreads();
  const int p = threadIdx.x / kTcUnitLanes, l = threadIdx.x % kTcUnitLanes;
  const int col = gni * kTileN + p * kLanes + lane0 + l;
  for (int i = 0; i < kTcRows && m0 + i < m; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int wi = 0; wi < kTcWarps; ++wi) sum += red[wi][p][l][i];
    part[(static_cast<size_t>(split) * m + m0 + i) * n_pad + col] = sum;
  }
}

}  // namespace int4t
