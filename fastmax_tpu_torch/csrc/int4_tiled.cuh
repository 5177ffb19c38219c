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

}  // namespace int4t
