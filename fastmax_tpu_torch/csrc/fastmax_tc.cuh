// Tensor-core pieces of the fastmax scan kernels (fastmax_fwd.cu's fastmax_fwd_tc_kernel and
// fastmax_bwd.cu's fastmax_bwd_tc_kernel).
//
// Every product is mma.sync m16n8k16 on bfloat16 operands with float32 sums: a warp's 16
// rows from row0 and NT n8 tiles of columns; acc[nt][e] holds row row0 + g + 8 (e / 2),
// column col0 + 8 nt + 2 t + (e % 2), with g = lane / 4 and t = lane % 4.
//
// Float32 operands are split into three bfloat16 parts that add up to them exactly (8 + 8 +
// 8 bits of float32's 24), and the six products of parts down to 2^-16 of the whole are
// summed (hi*hi, hi*mid, mid*hi, hi*lo, lo*hi, mid*mid; the three dropped ones are 2^-24
// and below): each product to about 2^-23 of its size, as float32 gives it, where one TF32
// product keeps 2^-11. Six bfloat16 products cost what three TF32 products do. The tensor
// core's own sums do not round to nearest, and taken straight into a long running sum
// they put dq over float32's gate, so each k step's six products go into a fresh
// accumulator that is then added to the running sum in float32. The pair operands of
// bfloat16 inputs are bfloat16 values already (rounded where the reference rounds them),
// so their products are one exact product each.
//
// Operands come two ways: as functors returning float32 values (mma_f32, CTA 0's products;
// frag_values, the pair features formed on the fly), or as bfloat16 planes of a tile in
// shared memory, the parts (float32) or the values (bfloat16), swizzled, whose fragments
// are one ldmatrix.x4 a plane (mma_planes). Sums are float32 in a fixed order, so results
// repeat bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fastmax_common.cuh"

// the tensor-core kernels' dynamic shared memory; their tiles are fixed offsets into it, so
// every access to them compiles to a shared-memory instruction
extern __shared__ __align__(16) float fm_tc_smem[];

namespace fmtc {

constexpr int kThreads = 256;
constexpr int kLDA = 68;  // row stride of an mma operand tile
constexpr int kLDF = 65;  // row stride of a tile whose columns are read at random
constexpr uint32_t kOne = 0x3F80u;  // bfloat16 1.0

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bfloat16 values (exact where the operands are bfloat16 values), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

// (x0, x1) = hi + mid + lo exactly, each part two bfloat16 values
struct Parts {
  uint32_t hi, mid, lo;
};
__device__ __forceinline__ Parts split3(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  return {bits(h), bits(m), bits(__floats2bfloat162_rn(r0 - mf.x, r1 - mf.y))};
}

// d += a b for one m16n8k16 step: float32 parts (the six products of split3's parts down to
// 2^-16, small first, in a fresh accumulator), or one exact bfloat16 product
template <int P>
__device__ __forceinline__ void mma_parts(float (&d)[4], const uint32_t (&a)[P][4],
                                          const uint32_t (&b)[P][4], int h) {
  if constexpr (P == 3) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    mma16816(part, a[2], b[0][2 * h], b[0][2 * h + 1]);
    mma16816(part, a[0], b[2][2 * h], b[2][2 * h + 1]);
    mma16816(part, a[1], b[1][2 * h], b[1][2 * h + 1]);
    mma16816(part, a[1], b[0][2 * h], b[0][2 * h + 1]);
    mma16816(part, a[0], b[1][2 * h], b[1][2 * h + 1]);
    mma16816(part, a[0], b[0][2 * h], b[0][2 * h + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += part[e];
  } else {
    mma16816(d, a[0], b[0][2 * h], b[0][2 * h + 1]);
  }
}

// d += the float32 product of split operands a and b (mma_parts' six products)
__device__ __forceinline__ void mma_split(float (&d)[4], const Parts (&a)[4], const Parts& b0,
                                          const Parts& b1) {
  const uint32_t ap[3][4] = {{a[0].hi, a[1].hi, a[2].hi, a[3].hi},
                             {a[0].mid, a[1].mid, a[2].mid, a[3].mid},
                             {a[0].lo, a[1].lo, a[2].lo, a[3].lo}};
  const uint32_t bp[3][4] = {
      {b0.hi, b1.hi, 0u, 0u}, {b0.mid, b1.mid, 0u, 0u}, {b0.lo, b1.lo, 0u, 0u}};
  mma_parts<3>(d, ap, bp, 0);
}

template <int NT> __device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// acc += A B over k < kdim (a multiple of 16), float32 operands from functors, split
template <int NT, typename FA, typename FB>
__device__ __forceinline__ void mma_f32(float (&acc)[NT][4], int row0, int col0, FA A, FB B,
                                        int kdim) {
  const int g = lane_g(), t = lane_t();
  const int r0 = row0 + g, r1 = r0 + 8;
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    const int ka = k0 + 2 * t, kb = ka + 8;
    const Parts a[4] = {split3(A(r0, ka), A(r0, ka + 1)), split3(A(r1, ka), A(r1, ka + 1)),
                        split3(A(r0, kb), A(r0, kb + 1)), split3(A(r1, kb), A(r1, kb + 1))};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = col0 + 8 * nt + g;
      mma_split(acc[nt], a, split3(B(ka, n), B(ka + 1, n)), split3(B(kb, n), B(kb + 1, n)));
    }
  }
}

// The folds' products in the input's type: an A fragment of eight values (prep, once a
// 16-pair step: the parts of float32 values, or the bfloat16 values) times a 0/1 expansion
// (expand, once an 8-column tile), every product exact.
template <typename T> struct FoldMma;
template <> struct FoldMma<float> {
  struct Frag {
    uint32_t hi[4], mid[4], lo[4];
  };
  __device__ __forceinline__ static Frag prep(const float (&a)[8]) {
    Frag f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const Parts p = split3(a[2 * i], a[2 * i + 1]);
      f.hi[i] = p.hi;
      f.mid[i] = p.mid;
      f.lo[i] = p.lo;
    }
    return f;
  }
  __device__ __forceinline__ static void expand(float (&d)[4], const Frag& f, uint32_t b0,
                                                uint32_t b1) {
    mma16816(d, f.lo, b0, b1);
    mma16816(d, f.mid, b0, b1);
    mma16816(d, f.hi, b0, b1);
  }
};
template <> struct FoldMma<__nv_bfloat16> {
  struct Frag {
    uint32_t v[4];
  };
  __device__ __forceinline__ static Frag prep(const float (&a)[8]) {
    return {{pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]), pack_bf16(a[4], a[5]),
             pack_bf16(a[6], a[7])}};
  }
  __device__ __forceinline__ static void expand(float (&d)[4], const Frag& f, uint32_t b0,
                                                uint32_t b1) {
    mma16816(d, f.v, b0, b1);
  }
};

// ---- bfloat16 planes: a tile of rows x 64 values kept as Planes<T>::kCount bfloat16 tiles
// (float32: the three parts of split3, hi first; bfloat16: the values), each swizzled so
// that the 8 rows an ldmatrix phase reads hit 8 distinct 16-byte columns.
template <typename T> struct Planes;
template <> struct Planes<float> {
  static constexpr int kCount = 3;
};
template <> struct Planes<__nv_bfloat16> {
  static constexpr int kCount = 1;
};

// element (r, c) of a swizzled plane of 64 columns
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// (x0, x1) at (r, c), (r, c + 1) of each plane (c even); planes `elems` apart
template <typename T>
__device__ __forceinline__ void put_planes(__nv_bfloat16* pl, int elems, int r, int c, float x0,
                                           float x1) {
  uint32_t* at = reinterpret_cast<uint32_t*>(pl + swz(r, c));
  if constexpr (Planes<T>::kCount == 3) {
    const Parts p = split3(x0, x1);
    at[0] = p.hi;
    at[elems / 2] = p.mid;
    at[elems] = p.lo;
  } else {
    at[0] = pack_bf16(x0, x1);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p, bool trans) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// the A fragment (rows m0 .., k0 ..) of a plane stored [m][k]
__device__ __forceinline__ void ldsm_a(uint32_t (&a)[4], const __nv_bfloat16* pl, int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, pl + swz(m0 + (l & 15), k0 + 8 * (l >> 4)), false);
}
// the B fragments of columns n0 .. n0 + 15 (b[0], b[1]: n0 ..; b[2], b[3]: n0 + 8 ..), k0 ..,
// of a plane stored [n][k] (trans = false) or [k][n] (trans = true)
__device__ __forceinline__ void ldsm_b(uint32_t (&b)[4], const __nv_bfloat16* pl, int k0, int n0,
                                       bool trans) {
  const int l = threadIdx.x & 31;
  if (trans)
    ldsm_x4(b, pl + swz(k0 + (l & 7) + 8 * ((l >> 3) & 1), n0 + 8 * (l >> 4)), true);
  else
    ldsm_x4(b, pl + swz(n0 + (l & 7) + 8 * (l >> 4), k0 + 8 * ((l >> 3) & 1)), false);
}

// A fragments from the A operand's values: the parts (float32) or the bfloat16 values
template <typename T, typename FA>
__device__ __forceinline__ void frag_values(uint32_t (&a)[Planes<T>::kCount][4], FA A, int r0,
                                            int ka) {
  const int r1 = r0 + 8, kb = ka + 8;
  const float v[8] = {A(r0, ka), A(r0, ka + 1), A(r1, ka), A(r1, ka + 1),
                      A(r0, kb), A(r0, kb + 1), A(r1, kb), A(r1, kb + 1)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (Planes<T>::kCount == 3) {
      const Parts p = split3(v[2 * i], v[2 * i + 1]);
      a[0][i] = p.hi;
      a[1][i] = p.mid;
      a[2][i] = p.lo;
    } else {
      a[0][i] = pack_bf16(v[2 * i], v[2 * i + 1]);
    }
  }
}

// acc += A B in the input's type for a warp's 16 rows from row0 and NT n8 tiles from n0,
// over k < kdim (a multiple of 16). A: loadA(k0, a) fills the A fragments of step k0; B: the
// planes of a tile (planes `elems` apart), stored [n][k] or, kTrans, [k][n].
template <typename T, int NT, bool kTrans, typename LoadA>
__device__ __forceinline__ void mma_planes(float (&acc)[NT][4], LoadA loadA,
                                           const __nv_bfloat16* bpl, int elems, int n0, int kdim) {
  constexpr int P = Planes<T>::kCount;
  for (int k0 = 0; k0 < kdim; k0 += 16) {
    uint32_t a[P][4];
    loadA(k0, a);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      uint32_t b[P][4];
#pragma unroll
      for (int pl = 0; pl < P; ++pl) ldsm_b(b[pl], bpl + pl * elems, k0, n0 + 16 * np, kTrans);
      mma_parts<P>(acc[2 * np], a, b, 0);
      mma_parts<P>(acc[2 * np + 1], a, b, 1);
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}


// ---- the layout and pieces both kernels' CTAs share

constexpr int kR = 64;                         // rows of a tile
constexpr int kMaxC = 128;                     // chunk rows a pair CTA holds
constexpr int kPT = 64;                        // pairs a tile
constexpr int kTablePairs = 2112;              // 2080 pairs at D = 64, to whole tiles
constexpr uint16_t kNoPair = 64 | (64 << 8);   // a pair of the zero pad column
constexpr int kTileA = kR * kLDA;

// a warp's part of a 64 x 64 output: rows 16 (w % 4), columns 32 (w / 4), four n8 tiles
__device__ __forceinline__ int quad_row0() { return 16 * ((threadIdx.x >> 5) & 3); }
__device__ __forceinline__ int quad_col0() { return 32 * (threadIdx.x >> 7); }
// the (row, column) of acc[nt][e] for a warp at (row0, col0)
__device__ __forceinline__ int acc_row(int row0, int e) { return row0 + lane_g() + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int col0, int nt, int e) {
  return col0 + 8 * nt + 2 * lane_t() + (e & 1);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// rows [0, rows) of a (., d) row-major matrix -> a tile of row stride LD, zero at c >= d;
// rows <= kMaxC, and every load is issued before the first store
template <int LD, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int rows, int d) {
  constexpr int kQuads = (LD + 3) / 4;
  constexpr int kSteps = (kMaxC * kQuads + kThreads - 1) / kThreads;
  float4 x[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int idx = threadIdx.x + s * kThreads, r = idx / kQuads, c = (idx % kQuads) * 4;
    x[s] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < d) x[s] = load4(src + static_cast<size_t>(r) * d + c);
  }
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int idx = threadIdx.x + s * kThreads, r = idx / kQuads, c = (idx % kQuads) * 4;
    if (r >= rows) break;
    float* out = dst + r * LD + c;
    out[0] = x[s].x;
    if (c + 1 < LD) out[1] = x[s].y;
    if (c + 2 < LD) out[2] = x[s].z;
    if (c + 3 < LD) out[3] = x[s].w;
  }
}

// operand views of a tile of row stride LD: at(t)(r, c) = t[r][c], tr(t)(r, c) = t[c][r]
template <int LD> __device__ __forceinline__ auto at(const float* t) {
  return [t](int r, int c) { return t[r * LD + c]; };
}
template <int LD> __device__ __forceinline__ auto tr(const float* t) {
  return [t](int r, int c) { return t[c * LD + r]; };
}

// acc += A B for a 64 x 64 output, float32 by split operands
template <typename FA, typename FB>
__device__ __forceinline__ void mma64(float (&acc)[4][4], FA A, FB B, int kdim) {
  mma_f32<4>(acc, quad_row0(), quad_col0(), A, B, kdim);
}

// A pair CTA's shared state: the S3/dS3 ring (f32, cp.async's target), the planes of v,
// of rnd(df) (the backward's) and of the step's tile (Planes: the parts of float32 values,
// or the bfloat16 values; swizzled rows of 64), q and k in f32 (for the pair features and
// the folds) and the pair table (p -> m | j << 8, kNoPair past the pairs). Warp w takes
// rows 16 w .. 16 w + 15 of the held rows in the products whose rows are the chunk's (f2;
// dq2, dk2, dv and the folds), and a 16 x 32 part of the tile in those whose rows are
// pairs (the S3 update or rewind, the dS3 update).
struct PairSmem {
  static constexpr int kRowPlane = kMaxC * 64, kTilePlane = kPT * 64;  // elements a plane
  static constexpr int kQ = 2 * kPT * kLDA, kK = kQ + kMaxC * kLDF, kPlanes = kK + kMaxC * kLDF;
  static __device__ __forceinline__ float* ring(int i) { return fm_tc_smem + i * kPT * kLDA; }
  static __device__ __forceinline__ float* qs() { return fm_tc_smem + kQ; }
  static __device__ __forceinline__ float* ks() { return fm_tc_smem + kK; }
  static __device__ __forceinline__ __nv_bfloat16* vpl() {
    return reinterpret_cast<__nv_bfloat16*>(fm_tc_smem + kPlanes);
  }
  static __device__ __forceinline__ __nv_bfloat16* dfpl() { return vpl() + 3 * kRowPlane; }
  static __device__ __forceinline__ __nv_bfloat16* spl() { return dfpl() + 3 * kRowPlane; }
  static __device__ __forceinline__ uint16_t* pmj() {
    return reinterpret_cast<uint16_t*>(spl() + 3 * kTilePlane);
  }
};
constexpr size_t kPairBytes = sizeof(float) * PairSmem::kPlanes +
                              sizeof(__nv_bfloat16) * 3 * (2 * PairSmem::kRowPlane +
                                                           PairSmem::kTilePlane) +
                              sizeof(uint16_t) * kTablePairs;

// A fragments of a plane tile stored [m][k], rows row0 ..
template <typename T>
__device__ __forceinline__ auto from_planes(const __nv_bfloat16* pl, int elems, int row0) {
  return [pl, elems, row0](int k0, uint32_t (&a)[Planes<T>::kCount][4]) {
#pragma unroll
    for (int i = 0; i < Planes<T>::kCount; ++i) ldsm_a(a[i], pl + i * elems, row0, k0);
  };
}
// A fragments of values A(r, k), rows row0 ..
template <typename T, typename FA>
__device__ __forceinline__ auto from_values(FA A, int row0) {
  return [A, row0](int k0, uint32_t (&a)[Planes<T>::kCount][4]) {
    frag_values<T>(a, A, row0 + lane_g(), k0 + 2 * lane_t());
  };
}

// the f32 tile sb (kPT x kLDA) -> the tile planes; ends synchronised
template <typename T>
__device__ __forceinline__ void tile_planes(const float* sb) {
  for (int idx = threadIdx.x; idx < kPT * 32; idx += kThreads) {
    const int r = idx / 32, c = (idx % 32) * 2;
    put_planes<T>(PairSmem::spl(), PairSmem::kTilePlane, r, c, sb[r * kLDA + c],
                  sb[r * kLDA + c + 1]);
  }
  __syncthreads();
}

// a pair CTA's start: the pair table, and the ring zeroed (cp.async fills columns < d only)
__device__ __forceinline__ void pair_setup(int d) {
  uint16_t* pmj = PairSmem::pmj();
  for (int p = threadIdx.x; p < kTablePairs; p += kThreads) pmj[p] = kNoPair;
  __syncthreads();
  for (int idx = threadIdx.x; idx < d * d; idx += kThreads) {
    const int m = idx / d, j = idx % d;
    if (j >= m) pmj[m * d - m * (m - 1) / 2 + (j - m)] = static_cast<uint16_t>(m | (j << 8));
  }
  for (int idx = threadIdx.x; idx < 2 * kPT * kLDA; idx += kThreads) fm_tc_smem[idx] = 0.f;
}

// the ring: stage the tile of pairs p0 .. p0 + kPT of a (pairs, d) state into dst, pairs at or
// past hi as zeros, one cp.async group
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int p0, int lo, int hi,
                                           int d) {
  const int quads = d / 4;
  for (int idx = threadIdx.x; idx < kPT * quads; idx += kThreads) {
    const int pp = idx / quads, c = (idx % quads) * 4, p = p0 + pp;
    const bool ok = p < hi;
    cp_async16(dst + pp * kLDA + c, src + static_cast<size_t>(ok ? p : lo) * d + c, ok);
  }
  cp_async_commit();
}

// An S3 tile takes the held rows: S3 += sign K2^T v, with K2^T[p, r] = rnd(k_m k_j) formed
// on the fly (sign 1: the forward's update; -1: the backward's rewind), in the f32 tile
// and in device memory. Ends synchronised.
template <typename T>
__device__ __forceinline__ void s3_update(float* sb, float* s3, int p0, int np, int d, int rows,
                                          float sign) {
  const uint16_t* pmj = PairSmem::pmj() + p0;
  const float* ks = PairSmem::ks();
  const int row0 = quad_row0(), col0 = quad_col0();
  const int pa = row0 + lane_g(), code0 = pmj[pa], code1 = pmj[pa + 8];
  auto k2t = [ks, pa, code0, code1](int pp, int r) {  // K2^T[pp, r] = rnd(k_m k_j)
    const int code = pp == pa ? code0 : code1;
    return fm::rnd<T>(ks[r * kLDF + (code & 255)] * ks[r * kLDF + (code >> 8)]);
  };
  float acc[4][4];
  zero_acc(acc);
  mma_planes<T, 4, true>(acc, from_values<T>(k2t, row0), PairSmem::vpl(), PairSmem::kRowPlane,
                         col0, rows);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = acc_row(row0, e), c = acc_col(col0, nt, e), i = pp * kLDA + c;
      if (pp < np && c < d) {
        const float taken = sb[i] + sign * acc[nt][e];
        sb[i] = taken;
        s3[static_cast<size_t>(p0 + pp) * d + c] = taken;
      }
    }
  __syncthreads();
}

}  // namespace fmtc
