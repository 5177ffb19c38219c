// Blockwise tiled int4 matmul for Hopper (sm_90a):
//   y[m, n] = sum_k x[m, k] * (q[k, n] * (s[k / 64, n] * 0.125))
// or, without scales, the raw signed nibbles: y[m, n] = sum_k x[m, k] * q[k, n];
// accumulated in f32 and written in f32 or bf16.
//
// Replaces the Pallas TPU kernel int4_matmul_tiled (fastmax_tpu/ops/quant_pallas.py),
// which serves the blockwise int4 format ("preload_int4_block") with its scales
// and the tools/ experiments without them. The reference scales each weight
// before the product; the gemv and the FMA tile kernels do the same, and the
// tensor-core kernel scales each 64-row block's sum instead (below).
//
// Layout: the tiled words of K1 (int4_tiled.cuh) and scales s_t (gk, gn,
// tk/64, 1024), column = tile*1024 + plane*128 + lane. Rows >= k (true k) are
// skipped: the reference zero-pads x there. Columns >= n are not written.
//
// Bound: up to m = 64, 0.5 byte per weight plus 1/16 byte of scale, so
// device-memory bytes. At decode (m <= 4) the design is K1's: a GEMV that keeps
// 16-byte loads in flight (4-deep unroll) and splits k over enough blocks to
// cover all SMs; the scales are read per 64-row block through L1 (the 32 row
// threads of a block share them). For 4 < m <= 64 (a batcher's decode step)
// the product runs on the tensor cores, as K1's (int4_block_tc_kernel below).
// Above that, 64-row tiles decode each weight once into shared memory and reuse
// it for 64 rows: bound by f32 FMA issue. The caller picks the path
// (ops/quant_kernels.py). Split-k partial sums go to a scratch buffer and a
// second pass adds them in a fixed order, so a repeat gives the same bits.

#include "int4_tiled.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace int4t;

constexpr int kBlock = 64;  // rows of one scale block

// The scale row of weight row krow in column tile gni: (gk_i, gni, b, :).
__device__ __forceinline__ const float* scale_row(const float* s, int krow, int gni, int gk,
                                                  int gn, int tk) {
  const int gki = gk == 1 ? 0 : krow / tk;
  const int b = (krow - gki * tk) / kBlock;
  return s + (static_cast<size_t>(gki * gn + gni) * (tk / kBlock) + b) * kTileN;
}

// ---------------------------------------------------------------- m <= 4
// Block: 256 threads = 8 column threads (4 lanes each, one 16-byte load)
// x 32 row threads, covering 32 lanes (256 columns) of one tile and rows
// [k0, k1) of one k split, as K1.
constexpr int kGvThreads = 256;
constexpr int kGvRows = 32;
constexpr int kGvUnroll = 4;
constexpr int kGvStrips = kLanes / 32;

template <int MR, bool SCALED, typename TX>
__global__ void __launch_bounds__(kGvThreads) int4_block_gemv_kernel(
    const TX* __restrict__ x, int m, int k, const int32_t* __restrict__ w,
    const float* __restrict__ s, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
  __shared__ float red[kGvThreads / 32][MR][8][32];
  const int tid = threadIdx.x;
  const int tx = tid % 8, ty = tid / 8;
  const int warp = tid / 32, lane = tid % 32;
  const int gni = blockIdx.x / kGvStrips;
  const int lane0 = (blockIdx.x % kGvStrips) * 32;
  const int split = blockIdx.y;
  const int k0 = split * rows_per_split;
  const int k1 = min(k0 + rows_per_split, k);

  float acc[MR][8][4];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][p][c] = 0.f;

  for (int kb = k0 + ty; kb < k1; kb += kGvRows * kGvUnroll) {
    uint4 wv[kGvUnroll];
    float xv[kGvUnroll][MR];
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int krow = kb + u * kGvRows;
      if (krow < k1) {
        wv[u] = __ldg(reinterpret_cast<const uint4*>(word_ptr(w, krow, gni, gk, gn, tk) +
                                                     lane0 + tx * 4));
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xv[u][i] = i < m ? to_f32(x[static_cast<size_t>(i) * k + krow]) : 0.f;
      } else {
        wv[u] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < MR; ++i) xv[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGvUnroll; ++u) {
      const int krow = min(kb + u * kGvRows, k1 - 1);  // a row past k1 adds x = 0
      const float* srow = SCALED ? scale_row(s, krow, gni, gk, gn, tk) + lane0 + tx * 4
                                 : nullptr;
      const uint32_t words[4] = {wv[u].x, wv[u].y, wv[u].z, wv[u].w};
      float q[4][8];
#pragma unroll
      for (int c = 0; c < 4; ++c) nibbles8(words[c], q[c]);
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        float sc[4] = {1.f, 1.f, 1.f, 1.f};
        if (SCALED) {
          const float4 s4 = __ldg(reinterpret_cast<const float4*>(srow + p * kLanes));
          sc[0] = s4.x * 0.125f;
          sc[1] = s4.y * 0.125f;
          sc[2] = s4.z * 0.125f;
          sc[3] = s4.w * 0.125f;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float wq = SCALED ? q[c][p] * sc[c] : q[c][p];
#pragma unroll
          for (int i = 0; i < MR; ++i) acc[i][p][c] = fmaf(xv[u][i], wq, acc[i][p][c]);
        }
      }
    }
  }

  // the 4 row threads of a warp hold the same columns: lanes 8 and 16 apart
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float a = acc[i][p][c];
        a += __shfl_xor_sync(0xffffffffu, a, 8);
        a += __shfl_xor_sync(0xffffffffu, a, 16);
        acc[i][p][c] = a;
      }
  if (lane < 8) {
#pragma unroll
    for (int i = 0; i < MR; ++i)
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int c = 0; c < 4; ++c) red[warp][i][p][tx * 4 + c] = acc[i][p][c];
  }
  __syncthreads();
  const int p = tid / 32, l = tid % 32;
  const int col = gni * kTileN + p * kLanes + lane0 + l;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i < m) {
      float sum = 0.f;
#pragma unroll
      for (int wi = 0; wi < kGvThreads / 32; ++wi) sum += red[wi][i][p][l];
      part[(static_cast<size_t>(split) * m + i) * n_pad + col] = sum;
    }
  }
}

// ---------------------------------------------------------------- 4 < m <= 64
// K1's tensor-core kernel (int4_rank1_tc_kernel) with the scales of 64-row
// blocks: mma.sync m16n8k16, bf16 in, f32 sums. The A operand is 16 output
// columns by 16 k of codes (16 neighbouring lanes of one nibble plane; a code in
// [-8, 7] is exact in bf16); the B operand is 16 k by 8 rows of x. f32 x is split
// into three bf16 parts that add up to it exactly (split3_bf16x2), three mma a
// plane; bf16 x is exact in one, one mma a plane. So every product is the exact
// product of x and the code. code * scale is not exact in bf16, so the scale
// cannot go into A: each warp takes whole 64-row scale blocks (the 4 warps of a
// block interleave over the blocks of one k split), sums a block's four 16-row
// steps into a fresh f32 accumulator and adds that sum times s * 0.125 to its
// running sum, one fmaf a column and block. This differs from the reference's
// sum of scaled products only in rounding, and is no less exact than the FMA
// tile: the block's products are exact and its sum in f32 is scaled once.
// The A tile's 16 rows are the unit's 16 lanes in the order 0, 2, ..., 14, 1,
// 3, ..., 15 (A row g is lane 2g, row g + 8 lane 2g + 1), so the two words a
// thread needs of each of its k rows (2t, 2t+1, 2t+8, 2t+9) are neighbours: one
// 8-byte load each. It decodes them straight into bf16 pairs
// (code_pair_bf16x2), not into floats: the kernel is bound by how many loads
// are in flight, so registers, which set the blocks an SM holds, matter more
// than loading a whole scale block's words at once. Rows >= k of a step
// that runs past k get x = 0 in B (the reference zero-pads x there; their words
// are in the array and hold any bits); x is never read past column k. The warps'
// sums are added in warp order in shared memory.
// grid: (gn * 8 units of 16 lanes, splits, m chunks of 8 rows); tk % 16 == 0,
// rows_per_split % 64 == 0 (no scale block straddles two splits), and with
// scales tk % 64 == 0.
constexpr int kTcSteps = kBlock / kTcStep;  // steps of one scale block

template <bool SCALED, typename TX>
__global__ void __launch_bounds__(kTcThreads) int4_block_tc_kernel(
    const TX* __restrict__ x, int m, int k, const int32_t* __restrict__ w,
    const float* __restrict__ s, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
  constexpr int kParts = sizeof(TX) == 4 ? 3 : 1;  // bf16 parts of x in B
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int gni = blockIdx.x / kTcUnits;
  const int lane0 = (blockIdx.x % kTcUnits) * kTcUnitLanes;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * kTcRows;
  const int k0 = split * rows_per_split;
  const int k1 = min(k0 + rows_per_split, k);
  const bool xrow_ok = m0 + g < m;
  const TX* xrow = x + static_cast<size_t>(xrow_ok ? m0 + g : 0) * k;

  float acc[8][4], blk[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  // k rows of this thread's fragments within a step: 2t, 2t+1, 2t+8, 2t+9
  const int rofs[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
  for (int kb = k0 + warp * kBlock; kb < k1; kb += kTcWarps * kBlock) {
#pragma unroll
    for (int p = 0; p < 8; ++p)
#pragma unroll
      for (int j = 0; j < 4; ++j) blk[p][j] = 0.f;  // a fresh sum for each scale block
#pragma unroll
    for (int st = 0; st < kTcSteps; ++st) {
      const int ks = kb + st * kTcStep;
      if (ks >= k1) break;
      uint32_t n[2][4][2];  // nibble_bytes of the 8 words of this thread's A fragments
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // A rows g, g + 8: lanes 2g, 2g + 1 of the unit
        const uint2 wv = __ldg(reinterpret_cast<const uint2*>(
            word_ptr(w, ks + rofs[r], gni, gk, gn, tk) + lane0 + 2 * g));
        nibble_bytes(wv.x, n[0][r]);
        nibble_bytes(wv.y, n[1][r]);
      }
      float xv[4];  // B column g: x of row m0 + g at k rows ks + rofs[r]
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int kr = ks + rofs[r];
        const float val = to_f32(xrow[min(kr, k - 1)]);
        xv[r] = xrow_ok && kr < k ? val : 0.f;
      }
      uint32_t b[2][3];  // (k 2t, 2t+1), (k 2t+8, 2t+9): kParts bf16 parts each
      if (kParts == 3) {
        split3_bf16x2(xv[0], xv[1], b[0]);
        split3_bf16x2(xv[2], xv[3], b[1]);
      } else {  // bf16 x: exact in one part
        b[0][0] = pack_bf16x2(xv[0], xv[1]);
        b[1][0] = pack_bf16x2(xv[2], xv[3]);
      }
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint32_t a[4] = {code_pair_bf16x2(n[0][0], n[0][1], p),   // column g, k 2t, 2t+1
                               code_pair_bf16x2(n[1][0], n[1][1], p),   // column g+8
                               code_pair_bf16x2(n[0][2], n[0][3], p),   // column g, k 2t+8, 2t+9
                               code_pair_bf16x2(n[1][2], n[1][3], p)};  // column g+8
#pragma unroll
        for (int e = 0; e < kParts; ++e) mma_bf16(blk[p], a, b[0][e], b[1][e]);
      }
    }
    // blk[p][j]: lane lane0 + 2g + (j >> 1) of plane p, x row m0 + 2t + (j & 1)
    if (SCALED) {
      const float* srow = scale_row(s, kb, gni, gk, gn, tk) + lane0 + 2 * g;
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float sc = __ldg(srow + p * kLanes + h) * 0.125f;
          acc[p][2 * h] = fmaf(blk[p][2 * h], sc, acc[p][2 * h]);
          acc[p][2 * h + 1] = fmaf(blk[p][2 * h + 1], sc, acc[p][2 * h + 1]);
        }
    } else {
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[p][j] += blk[p][j];
    }
  }

  tc_store_part(acc, 2 * g, 1, part, split, m, m0, gni, lane0, n_pad);
}

// ---------------------------------------------------------------- m > 64
// Block tile: 64 rows x 128 columns (16 lanes x 8 planes) x 32 k per step, as
// K1; the 32 rows of a step lie in one scale block.
constexpr int kGmThreads = 256;
constexpr int kGmM = 64;
constexpr int kGmLanes = 16;
constexpr int kGmN = kGmLanes * 8;
constexpr int kGmK = 32;

template <bool SCALED, typename TX>
__global__ void __launch_bounds__(kGmThreads) int4_block_gemm_kernel(
    const TX* __restrict__ x, int m, int k, const int32_t* __restrict__ w,
    const float* __restrict__ s, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
  __shared__ float xs[kGmK][kGmM + 1];
  __shared__ float ws[kGmK][kGmN + 16];
  const int tid = threadIdx.x;
  const int ty = tid / kGmLanes, tx = tid % kGmLanes;
  const int m0 = blockIdx.x * kGmM;
  const int gni = blockIdx.y / (kLanes / kGmLanes);
  const int lane0 = (blockIdx.y % (kLanes / kGmLanes)) * kGmLanes;
  const int split = blockIdx.z;
  const int k0 = split * rows_per_split;
  const int k1 = min(k0 + rows_per_split, k);

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int kt = k0; kt < k1; kt += kGmK) {
    {  // x tile: 32 neighbouring threads read 32 neighbouring k of one row
      const int kk = tid % kGmK;
      const int kr = kt + kk;
#pragma unroll
      for (int u = 0; u < kGmM / (kGmThreads / kGmK); ++u) {
        const int row = tid / kGmK + u * (kGmThreads / kGmK);
        const int gm = m0 + row;
        xs[kk][row] = (gm < m && kr < k1) ? to_f32(x[static_cast<size_t>(gm) * k + kr]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kGmK / (kGmThreads / kGmLanes); ++u) {  // weight tile
      const int kk = tid / kGmLanes + u * (kGmThreads / kGmLanes);
      const int kr = kt + kk;
      uint32_t word = 0u;
      if (kr < k1) word = __ldg(word_ptr(w, kr, gni, gk, gn, tk) + lane0 + tx);
      float q[8];
      nibbles8(word, q);
      const float* srow = SCALED ? scale_row(s, min(kr, k1 - 1), gni, gk, gn, tk) + lane0 + tx
                                 : nullptr;
#pragma unroll
      for (int p = 0; p < 8; ++p)
        ws[kk][p * kGmLanes + tx] = SCALED ? q[p] * (__ldg(srow + p * kLanes) * 0.125f) : q[p];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kGmK; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ws[kk][j * kGmLanes + tx];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row < m) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = gni * kTileN + j * kLanes + lane0 + tx;
        part[(static_cast<size_t>(split) * m + row) * n_pad + col] = acc[i][j];
      }
    }
  }
}

// Adds the split partials in split order.
template <typename TY>
__global__ void int4_block_reduce_kernel(const float* __restrict__ part, int splits, int m,
                                         int n_pad, int n, TY* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m) * n) return;
  const int row = static_cast<int>(idx / n);
  const int col = static_cast<int>(idx % n);
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[(static_cast<size_t>(sp) * m + row) * n_pad + col];
  y[idx] = from_f32<TY>(sum);
}

template <bool SCALED, typename TX>
cudaError_t launch_partials(const TX* x, int m, int k, const int32_t* w, const float* s, int gk,
                            int gn, int tk, float* part, int splits, int rows_per_split, int tc,
                            cudaStream_t stream) {
  const int n_pad = gn * kTileN;
  if (tc) {
    if (m <= 4 || tk % kTcStep || rows_per_split % kBlock || (SCALED && tk % kBlock))
      return cudaErrorInvalidValue;
    const dim3 grid(gn * kTcUnits, splits, (m + kTcRows - 1) / kTcRows);
    int4_block_tc_kernel<SCALED, TX><<<grid, kTcThreads, 0, stream>>>(
        x, m, k, w, s, gk, gn, tk, rows_per_split, part, n_pad);
  } else if (m <= 4) {
    const dim3 grid(gn * kGvStrips, splits);
    auto kernel = m == 1   ? int4_block_gemv_kernel<1, SCALED, TX>
                  : m == 2 ? int4_block_gemv_kernel<2, SCALED, TX>
                           : int4_block_gemv_kernel<4, SCALED, TX>;
    kernel<<<grid, kGvThreads, 0, stream>>>(x, m, k, w, s, gk, gn, tk, rows_per_split, part,
                                            n_pad);
  } else {
    const dim3 grid((m + kGmM - 1) / kGmM, gn * (kLanes / kGmLanes), splits);
    int4_block_gemm_kernel<SCALED, TX><<<grid, kGmThreads, 0, stream>>>(
        x, m, k, w, s, gk, gn, tk, rows_per_split, part, n_pad);
  }
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch(const void* x, int m, int k, const int32_t* w, const float* s, int gk, int gn,
                   int tk, int n, void* y, int y_bf16, float* part, int splits,
                   int rows_per_split, int tc, cudaStream_t stream) {
  const TX* xt = static_cast<const TX*>(x);
  cudaError_t err =
      s != nullptr
          ? launch_partials<true>(xt, m, k, w, s, gk, gn, tk, part, splits, rows_per_split, tc,
                                  stream)
          : launch_partials<false>(xt, m, k, w, s, gk, gn, tk, part, splits, rows_per_split, tc,
                                   stream);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(m) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  if (y_bf16)
    int4_block_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, stream>>>(
        part, splits, m, gn * kTileN, n, static_cast<__nv_bfloat16*>(y));
  else
    int4_block_reduce_kernel<float><<<blocks, threads, 0, stream>>>(
        part, splits, m, gn * kTileN, n, static_cast<float*>(y));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, k) row-major, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); w: (gk, gn, tk,
// 128) int32 words; s: (gk, gn, tk/64, 1024) f32 scales, or null for the raw
// nibbles; y: (m, n) f32 (y_bf16 = 0) or bf16 (y_bf16 = 1), n <= gn*1024;
// part: (splits, m, gn*1024) f32 scratch; tc = 1 takes the tensor-core kernel
// (4 < m, tk % 16 == 0, rows_per_split % 64 == 0, with scales tk % 64 == 0), tc =
// 0 the gemv kernel for m <= 4 and the FMA tile kernel above. Returns the
// cudaError_t of the launches.
int fm_int4_block_matmul(const void* x, int x_bf16, int m, int k, const int32_t* w,
                         const float* s, int gk, int gn, int tk, int n, void* y, int y_bf16,
                         float* part, int splits, int rows_per_split, int tc,
                         cudaStream_t stream) {
  if (x_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(x, m, k, w, s, gk, gn, tk, n, y, y_bf16, part,
                                                  splits, rows_per_split, tc, stream));
  return static_cast<int>(launch<float>(x, m, k, w, s, gk, gn, tk, n, y, y_bf16, part, splits,
                                        rows_per_split, tc, stream));
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
