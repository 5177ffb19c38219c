// Rank-1 tiled int4 matmul for Hopper (sm_90a):
//   y[m, n] = (sum_k x[m, k] * u[k] * q[k, n]) * v[n] / 8
// accumulated in f32 and returned in x's dtype (f32 or bf16).
//
// Replaces the Pallas TPU kernels int4_matmul_rank1_tiled_stacked and
// int4_matmul_rank1_tiled (fastmax_tpu/ops/quant_pallas.py). One kernel
// serves both: the caller passes a pointer to one layer of the (L, gk, gn,
// tk, 128) stack, so the stacked entry needs no slice copy and the
// per-layer entry is the same call with layer stride 0.
//
// Weight layout (pack_int4_tiled): the int32 word at (gk_i, gn_i, r, lane)
// holds in nibble p the signed code of row gk_i*tk + r and column
// gn_i*1024 + p*128 + lane. Rows >= k (true k) are skipped: the reference
// zero-pads x and u there, so they add nothing. Columns >= n are not written.
//
// Bound: at decode (m <= 4) the kernel streams 0.5 byte per weight and is
// bound by device-memory bytes; its design keeps many 16-byte loads in
// flight (4-deep unroll) and splits k over enough blocks to cover all SMs
// (the TPU grid of one program per 1024 columns would give 4-22 blocks at
// Llama-2-7B widths). For 4 < m <= 64 (a batcher's decode step, a short
// prefill) it is still bound by the bytes, and the product runs on the
// tensor cores (int4_rank1_tc_kernel below). Above that (prefill) it is
// bound by f32 FMA issue: each k tile is decoded once into shared memory and
// reused by 64 rows. The caller picks the path (ops/quant_kernels.py).
// Split-k partial sums go to a scratch buffer and a second pass adds them in
// a fixed order (no float atomics), so results are the same on every run.

#include "int4_tiled.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace int4t;

// ---------------------------------------------------------------- m <= 4
// Block: 256 threads = 8 column threads (4 lanes each, one 16-byte load)
// x 32 row threads. It covers 32 lanes (256 output columns: 8 planes x 32
// lanes) of one 1024-column tile and rows [k0, k1) of one k split.
constexpr int kGvThreads = 256;
constexpr int kGvRows = 32;
constexpr int kGvUnroll = 4;
constexpr int kGvStrips = kLanes / 32;  // 32-lane strips per tile

template <int MR, typename TX>
__global__ void __launch_bounds__(kGvThreads) int4_gemv_kernel(
    const TX* __restrict__ x, int m, int k, const float* __restrict__ u,
    const int32_t* __restrict__ w, int gk, int gn, int tk, int rows_per_split,
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
    for (int s = 0; s < kGvUnroll; ++s) {
      const int krow = kb + s * kGvRows;
      if (krow < k1) {
        wv[s] = __ldg(reinterpret_cast<const uint4*>(word_ptr(w, krow, gni, gk, gn, tk) +
                                                     lane0 + tx * 4));
        const float uu = __ldg(u + krow);
#pragma unroll
        for (int i = 0; i < MR; ++i)
          xv[s][i] = i < m ? to_f32(x[static_cast<size_t>(i) * k + krow]) * uu : 0.f;
      } else {
        wv[s] = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
        for (int i = 0; i < MR; ++i) xv[s][i] = 0.f;
      }
    }
#pragma unroll
    for (int s = 0; s < kGvUnroll; ++s) {
      const uint32_t words[4] = {wv[s].x, wv[s].y, wv[s].z, wv[s].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float q[8];
        nibbles8(words[c], q);
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int i = 0; i < MR; ++i) acc[i][p][c] = fmaf(xv[s][i], q[p], acc[i][p][c]);
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
  // thread -> (plane p, lane l): 32 neighbouring threads write 32 neighbouring columns
  const int p = tid / 32, l = tid % 32;
  const int col = gni * kTileN + p * kLanes + lane0 + l;
#pragma unroll
  for (int i = 0; i < MR; ++i) {
    if (i < m) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < kGvThreads / 32; ++wi) s += red[wi][i][p][l];
      part[(static_cast<size_t>(split) * m + i) * n_pad + col] = s;
    }
  }
}

// ---------------------------------------------------------------- 4 < m <= 64
// mma.sync m16n8k16 (bf16 in, f32 sums), after int4_tiled_bf16.cu (K10). The
// A operand is 16 output columns by 16 k of codes: 16 neighbouring lanes of
// one nibble plane (a code in [-8, 7] is exact in bf16). The B operand is 16 k
// by 8 rows of x*u, formed in f32 as the reference forms it and split into
// three bf16 parts whose sum is x*u exactly (8 + 8 + 8 bits of its 24): three
// mma a plane into one f32 sum, so every product is the reference's f32
// product. One bf16 part puts an error of 2^-9 of each term into the sum (over
// the f32 gate on a third of the outputs at the 7B shapes); two leave 2^-17,
// enough at phase 3's scales of u but over the gate on a few outputs where
// x*u is of order 1 and the gate's atol is as tight as f32 sums allow.
// Each thread loads the 8 words its A fragments need for one 16-row k step
// (2 lanes x rows 2t, 2t+1, 2t+8, 2t+9) once and feeds 8 planes x 3 mma: a warp
// covers 128 columns and 16 rows a step, m = 8 fills B's 8 columns where the
// 64-row FMA tile wastes 56 of its rows. The 4 warps of a block interleave
// over the steps of one k split and their sums are added in warp order in
// shared memory. Rows >= k of a step that runs past k (k % 16 != 0) get
// x*u = 0 (the reference zero-pads x and u there; their words are in the array
// and hold any bits); x and u are never read past column k.
// grid: (gn * 8 units of 16 lanes, splits, m chunks of 8 rows); tk % 16 == 0
// and rows_per_split % (16 * kTcWarps) == 0, so a step lies in one k tile.
template <typename TX>
__global__ void __launch_bounds__(kTcThreads) int4_rank1_tc_kernel(
    const TX* __restrict__ x, int m, int k, const float* __restrict__ u,
    const int32_t* __restrict__ w, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
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

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  // k rows of this thread's fragments within a step: 2t, 2t+1, 2t+8, 2t+9
  const int rofs[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
  for (int ks = k0 + warp * kTcStep; ks < k1; ks += kTcWarps * kTcStep) {
    uint32_t words[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        words[h][r] = static_cast<uint32_t>(
            __ldg(word_ptr(w, ks + rofs[r], gni, gk, gn, tk) + lane0 + g + 8 * h));
    // B column g: x*u of row m0 + g at k rows ks + rofs[r]
    float xu[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int kr = ks + rofs[r];
      const int kc = min(kr, k - 1);
      const float val = to_f32(xrow[kc]) * __ldg(u + kc);
      xu[r] = xrow_ok && kr < k ? val : 0.f;
    }
    uint32_t b[2][3];  // (k 2t, 2t+1), (k 2t+8, 2t+9): three bf16 parts each
    split3_bf16x2(xu[0], xu[1], b[0]);
    split3_bf16x2(xu[2], xu[3], b[1]);
    float q[2][4][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int r = 0; r < 4; ++r) nibbles8(words[h][r], q[h][r]);
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint32_t a[4] = {pack_bf16x2(q[0][0][p], q[0][1][p]),   // column g, k 2t, 2t+1
                             pack_bf16x2(q[1][0][p], q[1][1][p]),   // column g+8
                             pack_bf16x2(q[0][2][p], q[0][3][p]),   // column g, k 2t+8, 2t+9
                             pack_bf16x2(q[1][2][p], q[1][3][p])};  // column g+8
#pragma unroll
      for (int s = 0; s < 3; ++s) mma_bf16(acc[p], a, b[0][s], b[1][s]);
    }
  }

  // acc[p][j]: column lane0 + g + 8 (j >> 1) of plane p, x row m0 + 2t + (j & 1)
  tc_store_part(acc, g, 8, part, split, m, m0, gni, lane0, n_pad);
}

// ---------------------------------------------------------------- m > 64
// Block tile: 64 rows x 128 columns (16 lanes x 8 planes) x 32 k per step.
// Thread (ty, tx) owns rows ty*4..ty*4+3 and the 8 planes of lane tx.
constexpr int kGmThreads = 256;
constexpr int kGmM = 64;
constexpr int kGmLanes = 16;
constexpr int kGmN = kGmLanes * 8;
constexpr int kGmK = 32;

template <typename TX>
__global__ void __launch_bounds__(kGmThreads) int4_gemm_kernel(
    const TX* __restrict__ x, int m, int k, const float* __restrict__ u,
    const int32_t* __restrict__ w, int gk, int gn, int tk, int rows_per_split,
    float* __restrict__ part, int n_pad) {
  __shared__ float xs[kGmK][kGmM + 1];      // x*u, k-major; +1 avoids bank conflicts
  __shared__ float ws[kGmK][kGmN + 16];     // decoded codes, column = p*16 + lane
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
      const float uu = kr < k1 ? __ldg(u + kr) : 0.f;
#pragma unroll
      for (int s = 0; s < kGmM / (kGmThreads / kGmK); ++s) {
        const int row = tid / kGmK + s * (kGmThreads / kGmK);
        const int gm = m0 + row;
        float val = 0.f;
        if (gm < m && kr < k1) val = to_f32(x[static_cast<size_t>(gm) * k + kr]) * uu;
        xs[kk][row] = val;
      }
    }
#pragma unroll
    for (int s = 0; s < kGmK / (kGmThreads / kGmLanes); ++s) {  // weight tile
      const int kk = tid / kGmLanes + s * (kGmThreads / kGmLanes);
      const int kr = kt + kk;
      uint32_t word = 0u;
      if (kr < k1) word = __ldg(word_ptr(w, kr, gni, gk, gn, tk) + lane0 + tx);
      float q[8];
      nibbles8(word, q);
#pragma unroll
      for (int p = 0; p < 8; ++p) ws[kk][p * kGmLanes + tx] = q[p];
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

// Adds the split partials in split order and applies the column scale v/8.
template <typename TY>
__global__ void int4_splitk_reduce_kernel(const float* __restrict__ part, int splits, int m,
                                          int n_pad, const float* __restrict__ v, int n,
                                          TY* __restrict__ y) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<size_t>(m) * n) return;
  const int row = static_cast<int>(idx / n);
  const int col = static_cast<int>(idx % n);
  float s = 0.f;
  for (int sp = 0; sp < splits; ++sp) s += part[(static_cast<size_t>(sp) * m + row) * n_pad + col];
  y[idx] = from_f32<TY>(s * (v[col] * 0.125f));
}

template <typename T>
cudaError_t launch(const void* x, int m, int k, const float* u, const int32_t* w, int gk,
                   int gn, int tk, const float* v, int n, void* y, float* part, int splits,
                   int rows_per_split, int tc, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const int n_pad = gn * kTileN;
  if (tc) {
    if (m <= 4 || tk % kTcStep || rows_per_split % (kTcStep * kTcWarps))
      return cudaErrorInvalidValue;
    const dim3 grid(gn * kTcUnits, splits, (m + kTcRows - 1) / kTcRows);
    int4_rank1_tc_kernel<T><<<grid, kTcThreads, 0, stream>>>(xt, m, k, u, w, gk, gn, tk,
                                                             rows_per_split, part, n_pad);
  } else if (m <= 4) {
    const dim3 grid(gn * kGvStrips, splits);
    auto kernel = m == 1 ? int4_gemv_kernel<1, T> : m == 2 ? int4_gemv_kernel<2, T>
                                                           : int4_gemv_kernel<4, T>;
    kernel<<<grid, kGvThreads, 0, stream>>>(xt, m, k, u, w, gk, gn, tk, rows_per_split, part,
                                            n_pad);
  } else {
    const dim3 grid((m + kGmM - 1) / kGmM, gn * (kLanes / kGmLanes), splits);
    int4_gemm_kernel<T><<<grid, kGmThreads, 0, stream>>>(xt, m, k, u, w, gk, gn, tk,
                                                         rows_per_split, part, n_pad);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(m) * n;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  int4_splitk_reduce_kernel<T><<<blocks, threads, 0, stream>>>(part, splits, m, n_pad, v, n,
                                                               static_cast<T*>(y));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (m, k) row-major, f32 (x_bf16 = 0) or bf16 (x_bf16 = 1); u: (k,) f32;
// w: one layer's (gk, gn, tk, 128) int32 words; v: (n,) f32;
// y: (m, n) in x's dtype; part: (splits, m, gn*1024) f32 scratch; tc = 1
// takes the tensor-core kernel (4 < m, tk % 16 == 0, rows_per_split % 64 ==
// 0), tc = 0 the gemv kernel for m <= 4 and the FMA tile kernel above.
// Returns the cudaError_t of the launches.
int fm_int4_rank1_matmul(const void* x, int x_bf16, int m, int k, const float* u,
                         const int32_t* w, int gk, int gn, int tk, const float* v, int n,
                         void* y, float* part, int splits, int rows_per_split, int tc,
                         cudaStream_t stream) {
  if (x_bf16)
    return static_cast<int>(launch<__nv_bfloat16>(x, m, k, u, w, gk, gn, tk, v, n, y, part,
                                                  splits, rows_per_split, tc, stream));
  return static_cast<int>(launch<float>(x, m, k, u, w, gk, gn, tk, v, n, y, part, splits,
                                        rows_per_split, tc, stream));
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
