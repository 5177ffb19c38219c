// Causal fastmax forward (K4), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of fastmax_tpu/ops/fastmax_pallas.py:
// _fwd_train_kernel (pallas_call in _train_fwd_call, the forward of
// fastmax_pallas_trainable) and _kernel (fastmax_pallas, the forward alone, which is
// this kernel with its g and state outputs switched off).
//
// q, k, v: (BH, N, D), float32 or bfloat16, N % chunk == 0, chunk % 64 == 0, D <= 64.
// With s = q . k / z and f(s) = 1 + s (+ s^2 / 2 for p = 2), row t of a head gives
//   o[t] = sum_{u <= t} f(s_tu) v_u / g[t],   g[t] = sum_{u <= t} f(s_tu),
// computed as the reference computes it: per chunk of `chunk` rows, the causal
// intra-chunk block plus the carried state of the earlier chunks,
//   f += s_v + q @ s_kv / z + (Q2 w) @ S3 / (2 z^2)
//   g += cnt + q @ s_k / z + rowsum((q @ s_kk) * q) / (2 z^2)
// then the state takes the chunk: s_v += sum v, s_kv += k^T v, s_k += sum k,
// s_kk += k^T k, S3 += K2^T v (S3 packed over pairs m <= j, fastmax_common.cuh).
// o is written in the input type, g (BH, N) in float32; given skv_out, the final
// s_kv (D, D), s_k (D), s_kk (D, D) are written, and S3 is left in `s3`.
//
// S3 (2080 x 64 f32 = 532 KB a head at D = 64) does not fit in the 227 KB a CTA can
// have, so it stays in device memory, where the 50 MB L2 holds all of it at the
// training shape (32 heads, 17 MB). With one CTA a head the training shape would fill
// 32 of the 132 SMs, so `nsplit` CTAs a head split the work: each writes its own partial
// f (no atomics, a fixed order) and fastmax_fwd_finish writes o = their sum / g.
//
// Two kernels, chosen by the caller (ops/fastmax_kernels.py fwd_path):
//
// fastmax_fwd_tc_kernel, p = 2 at D % 16 == 0: every product on the tensor cores
// (mma.sync m16n8k16, csrc/fastmax_tc.cuh): float32 operands split into three bfloat16
// parts (six products in a fresh accumulator a k step, as exact as float32), the pair
// operands of bfloat16 inputs (bfloat16 values already) one exact product each. CTA 0 of
// a head does the intra-chunk block (s = q k^T, f(s) masked, f(s) v, rowsum f(s)), every
// D x D term (q s_kv, q s_k, rowsum((q s_kk) q), s_v and the chunk's k^T v, k^T k, sums)
// and g, all by split float32 products for both input types, as the reference computes
// them in float32. The others split the pairs in whole 64-pair tiles and visit each
// tile once a chunk: the tile comes through a two-stage cp.async ring, is split once into
// bfloat16 planes, gives f2 += (Q2 w) S3_tile against its entry value (A: the pair
// features w q_m q_j formed on the fly and rounded where the reference rounds them; B:
// the planes), then takes S3_tile += K2^T v (A: k_m k_j on the fly; B: the planes of v)
// and is written back: one read and one write of each S3 slice a chunk of up to 128
// rows, 136 MB of L2 traffic a call at the training shape (4 chunks x 2 x 532 KB x 32
// heads), where the FMA kernel streams S3 about six times a chunk. A chunk of more than
// 128 rows is held 128 rows at a time, in 2 s - 1 passes over the tiles for s parts: the
// f2 reads of every part but the last, the last's read fused with its share of the
// update, then the others' shares, so every row reads S3 as the chunk found it and S3
// takes the whole chunk's update after the last read. Bound: operations, at three TF32
// products a multiply for float32 (chip_smoke.fastmax_work: 59.0 us at B=4 H=8 N=512
// D=64 chunk 128, 242.6 us at N=2048 chunk 256) and at the bf16 tensor-core rate for
// bfloat16 (9.8 us); the pair products are 90 % of the operations, and the three pair
// CTAs of a head carry them, with CTA 0 taking the first three pair tiles after its own
// work in float32, where its own work alone ends first (kLeadTiles).
//
// fastmax_fwd_kernel, everything else (p = 1, D % 16 != 0): f32 FMAs from shared memory.
// s_v, s_k, s_kv and s_kk live in shared memory; the pair terms, f2 and the S3 update,
// are split over the `nsplit` CTAs of a head by ranges of pairs (each owns its rows of
// S3 and writes a partial f2) and split 0 adds the rest of f and writes g; with
// nsplit = 1 the CTA writes o itself. Bound: operations at the f32 units' rate.

#include <algorithm>

#include "fastmax_common.cuh"
#include "fastmax_tc.cuh"

namespace {

using namespace fm;

constexpr int kTiles = 8;  // q, k, v, fs, s_kv, s_kk, pair features, pair rows

size_t smem_bytes() {
  return sizeof(float) * (kTiles * kTile + 3 * kR) + 2 * kMaxPairs;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fastmax_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ g_out, float* __restrict__ skv_out,
    float* __restrict__ sk_out, float* __restrict__ s3_all, float* __restrict__ skk_out,
    float* __restrict__ fpart, int n, int d, int chunk, int p2, float z, int s3_rows) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* fs_t = vs + kTile;
  float* skv = fs_t + kTile;
  float* skk = skv + kTile;
  float* at = skk + kTile;
  float* bt = at + kTile;
  float* s_v = bt + kTile;
  float* s_k = s_v + kR;
  uint8_t* pm = reinterpret_cast<uint8_t*>(s_k + 2 * kR);
  uint8_t* pj = pm + kMaxPairs;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const bool lead = split == 0;  // the intra-chunk block, the D x D state, g
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int npairs = d * (d + 1) / 2;
  int lo = 0, hi = 0;
  split_pairs(npairs, split, nsplit, lo, hi);
  float* s3 = p2 ? s3_all + static_cast<size_t>(bh) * s3_rows * d : nullptr;
  float* fp = fpart ? fpart + (static_cast<size_t>(split) * gridDim.x * n * d + base) : nullptr;
  const float z2 = 2.f * z * z;

  zero_tile(skv);
  zero_tile(skk);
  for (int c = tid; c < kR; c += kThreads) s_v[c] = s_k[c] = 0.f;
  if (p2) build_pairs(pm, pj, d);
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += chunk) {
    // ---- outputs of the chunk's rows, 64 at a time
    for (int i0 = c0; i0 < c0 + chunk; i0 += kR) {
      __syncthreads();
      load_tile(qs, q + base + static_cast<size_t>(i0) * d, d);
      float f[4][4] = {}, gsum[4] = {}, grow[4] = {};
      for (int j0 = c0; lead && j0 <= i0; j0 += kR) {
        __syncthreads();
        load_tile(ks, k + base + static_cast<size_t>(j0) * d, d);
        load_tile(vs, v + base + static_cast<size_t>(j0) * d, d);
        __syncthreads();
        float s[4][4] = {};
        for (int e = 0; e < d; ++e) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLD + e];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kLD + e];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float x = s[i][j] / z;
            float w = 1.f + x;
            if (p2) w += 0.5f * x * x;
            if (j0 + tx + 16 * j > i0 + ty + 16 * i) w = 0.f;  // causal
            gsum[i] += w;
            fs_t[(ty + 16 * i) * kLD + tx + 16 * j] = w;
          }
        __syncthreads();
        for (int u = 0; u < kR; ++u) {
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = fs_t[(ty + 16 * i) * kLD + u];
#pragma unroll
          for (int j = 0; j < 4; ++j) b[j] = vs[u * kLD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) f[i][j] = fmaf(a[i], b[j], f[i][j]);
        }
      }
      // ---- the carried state of the earlier chunks
      float t[4][4] = {}, u2[4][4] = {};
      for (int m = 0; lead && m < d; ++m) {
        float a[4], b[4], b2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * kLD + m];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = skv[m * kLD + tx + 16 * j];
          b2[j] = skk[m * kLD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            t[i][j] = fmaf(a[i], b[j], t[i][j]);
            u2[i][j] = fmaf(a[i], b2[j], u2[i][j]);
          }
      }
      if (lead) {
        float gk[4] = {}, gkk[4] = {};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            const float qv = qs[(ty + 16 * i) * kLD + c];
            f[i][j] += s_v[c] + t[i][j] / z;
            gk[i] = fmaf(qv, s_k[c], gk[i]);
            gkk[i] = fmaf(u2[i][j], qv, gkk[i]);
          }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          grow[i] = row_sum16(gsum[i]) + static_cast<float>(c0) + row_sum16(gk[i]) / z;
          if (p2) grow[i] += row_sum16(gkk[i]) / z2;
        }
      }
      if (p2) {
        float f2[4][4] = {};
        pair_out<T>(f2, qs, s3, d, lo, hi, true, at, bt, pm, pj);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) f[i][j] += f2[i][j] / z2;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c >= d) continue;
          const size_t at_rc = static_cast<size_t>(r) * d + c;
          if (nsplit == 1)
            o[base + at_rc] = from_f32<T>(f[i][j] / grow[i]);
          else
            fp[at_rc] = f[i][j];
        }
        if (lead && g_out != nullptr && tx == 0) g_out[static_cast<size_t>(bh) * n + r] = grow[i];
      }
    }
    // ---- the state takes the chunk
    for (int j0 = c0; j0 < c0 + chunk; j0 += kR) {
      __syncthreads();
      load_tile(ks, k + base + static_cast<size_t>(j0) * d, d);
      load_tile(vs, v + base + static_cast<size_t>(j0) * d, d);
      __syncthreads();
      if (lead && tid < d) {
        float sv = 0.f, sk = 0.f;
        for (int r = 0; r < kR; ++r) {
          sv += vs[r * kLD + tid];
          sk += ks[r * kLD + tid];
        }
        s_v[tid] += sv;
        s_k[tid] += sk;
      }
      float akv[4][4] = {}, akk[4][4] = {};
      for (int r = 0; lead && r < kR; ++r) {
        float a[4], b[4], b2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = ks[r * kLD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = vs[r * kLD + tx + 16 * j];
          b2[j] = ks[r * kLD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            akv[i][j] = fmaf(a[i], b[j], akv[i][j]);
            akk[i][j] = fmaf(a[i], b2[j], akk[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int e = (ty + 16 * i) * kLD + tx + 16 * j;
          skv[e] += akv[i][j];
          if (p2) skk[e] += akk[i][j];
        }
      if (p2) pair_update<T>(s3, ks, vs, d, lo, hi, false, 1.f, at, pm, pj);
    }
  }
  __syncthreads();
  if (!lead || skv_out == nullptr) return;
  const size_t dd = static_cast<size_t>(d) * d;
  for (int idx = tid; idx < d * d; idx += kThreads) {
    const int m = idx / d, c = idx % d;
    skv_out[bh * dd + idx] = skv[m * kLD + c];
    if (p2) skk_out[bh * dd + idx] = skk[m * kLD + c];
  }
  if (tid < d) sk_out[static_cast<size_t>(bh) * d + tid] = s_k[tid];
}

// ------------------------------------------------------------ the tensor-core path

namespace tcf {

using fmtc::acc_col;
using fmtc::acc_row;
using fmtc::at;
using fmtc::kLDA;
using fmtc::kLDF;
using fmtc::kMaxC;
using fmtc::kPT;
using fmtc::kR;
using fmtc::kTileA;
using fmtc::load_rows;
using fmtc::mma64;
using fmtc::PairSmem;
using fmtc::quad_col0;
using fmtc::quad_row0;
using fmtc::tr;

// pair tiles CTA 0 takes after its own work (the others share the rest), by input type: in
// float32 the pair CTAs are the slower ones and CTA 0 evens them out with three tiles; in
// bfloat16 CTA 0 is the slower (tools/fastmax_ab.py --lead-tiles, PERF.md)
template <typename T> constexpr int kLeadTiles = 3;
template <> constexpr int kLeadTiles<__nv_bfloat16> = 0;

// CTA 0: q, k, v, f(s), s_kv, s_kk (kR x kLDA), s_v, s_k and the row sums' halves (2 x 3 x kR)
constexpr size_t kDenseBytes = sizeof(float) * (6 * kTileA + 8 * kR);
size_t smem_bytes() { return std::max(kDenseBytes, fmtc::kPairBytes); }

// the pairs [lo, hi) of CTA `split` of `nsplit`, in whole 64-pair tiles: CTA 0 the first
// `lead`, the others the rest in equal shares
__device__ __forceinline__ void pair_range(int d, int split, int nsplit, int lead, int& lo,
                                           int& hi) {
  const int npairs = d * (d + 1) / 2, tiles = (npairs + kPT - 1) / kPT;
  lead = min(lead, tiles);
  const int rest = tiles - lead, ctas = nsplit - 1;
  const int t0 = split == 0 ? 0 : lead + (split - 1) * rest / ctas;
  const int t1 = split == 0 ? lead : lead + split * rest / ctas;
  lo = min(t0 * kPT, npairs);
  hi = min(t1 * kPT, npairs);
}

// CTA 0: the intra-chunk block, every D x D term and g, float32 products by split operands;
// f (without the pair term) to this CTA's part buffer
template <typename T>
__device__ __forceinline__ void dense_cta(const T* q, const T* k, const T* v, float* f_out,
                                          float* g_out, float* skv_out, float* sk_out,
                                          float* skk_out, int n, int d, int chunk, float z) {
  float* qs = fm_tc_smem;
  float* ks = qs + kTileA;
  float* vs = ks + kTileA;
  float* fs = vs + kTileA;
  float* skv = fs + kTileA;
  float* skk = skv + kTileA;
  float* s_v = skk + kTileA;
  float* s_k = s_v + kR;
  float* red = s_k + kR;  // [column half][term][row]: rowsum f(s), q s_k, rowsum((q s_kk) q)

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int row0 = quad_row0(), col0 = quad_col0(), half = tid >> 7;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const float z2 = 2.f * z * z;

  for (int idx = tid; idx < kTileA; idx += fmtc::kThreads) skv[idx] = skk[idx] = 0.f;
  for (int c = tid; c < kR; c += fmtc::kThreads) s_v[c] = s_k[c] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < n; c0 += chunk) {
    // ---- the chunk's rows, 64 at a time, against the state as the chunk found it
    for (int i0 = c0; i0 < c0 + chunk; i0 += kR) {
      __syncthreads();
      load_rows<kLDA>(qs, q + base + static_cast<size_t>(i0) * d, kR, d);
      float f[4][4];
      fmtc::zero_acc(f);
      float gs[2] = {0.f, 0.f}, gk[2] = {0.f, 0.f}, gkk[2] = {0.f, 0.f};  // rows g, g + 8
      for (int j0 = c0; j0 <= i0; j0 += kR) {
        __syncthreads();
        load_rows<kLDA>(ks, k + base + static_cast<size_t>(j0) * d, kR, d);
        load_rows<kLDA>(vs, v + base + static_cast<size_t>(j0) * d, kR, d);
        __syncthreads();
        float s[4][4];
        fmtc::zero_acc(s);
        mma64(s, at<kLDA>(qs), tr<kLDA>(ks), d);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = acc_row(row0, e), u = acc_col(col0, nt, e);
            const float x = s[nt][e] / z;
            float w = 1.f + x;
            w += 0.5f * x * x;
            if (j0 + u > i0 + r) w = 0.f;  // causal
            gs[e >> 1] += w;
            fs[r * kLDA + u] = w;
          }
        __syncthreads();
        mma64(f, at<kLDA>(fs), at<kLDA>(vs), kR);
      }
      float t1[4][4], t2[4][4];
      fmtc::zero_acc(t1);
      fmtc::zero_acc(t2);
      mma64(t1, at<kLDA>(qs), at<kLDA>(skv), d);
      mma64(t2, at<kLDA>(qs), at<kLDA>(skk), d);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = acc_row(row0, e), c = acc_col(col0, nt, e);
          const float qv = qs[r * kLDA + c];
          f[nt][e] += s_v[c] + t1[nt][e] / z;
          gk[e >> 1] = fmaf(qv, s_k[c], gk[e >> 1]);
          gkk[e >> 1] = fmaf(t2[nt][e], qv, gkk[e >> 1]);
          if (c < d) f_out[base + static_cast<size_t>(i0 + r) * d + c] = f[nt][e];
        }
      // g: each row's three sums over the four lanes of its quad, then the two column halves
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {
          gs[h] += __shfl_xor_sync(0xffffffffu, gs[h], o);
          gk[h] += __shfl_xor_sync(0xffffffffu, gk[h], o);
          gkk[h] += __shfl_xor_sync(0xffffffffu, gkk[h], o);
        }
      if (fmtc::lane_t() == 0)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* at_row = red + half * 3 * kR + row0 + fmtc::lane_g() + 8 * h;
          at_row[0] = gs[h];
          at_row[kR] = gk[h];
          at_row[2 * kR] = gkk[h];
        }
      __syncthreads();
      if (tid < kR) {
        const float* a = red + tid;
        const float* b = a + 3 * kR;
        float gv = (a[0] + b[0]) + static_cast<float>(c0) + (a[kR] + b[kR]) / z;
        gv += (a[2 * kR] + b[2 * kR]) / z2;
        g_out[static_cast<size_t>(bh) * n + i0 + tid] = gv;
      }
    }
    // ---- the D x D state takes the chunk
    for (int j0 = c0; j0 < c0 + chunk; j0 += kR) {
      __syncthreads();
      load_rows<kLDA>(ks, k + base + static_cast<size_t>(j0) * d, kR, d);
      load_rows<kLDA>(vs, v + base + static_cast<size_t>(j0) * d, kR, d);
      __syncthreads();
      if (tid < d) {
        float sv = 0.f, sk = 0.f;
        for (int r = 0; r < kR; ++r) {
          sv += vs[r * kLDA + tid];
          sk += ks[r * kLDA + tid];
        }
        s_v[tid] += sv;
        s_k[tid] += sk;
      }
      float akv[4][4], akk[4][4];
      fmtc::zero_acc(akv);
      fmtc::zero_acc(akk);
      mma64(akv, tr<kLDA>(ks), at<kLDA>(vs), kR);
      mma64(akk, tr<kLDA>(ks), at<kLDA>(ks), kR);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = acc_row(row0, e) * kLDA + acc_col(col0, nt, e);
          skv[i] += akv[nt][e];
          skk[i] += akk[nt][e];
        }
    }
  }
  __syncthreads();
  if (skv_out == nullptr) return;
  const size_t dd = static_cast<size_t>(d) * d;
  for (int idx = tid; idx < d * d; idx += fmtc::kThreads) {
    const int m = idx / d, c = idx % d;
    skv_out[bh * dd + idx] = skv[m * kLDA + c];
    skk_out[bh * dd + idx] = skk[m * kLDA + c];
  }
  if (tid < d) sk_out[static_cast<size_t>(bh) * d + tid] = s_k[tid];
}

// rows [r_beg, r_beg + rows) of a head (at base): q and k in f32 and the planes of v, zero
// at c >= d
template <typename T>
__device__ __forceinline__ void hold_rows(const T* q, const T* k, const T* v, size_t base,
                                          int r_beg, int rows, int d) {
  load_rows<kLDF>(PairSmem::qs(), q + base + static_cast<size_t>(r_beg) * d, rows, d);
  load_rows<kLDF>(PairSmem::ks(), k + base + static_cast<size_t>(r_beg) * d, rows, d);
  for (int idx = threadIdx.x; idx < rows * 16; idx += fmtc::kThreads) {
    const int r = idx / 16, c = (idx % 16) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) x = fmtc::load4(v + base + static_cast<size_t>(r_beg + r) * d + c);
    fmtc::put_planes<T>(PairSmem::vpl(), PairSmem::kRowPlane, r, c, x.x, x.y);
    fmtc::put_planes<T>(PairSmem::vpl(), PairSmem::kRowPlane, r, c + 2, x.z, x.w);
  }
}

// f2 += (Q2 w) rnd(S3) over a tile's 64 pairs for the warp's 16 held rows, against the
// tile's value as it came (its planes are made here from the f32 tile)
template <typename T>
__device__ __forceinline__ void s3_read(const float* sb, float (&f2)[8][4], int p0, int rows) {
  fmtc::tile_planes<T>(sb);
  const int r0 = 16 * (threadIdx.x >> 5);
  if (r0 >= rows) return;
  const uint16_t* pmj = PairSmem::pmj() + p0;
  const float* qs = PairSmem::qs();
  auto q2w = [qs, pmj](int r, int pp) {  // (Q2 w)[r, pp] = rnd(w q_m q_j)
    const int code = pmj[pp], m = code & 255, j = code >> 8;
    float a = qs[r * kLDF + m] * qs[r * kLDF + j];
    if (m != j) a *= 2.f;
    return rnd<T>(a);
  };
  fmtc::mma_planes<T, 8, true>(f2, fmtc::from_values<T>(q2w, r0), PairSmem::spl(),
                               PairSmem::kTilePlane, 0, kPT);
}

// A pair CTA: f2 and the S3 update over the pairs [lo, hi), whole 64-pair tiles; its part of
// f, f2 / (2 z^2), to f_out (added to what is there when `add`). It holds at most kMaxC of
// a chunk's rows at a time (a part) and walks its tiles in passes, each pass one visit to
// every tile with one part held: the f2 reads of every part but the last, then the last's
// read fused with its share of the update, then the others' shares, so every read sees S3
// as the chunk found it. A chunk of at most kMaxC rows is one pass.
template <typename T>
__device__ __forceinline__ void pair_cta(const T* q, const T* k, const T* v, float* s3,
                                         float* f_out, int n, int d, int chunk, float z, int lo,
                                         int hi, bool add) {
  const int tid = threadIdx.x, bh = blockIdx.x;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int ntile = (hi - lo + kPT - 1) / kPT;
  const int nsub = (chunk + kMaxC - 1) / kMaxC, per = 2 * nsub - 1, steps = per * ntile;
  const float inv_z2 = 1.f / (2.f * z * z);
  const int r0 = 16 * (tid >> 5);  // the warp's rows of the part

  fmtc::pair_setup(d);
  auto issue = [=](int step) {  // stage step `step` of a chunk into ring[step & 1]
    fmtc::stage_tile(PairSmem::ring(step & 1), s3, lo + (step % ntile) * kPT, lo, hi, d);
  };

  for (int c0 = 0; c0 < n; c0 += chunk) {
    __syncthreads();
    issue(0);
    int held = -1;
    for (int pass = 0; pass < per; ++pass) {
      const int sub = pass < nsub ? pass : pass - nsub;
      const bool first = pass < nsub, second = pass >= nsub - 1;  // f2 read | update
      const int r_beg = c0 + sub * kMaxC, rows = min(kMaxC, chunk - sub * kMaxC);
      if (sub != held) {
        if (held >= 0) __syncthreads();  // the held rows are free
        hold_rows<T>(q, k, v, base, r_beg, rows, d);
        held = sub;
      }
      float f2[8][4];  // the pass's f2 of the warp's rows
      fmtc::zero_acc(f2);
      for (int tile = 0; tile < ntile; ++tile) {
        const int step = pass * ntile + tile;
        // a lone tile is staged for the next pass only once written
        const bool ahead = step + 1 < steps && ntile > 1;
        __syncthreads();  // the ring slot about to be filled is free
        if (ahead) {
          issue(step + 1);
          fmtc::cp_async_wait<1>();
        } else {
          fmtc::cp_async_wait<0>();
        }
        __syncthreads();  // this step's tile is in
        float* sb = PairSmem::ring(step & 1);
        const int p0 = lo + tile * kPT, np = min(kPT, hi - p0);
        if (first) s3_read<T>(sb, f2, p0, rows);
        if (second) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, 1.f);
        if (step + 1 < steps && !ahead) {
          __syncthreads();  // the tile's writes are done
          issue(step + 1);
        }
      }
      if (first && r0 < rows) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = acc_row(r0, e), c = acc_col(0, nt, e);
            if (c >= d) continue;
            float* out = f_out + base + static_cast<size_t>(r_beg + r) * d + c;
            const float x = f2[nt][e] * inv_z2;
            *out = add ? *out + x : x;
          }
      }
    }
  }
}

// CTA 0 of a head: the intra-chunk block, the D x D terms and g (then its share of the
// pair tiles, if any); CTAs 1 .. nsplit - 1: the pair terms. CTA s writes row s of fpart.
template <typename T>
__global__ void __launch_bounds__(fmtc::kThreads, 1) fastmax_fwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    float* __restrict__ g_out, float* __restrict__ skv_out, float* __restrict__ sk_out,
    float* __restrict__ s3_all, float* __restrict__ skk_out, float* __restrict__ fpart, int n,
    int d, int chunk, float z, int s3_rows) {
  const int bh = blockIdx.x, split = blockIdx.y;
  float* f_out = fpart + static_cast<size_t>(split) * gridDim.x * n * d;
  float* s3 = s3_all + static_cast<size_t>(bh) * s3_rows * d;
  int lo = 0, hi = 0;
  pair_range(d, split, gridDim.y, kLeadTiles<T>, lo, hi);
  if (split == 0) {
    dense_cta<T>(q, k, v, f_out, g_out, skv_out, sk_out, skk_out, n, d, chunk, z);
    if (lo >= hi) return;
    __syncthreads();  // the dense tiles are free
    pair_cta<T>(q, k, v, s3, f_out, n, d, chunk, z, lo, hi, true);
    return;
  }
  if (lo >= hi) {  // no pairs: a zero part
    const size_t base = static_cast<size_t>(bh) * n * d;
    for (size_t idx = threadIdx.x; idx < static_cast<size_t>(n) * d; idx += fmtc::kThreads)
      f_out[base + idx] = 0.f;
    return;
  }
  pair_cta<T>(q, k, v, s3, f_out, n, d, chunk, z, lo, hi, false);
}

}  // namespace tcf

// o = (sum over the splits of the partial f) / g, in the input's type
template <typename T>
__global__ void fastmax_fwd_finish(const float* __restrict__ fpart, const float* __restrict__ g,
                                   T* __restrict__ o, size_t total, int d, int nsplit) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float f = 0.f;
    for (int s = 0; s < nsplit; ++s) f += fpart[s * total + idx];
    o[idx] = from_f32<T>(f / g[idx / d]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* g,
                   float* skv, float* sk, float* s3, float* skk, float* fpart, int bh, int n,
                   int d, int chunk, int p2, float z, int s3_rows, int nsplit, int tc,
                   cudaStream_t stream) {
  // set once, before any CUDA-graph capture of a launch
  static bool smem_set = false, tc_smem_set = false;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  cudaError_t err;
  if (tc) {
    auto kernel = tcf::fastmax_fwd_tc_kernel<T>;
    err = set_smem(kernel, tcf::smem_bytes(), tc_smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, nsplit), fmtc::kThreads, tcf::smem_bytes(), stream>>>(
        qt, kt, vt, g, skv, sk, s3, skk, fpart, n, d, chunk, z, s3_rows);
  } else {
    auto kernel = fastmax_fwd_kernel<T>;
    err = set_smem(kernel, smem_bytes(), smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, nsplit), kThreads, smem_bytes(), stream>>>(
        qt, kt, vt, static_cast<T*>(o), g, skv, sk, s3, skk, fpart, n, d, chunk, p2, z,
        s3_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const size_t total = static_cast<size_t>(bh) * n * d;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  fastmax_fwd_finish<T><<<blocks, 256, 0,
                          stream>>>(fpart, g, static_cast<T*>(o), total, d, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, o: (BH, N, D) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); D <= 64,
// N % chunk == 0, chunk % 64 == 0, p2 = (p == 2). g: (BH, N) f32, or null when nsplit
// is 1 and g is not wanted. skv (BH, D, D), sk (BH, D), skk (BH, D, D): written when
// skv is not null. s3: (BH, s3_rows, D) f32, zeroed by the caller, needed when p2; it
// holds the final packed S3 afterwards. nsplit CTAs a head (1 unless p2); fpart:
// (nsplit, BH, N, D) f32 scratch when nsplit > 1. tc = 1 runs fastmax_fwd_tc_kernel,
// which takes p2, D % 16 == 0 and nsplit >= 2 (CTA 0 and a pair CTA); tc = 0 the FMA
// kernel.
int fm_fastmax_fwd(const void* q, const void* k, const void* v, void* o, int bf16, float* g,
                   float* skv, float* sk, float* s3, float* skk, float* fpart, int bh, int n,
                   int d, int chunk, int p2, float z, int s3_rows, int nsplit, int tc,
                   cudaStream_t stream) {
  if (d < 1 || d > fm::kMaxD || chunk % fm::kR || chunk < fm::kR || n % chunk || nsplit < 1 ||
      (nsplit > 1 && (!p2 || g == nullptr || fpart == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc && (!p2 || d % 16 || nsplit < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, o, g, skv, sk, s3, skk, fpart, bh, n, d, chunk, p2,
                                   z, s3_rows, nsplit, tc, stream)
           : launch<float>(q, k, v, o, g, skv, sk, s3, skk, fpart, bh, n, d, chunk, p2, z,
                           s3_rows, nsplit, tc, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
