// Causal fastmax backward (K5): the reverse chunk walk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _bwd_kernel of fastmax_tpu/ops/fastmax_pallas.py
// (pallas_call in _train_bwd_call_impl, the backward of fastmax_pallas_trainable).
//
// Inputs: q, k, v, do, o (BH, N, D) in the forward's type; g (BH, N) f32 from K4; the
// forward's final state s_kv, s_k, s_kk and S3 (a copy the kernel rewinds in place).
// The state update is additive, so the walk goes from the last chunk to the first and
// rebuilds each chunk's entry state by subtracting the chunk's own update, carrying
// the state's cotangents (dS) beside it. Per chunk, in the reference's order:
//   1. rewind: s_kv -= k^T v, s_k -= sum k, s_kk -= k^T k, S3 -= K2^T v;
//   2. per 64-row tile: df = do / g, dgr = -rowsum(do o) / g; the intra-chunk VJP
//      (ds = (df v^T + dgr) f'(s), dq += ds k / z, dk += ds^T q / z, dv += f(s)^T df);
//      the q-side terms against the rewound state (dq += df s_kv^T / z + dgr s_k / z
//      + dgr (q s_kk) / z^2 + the S3 fold over dq2 = (df S3^T) w, / (2 z^2)); the
//      update-path terms with the INCOMING cotangents, before this chunk's own
//      (dv += d_sv + k d_skv + K2 dS3, dk += v d_skv^T + d_sk + k (d_skk + d_skk^T)
//      + the dS3 fold over dk2 = v dS3^T);
//   3. the cotangents take the chunk: dS3 += (Q2 w)^T df / (2 z^2), d_sv += sum df,
//      d_skv += q^T df / z, d_sk += sum(dgr q) / z, d_skk += q^T (dgr q) / (2 z^2).
// Taking step 3 before step 2 would give gradients that are right for one chunk and
// wrong for more.
//
// Two kernels, chosen by the caller (ops/fastmax_kernels.py bwd_path):
//
// fastmax_bwd_tc_kernel, p = 2 at D % 16 == 0: every product on the tensor cores
// (csrc/fastmax_tc.cuh): float32 operands split into three bfloat16 parts (six products,
// as exact as float32), the pair operands of bfloat16 inputs (bfloat16 values already)
// one exact product each. Of the `nsplit` CTAs a head,
// CTA 0 does the intra-chunk VJP and every D x D term (split float32 products, for both
// input types); the others split the pairs in whole 64-pair tiles and do the five pair
// products (the rewind, dq2, dv, dk2, the dS3 update; 90 % of the work at D = 64) and the
// two pair folds. A pair CTA holds the chunk's q and k (f32, for the pair features and the
// folds) and v and rnd(df) (as bfloat16 planes) in shared memory and walks its tiles twice
// a chunk: an S3 tile is read, rewound, written back and folded into dq in one visit; a
// dS3 tile is read, used for dv and the dk fold with its incoming value, then updated and
// written. A chunk of more than 128 rows is held 128 rows at a time, and each walk becomes
// 2 s - 1 passes for s such sub-chunks (pair_cta), in the same order of terms. So at
// chunks of up to 128 rows each slice of S3 and of dS3 is read and written once a chunk
// (four streams, where the FMA kernel took seven a 64-row tile): at the training shape (BH 32,
// N 512, D 64, chunk 128) 4 chunks x 2 x 2 x 532 KB x 32 heads = 272 MB of L2 traffic a
// call. The tiles come through a two-stage cp.async ring and are split into planes once a
// visit; the row and tile operands then load with ldmatrix, and the pair features
// x_m x_j w, rounded as the reference rounds them, are formed on the fly into the
// fragments. A fold, out[r, m_p] += rnd(t x_j) and out[r, j_p] += rnd(t x_m), runs on the
// tensor cores too: the product tile's C fragments times x are the A fragments, and the
// 0/1 expansions of the pair codes the B fragments.
//
// fastmax_bwd_kernel, everything else: f32 FMAs from shared memory. S3 and dS3 stay in
// device memory (34 MB for the 32 heads of the training shape, inside the 50 MB L2);
// `nsplit` CTAs a head split the pair terms by ranges of pairs, each rewinding and
// updating its own rows, and split 0 also does the intra-chunk VJP and every D x D term.
//
// Both: each CTA sums its part of dq, dk and dv in its own f32 buffer (one CTA a buffer
// row, so no atomics and a fixed order), and fastmax_bwd_finish adds the splits'
// buffers and writes dq, dk, dv in the input's type. Bound: operations.

#include <algorithm>

#include "fastmax_common.cuh"
#include "fastmax_tc.cuh"

namespace {

using namespace fm;

// q, k, v, df; u1, u2, u3 (f(s), ds and the pair tiles, never live together);
// s_kv, s_kk, d_skv, d_skk; the fold accumulator
constexpr int kTiles = 12;

size_t smem_bytes() {
  return sizeof(float) * (kTiles * kTile + 5 * kR) + 2 * kMaxPairs;
}

// df = do / g and dgr = -rowsum(do o) / g for rows i0 .. i0 + 63 of this head
template <typename T>
__device__ __forceinline__ void load_df(float* df, float* dgr, const T* dout, const T* o,
                                        const float* g, size_t base, int i0, int d, int n,
                                        int bh) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float gv = g[static_cast<size_t>(bh) * n + i0 + r];
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      float dv = 0.f;
      if (c < d) {
        const size_t at = base + static_cast<size_t>(i0 + r) * d + c;
        dv = to_f32(dout[at]);
        part = fmaf(dv, to_f32(o[at]), part);
      }
      df[r * kLD + c] = dv / gv;
    }
    part = row_sum16(part);
    if (tx == 0) dgr[r] = -part / gv;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) fastmax_bwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const T* __restrict__ o, const float* __restrict__ g,
    const float* __restrict__ skv_in, const float* __restrict__ sk_in,
    const float* __restrict__ skk_in, float* __restrict__ s3_all, float* __restrict__ ds3_all,
    float* __restrict__ part, int n, int d, int chunk, int p2, float z, int s3_rows) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kTile;
  float* vs = ks + kTile;
  float* df = vs + kTile;
  float* u1 = df + kTile;  // f(s) | pair features
  float* u2 = u1 + kTile;  // ds   | pair rows
  float* u3 = u2 + kTile;  // the fold's t tile
  float* skv = u3 + kTile;
  float* skk = skv + kTile;
  float* dskv = skk + kTile;
  float* dskk = dskv + kTile;
  float* acc_t = dskk + kTile;
  float* s_k = acc_t + kTile;
  float* d_sv = s_k + kR;
  float* d_sk = d_sv + kR;
  float* dgr = d_sk + kR;
  uint8_t* pm = reinterpret_cast<uint8_t*>(dgr + 2 * kR);
  uint8_t* pj = pm + kMaxPairs;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const bool lead = split == 0;  // the intra-chunk VJP and the D x D terms
  const size_t base = static_cast<size_t>(bh) * n * d;
  const size_t dd = static_cast<size_t>(d) * d;
  const int npairs = d * (d + 1) / 2;
  int lo = 0, hi = 0;
  split_pairs(npairs, split, nsplit, lo, hi);
  // this split's f32 sums of dq, dk, dv: (nsplit, 3, BH, N, D)
  const size_t total = static_cast<size_t>(gridDim.x) * n * d;
  float* dq_acc = part + static_cast<size_t>(split) * 3 * total;
  float* dk_acc = dq_acc + total;
  float* dv_acc = dk_acc + total;
  float* s3 = p2 ? s3_all + static_cast<size_t>(bh) * s3_rows * d : nullptr;
  float* ds3 = p2 ? ds3_all + static_cast<size_t>(bh) * s3_rows * d : nullptr;
  const float z2 = 2.f * z * z;

  for (int idx = tid; idx < kTile; idx += kThreads) {
    const int m = idx / kLD, c = idx % kLD;
    const bool in = m < d && c < d;
    skv[idx] = in ? skv_in[bh * dd + m * d + c] : 0.f;
    skk[idx] = (in && p2) ? skk_in[bh * dd + m * d + c] : 0.f;
    dskv[idx] = dskk[idx] = acc_t[idx] = 0.f;
  }
  for (int c = tid; c < kR; c += kThreads) {
    s_k[c] = c < d ? sk_in[static_cast<size_t>(bh) * d + c] : 0.f;
    d_sv[c] = d_sk[c] = 0.f;
  }
  if (p2) build_pairs(pm, pj, d);
  __syncthreads();

  for (int c0 = n - chunk; c0 >= 0; c0 -= chunk) {
    // ---- 1. rewind the state to the chunk's entry value
    for (int j0 = c0; j0 < c0 + chunk; j0 += kR) {
      __syncthreads();
      load_tile(ks, k + base + static_cast<size_t>(j0) * d, d);
      load_tile(vs, v + base + static_cast<size_t>(j0) * d, d);
      __syncthreads();
      if (lead && tid < d) {
        float sk = 0.f;
        for (int r = 0; r < kR; ++r) sk += ks[r * kLD + tid];
        s_k[tid] -= sk;
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
          skv[e] -= akv[i][j];
          if (p2) skk[e] -= akk[i][j];
        }
      if (p2) pair_update<T>(s3, ks, vs, d, lo, hi, false, -1.f, u1, pm, pj);
    }

    // ---- 2. gradients of the chunk's rows, 64 at a time
    for (int i0 = c0; i0 < c0 + chunk; i0 += kR) {
      __syncthreads();
      load_tile(qs, q + base + static_cast<size_t>(i0) * d, d);
      load_df(df, dgr, dout, o, g, base, i0, d, n, bh);
      float gq[4][4] = {};
      if (!lead) {  // the rows as keys, for the update-path pair terms
        load_tile(ks, k + base + static_cast<size_t>(i0) * d, d);
        load_tile(vs, v + base + static_cast<size_t>(i0) * d, d);
      }
      for (int j0 = c0; lead && j0 <= i0; j0 += kR) {
        __syncthreads();
        load_tile(ks, k + base + static_cast<size_t>(j0) * d, d);
        load_tile(vs, v + base + static_cast<size_t>(j0) * d, d);
        __syncthreads();
        float s[4][4] = {}, dp[4][4] = {};
        for (int e = 0; e < d; ++e) {
          float a[4], a2[4], b[4], b2[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = qs[(ty + 16 * i) * kLD + e];
            a2[i] = df[(ty + 16 * i) * kLD + e];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j] = ks[(tx + 16 * j) * kLD + e];
            b2[j] = vs[(tx + 16 * j) * kLD + e];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              s[i][j] = fmaf(a[i], b[j], s[i][j]);
              dp[i][j] = fmaf(a2[i], b2[j], dp[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ty + 16 * i;
          const float dg = dgr[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int u = tx + 16 * j;
            const float x = s[i][j] / z;
            float w = 1.f + x, wp = 1.f;
            if (p2) {
              w += 0.5f * x * x;
              wp += x;
            }
            if (j0 + u > i0 + r) w = wp = 0.f;  // causal
            u1[r * kLD + u] = w;
            u2[r * kLD + u] = (dp[i][j] + dg) * wp;
          }
        }
        __syncthreads();
        // dq += ds k / z for the query tile; dk += ds^T q / z, dv += f(s)^T df for the keys
        float tq[4][4] = {}, tk[4][4] = {}, tv[4][4] = {};
        for (int u = 0; u < kR; ++u) {
          float a[4], b[4], ak[4], av[4], bq[4], bd[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = u2[(ty + 16 * i) * kLD + u];
            ak[i] = u2[u * kLD + ty + 16 * i];
            av[i] = u1[u * kLD + ty + 16 * i];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j] = ks[u * kLD + tx + 16 * j];
            bq[j] = qs[u * kLD + tx + 16 * j];
            bd[j] = df[u * kLD + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              tq[i][j] = fmaf(a[i], b[j], tq[i][j]);
              tk[i][j] = fmaf(ak[i], bq[j], tk[i][j]);
              tv[i][j] = fmaf(av[i], bd[j], tv[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const size_t row = base + static_cast<size_t>(j0 + ty + 16 * i) * d;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            gq[i][j] += tq[i][j] / z;
            if (c < d) {
              dk_acc[row + c] += tk[i][j] / z;
              dv_acc[row + c] += tv[i][j];
            }
          }
        }
      }
      // the q-side terms against the rewound state
      if (lead) {
        float t1[4][4] = {}, t2[4][4] = {};
        for (int c = 0; c < d; ++c) {
          float a[4], aq[4], b[4], b2[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            a[i] = df[(ty + 16 * i) * kLD + c];
            aq[i] = qs[(ty + 16 * i) * kLD + c];
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            b[j] = skv[(tx + 16 * j) * kLD + c];
            b2[j] = skk[c * kLD + tx + 16 * j];
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              t1[i][j] = fmaf(a[i], b[j], t1[i][j]);
              t2[i][j] = fmaf(aq[i], b2[j], t2[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float dg = dgr[ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int m = tx + 16 * j;
            gq[i][j] += t1[i][j] / z;
            gq[i][j] += dg * s_k[m] / z;
            if (p2) gq[i][j] += dg * t2[i][j] / (z * z);
          }
        }
      }
      if (p2) pair_fold<T>(acc_t, qs, df, s3, d, lo, hi, true, u2, u3, pm, pj);
      __syncthreads();  // (p = 1: the non-lead CTAs' tiles were loaded without a barrier)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < d)
            dq_acc[base + static_cast<size_t>(i0 + r) * d + c] =
                gq[i][j] + (p2 ? acc_t[r * kLD + c] / z2 : 0.f);
          acc_t[r * kLD + c] = 0.f;
        }
      }
      // the update-path terms for these rows as keys (ks, vs hold them: j0 ended at i0),
      // with the incoming cotangents
      float gk[4][4] = {}, gv[4][4] = {};
      for (int c = 0; lead && c < d; ++c) {
        float av[4], ak[4], b[4], b2[4], b3[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = vs[(ty + 16 * i) * kLD + c];
          ak[i] = ks[(ty + 16 * i) * kLD + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int m = tx + 16 * j;
          b[j] = dskv[m * kLD + c];                         // d_skv^T
          b2[j] = dskv[c * kLD + m];                        // d_skv
          b3[j] = dskk[c * kLD + m] + dskk[m * kLD + c];    // d_skk + d_skk^T
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            gk[i][j] = fmaf(av[i], b[j], gk[i][j]);
            gv[i][j] = fmaf(ak[i], b2[j], gv[i][j]);
            if (p2) gk[i][j] = fmaf(ak[i], b3[j], gk[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (lead) {
            gk[i][j] += d_sk[c];
            gv[i][j] += d_sv[c];
          }
        }
      if (p2) {
        pair_out<T>(gv, ks, ds3, d, lo, hi, false, u1, u2, pm, pj);
        pair_fold<T>(acc_t, ks, vs, ds3, d, lo, hi, false, u2, u3, pm, pj);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        const size_t row = base + static_cast<size_t>(i0 + r) * d;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          if (c < d) {
            dk_acc[row + c] += gk[i][j] + acc_t[r * kLD + c];
            dv_acc[row + c] += gv[i][j];
          }
          acc_t[r * kLD + c] = 0.f;
        }
      }
    }

    // ---- 3. the cotangents take the chunk
    for (int i0 = c0; i0 < c0 + chunk; i0 += kR) {
      __syncthreads();
      load_tile(qs, q + base + static_cast<size_t>(i0) * d, d);
      load_df(df, dgr, dout, o, g, base, i0, d, n, bh);
      __syncthreads();
      if (lead && tid < d) {
        float sv = 0.f, sk = 0.f;
        for (int r = 0; r < kR; ++r) {
          sv += df[r * kLD + tid];
          sk = fmaf(dgr[r], qs[r * kLD + tid], sk);
        }
        d_sv[tid] += sv;
        d_sk[tid] += sk / z;
      }
      float akv[4][4] = {}, akk[4][4] = {};
      for (int r = 0; lead && r < kR; ++r) {
        const float dg = dgr[r];
        float a[4], b[4], b2[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qs[r * kLD + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j] = df[r * kLD + tx + 16 * j];
          b2[j] = dg * qs[r * kLD + tx + 16 * j];
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
          dskv[e] += akv[i][j] / z;
          if (p2) dskk[e] += akk[i][j] / z2;
        }
      if (p2) pair_update<T>(ds3, qs, df, d, lo, hi, true, 1.f / z2, u1, pm, pj);
    }
  }
}

// ------------------------------------------------------------ the tensor-core path

namespace tcp {

using fmtc::acc_col;
using fmtc::acc_row;
using fmtc::at;
using fmtc::from_planes;
using fmtc::from_values;
using fmtc::kLDA;
using fmtc::kLDF;
using fmtc::kMaxC;
using fmtc::kNoPair;
using fmtc::kPT;
using fmtc::kR;
using fmtc::kTileA;
using fmtc::load_rows;
using fmtc::load4;
using fmtc::mma64;
using fmtc::PairSmem;
using fmtc::quad_col0;
using fmtc::quad_row0;
using fmtc::tile_planes;
using fmtc::tr;

// CTA 0: q, k, v, df, f(s), ds, s_kv, s_kk, d_skv, d_skk (kR x kLDA) and s_k, d_sv, d_sk,
// dgr; a pair CTA: the S3/dS3 ring (2 x kPT x kLDA f32), the bfloat16 planes of v and df
// (3 x kMaxC x 64) and of the step's tile (3 x kPT x 64), q and k (kMaxC x kLDF f32) and the
// pair table
constexpr size_t kDenseBytes = sizeof(float) * (10 * kTileA + 4 * kR);
size_t smem_bytes() { return std::max(kDenseBytes, fmtc::kPairBytes); }

// df = do / g and dgr = -rowsum(do o) / g for `rows` rows from row i0; four threads a row
template <typename T>
__device__ __forceinline__ void load_df(float* df, float* dgr, const T* dout, const T* o,
                                        const float* g, size_t base, int i0, int rows, int d,
                                        int n, int bh) {
  const int quarter = threadIdx.x & 3;
  for (int r = threadIdx.x >> 2; r < rows; r += fmtc::kThreads / 4) {
    const float gv = g[static_cast<size_t>(bh) * n + i0 + r];
    float part = 0.f;
#pragma unroll
    for (int c = 16 * quarter; c < 16 * quarter + 16; c += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < d) {
        const size_t at = base + static_cast<size_t>(i0 + r) * d + c;
        x = load4(dout + at);
        const float4 y = load4(o + at);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
      float* out = df + r * kLDA + c;
      out[0] = x.x / gv;
      out[1] = x.y / gv;
      out[2] = x.z / gv;
      out[3] = x.w / gv;
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (quarter == 0) dgr[r] = -part / gv;
  }
}

// CTA 0: the intra-chunk VJP and every D x D term, float32 products by split operands
template <typename T>
__device__ __forceinline__ void dense_cta(const T* q, const T* k, const T* v, const T* dout,
                                          const T* o, const float* g, const float* skv_in,
                                          const float* sk_in, const float* skk_in, float* dq_acc,
                                          float* dk_acc, float* dv_acc, int n, int d, int chunk,
                                          float z, float* smem) {
  float* qs = smem;
  float* ks = qs + kTileA;
  float* vs = ks + kTileA;
  float* df = vs + kTileA;
  float* u1 = df + kTileA;  // f(s)
  float* u2 = u1 + kTileA;  // ds
  float* skv = u2 + kTileA;
  float* skk = skv + kTileA;
  float* dskv = skk + kTileA;
  float* dskk = dskv + kTileA;
  float* s_k = dskk + kTileA;
  float* d_sv = s_k + kR;
  float* d_sk = d_sv + kR;
  float* dgr = d_sk + kR;

  const int tid = threadIdx.x, bh = blockIdx.x;
  const int row0 = quad_row0(), col0 = quad_col0();
  const size_t base = static_cast<size_t>(bh) * n * d;
  const size_t dd = static_cast<size_t>(d) * d;
  const float z2 = 2.f * z * z;

  for (int idx = tid; idx < kTileA; idx += fmtc::kThreads) {
    const int m = idx / kLDA, c = idx % kLDA;
    const bool in = m < d && c < d;
    skv[idx] = in ? skv_in[bh * dd + m * d + c] : 0.f;
    skk[idx] = in ? skk_in[bh * dd + m * d + c] : 0.f;
    dskv[idx] = dskk[idx] = 0.f;
  }
  for (int c = tid; c < kR; c += fmtc::kThreads) {
    s_k[c] = c < d ? sk_in[static_cast<size_t>(bh) * d + c] : 0.f;
    d_sv[c] = d_sk[c] = 0.f;
  }
  __syncthreads();

  for (int c0 = n - chunk; c0 >= 0; c0 -= chunk) {
    // ---- 1. rewind the D x D state to the chunk's entry value
    for (int j0 = c0; j0 < c0 + chunk; j0 += kR) {
      __syncthreads();
      load_rows<kLDA>(ks, k + base + static_cast<size_t>(j0) * d, kR, d);
      load_rows<kLDA>(vs, v + base + static_cast<size_t>(j0) * d, kR, d);
      __syncthreads();
      if (tid < d) {
        float sk = 0.f;
        for (int r = 0; r < kR; ++r) sk += ks[r * kLDA + tid];
        s_k[tid] -= sk;
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
          skv[i] -= akv[nt][e];
          skk[i] -= akk[nt][e];
        }
    }

    // ---- 2. gradients of the chunk's rows, 64 at a time
    for (int i0 = c0; i0 < c0 + chunk; i0 += kR) {
      __syncthreads();
      load_rows<kLDA>(qs, q + base + static_cast<size_t>(i0) * d, kR, d);
      load_df<T>(df, dgr, dout, o, g, base, i0, kR, d, n, bh);
      float gq[4][4];
      fmtc::zero_acc(gq);
      for (int j0 = c0; j0 <= i0; j0 += kR) {
        __syncthreads();
        load_rows<kLDA>(ks, k + base + static_cast<size_t>(j0) * d, kR, d);
        load_rows<kLDA>(vs, v + base + static_cast<size_t>(j0) * d, kR, d);
        __syncthreads();
        float s[4][4], dp[4][4];
        fmtc::zero_acc(s);
        fmtc::zero_acc(dp);
        mma64(s, at<kLDA>(qs), tr<kLDA>(ks), d);
        mma64(dp, at<kLDA>(df), tr<kLDA>(vs), d);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = acc_row(row0, e), u = acc_col(col0, nt, e);
            const float x = s[nt][e] / z;
            float wf = 1.f + x + 0.5f * x * x, wp = 1.f + x;
            if (j0 + u > i0 + r) wf = wp = 0.f;  // causal
            u1[r * kLDA + u] = wf;
            u2[r * kLDA + u] = (dp[nt][e] + dgr[r]) * wp;
          }
        __syncthreads();
        // dq += ds k / z for the query tile; dk += ds^T q / z, dv += f(s)^T df for the keys
        float tq[4][4], tk[4][4], tv[4][4];
        fmtc::zero_acc(tq);
        fmtc::zero_acc(tk);
        fmtc::zero_acc(tv);
        mma64(tq, at<kLDA>(u2), at<kLDA>(ks), kR);
        mma64(tk, tr<kLDA>(u2), at<kLDA>(qs), kR);
        mma64(tv, tr<kLDA>(u1), at<kLDA>(df), kR);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = acc_row(row0, e), c = acc_col(col0, nt, e);
            gq[nt][e] += tq[nt][e] / z;
            if (c < d) {
              const size_t row = base + static_cast<size_t>(j0 + r) * d + c;
              dk_acc[row] += tk[nt][e] / z;
              dv_acc[row] += tv[nt][e];
            }
          }
      }
      // the q-side terms against the rewound state
      float t1[4][4], t2[4][4];
      fmtc::zero_acc(t1);
      fmtc::zero_acc(t2);
      mma64(t1, at<kLDA>(df), tr<kLDA>(skv), d);
      mma64(t2, at<kLDA>(qs), at<kLDA>(skk), d);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = acc_row(row0, e), c = acc_col(col0, nt, e);
          const float dg = dgr[r];
          float x = gq[nt][e] + t1[nt][e] / z;
          x += dg * s_k[c] / z;
          x += dg * t2[nt][e] / (z * z);
          if (c < d) dq_acc[base + static_cast<size_t>(i0 + r) * d + c] = x;
        }
      // the update-path terms for these rows as keys (ks, vs hold them: j0 ended at i0),
      // with the incoming cotangents
      float gk[4][4], gv[4][4];
      fmtc::zero_acc(gk);
      fmtc::zero_acc(gv);
      mma64(gk, at<kLDA>(vs), tr<kLDA>(dskv), d);                 // v d_skv^T
      mma64(gk, at<kLDA>(ks), [dskk](int c, int m) {              // k (d_skk + d_skk^T)
        return dskk[c * kLDA + m] + dskk[m * kLDA + c];
      }, d);
      mma64(gv, at<kLDA>(ks), at<kLDA>(dskv), d);                 // k d_skv
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = acc_row(row0, e), c = acc_col(col0, nt, e);
          if (c < d) {
            const size_t row = base + static_cast<size_t>(i0 + r) * d + c;
            dk_acc[row] += gk[nt][e] + d_sk[c];
            dv_acc[row] += gv[nt][e] + d_sv[c];
          }
        }
    }

    // ---- 3. the D x D cotangents take the chunk
    for (int i0 = c0; i0 < c0 + chunk; i0 += kR) {
      __syncthreads();
      load_rows<kLDA>(qs, q + base + static_cast<size_t>(i0) * d, kR, d);
      load_df<T>(df, dgr, dout, o, g, base, i0, kR, d, n, bh);
      __syncthreads();
      if (tid < d) {
        float sv = 0.f, sk = 0.f;
        for (int r = 0; r < kR; ++r) {
          sv += df[r * kLDA + tid];
          sk = fmaf(dgr[r], qs[r * kLDA + tid], sk);
        }
        d_sv[tid] += sv;
        d_sk[tid] += sk / z;
      }
      float akv[4][4], akk[4][4];
      fmtc::zero_acc(akv);
      fmtc::zero_acc(akk);
      mma64(akv, tr<kLDA>(qs), at<kLDA>(df), kR);
      mma64(akk, tr<kLDA>(qs), [qs, dgr](int r, int c) { return dgr[r] * qs[r * kLDA + c]; }, kR);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = acc_row(row0, e) * kLDA + acc_col(col0, nt, e);
          dskv[i] += akv[nt][e] / z;
          dskk[i] += akk[nt][e] / z2;
        }
    }
  }
}

// The pair-basis fold-back of a warp's tile t (its 16 rows x the tile's 64 pairs):
// out[r, m_p] += rnd(t x[r, j_p]), out[r, j_p] += rnd(t x[r, m_p]) (both land on m for a
// diagonal pair), the reference's (dq2 qb) E^T + (dq2 qa) F^T, on the tensor cores: t's
// C fragments, times x, are the A fragments of U = rnd(t x_j) and W = rnd(t x_m), and the
// 0/1 expansions E_m[p, c] = (m_p == c), E_j[p, c] = (j_p == c) are formed from the pair
// codes as B fragments. Each 16-pair step multiplies every 8-column tile, without
// branches, so the tiles' independent products overlap. x holds the warp's rows (row
// stride kLDF); pmj the tile's codes.
template <typename T>
__device__ __forceinline__ void fold(float (&out)[8][4], const float (&t)[8][4], const float* x,
                                     const uint16_t* pmj) {
  const int g = fmtc::lane_g(), tq = fmtc::lane_t();
  const float* x0 = x + g * kLDF;
  const float* x1 = x0 + 8 * kLDF;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (pmj[16 * kk] == kNoPair) break;  // past the pairs (the same for every lane)
    // the lane's pairs of this 16-pair step: A's columns 2 tq, 2 tq + 1, 2 tq + 8, 2 tq + 9
    int m[4], j[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int code = pmj[16 * kk + 2 * tq + (i & 1) + 8 * (i >> 1)];
      m[i] = code & 255;
      j[i] = code >> 8;
    }
    float u[8], w[8];  // A fragment order: (g, a) (g, a+1) (g+8, a) (g+8, a+1), then +8 columns
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 2 * h + (e & 1);
        const float* xr = (e >> 1) ? x1 : x0;
        const float tv = t[2 * kk + h][e];
        u[4 * h + e] = rnd<T>(tv * xr[j[i]]);
        w[4 * h + e] = rnd<T>(tv * xr[m[i]]);
      }
    const auto uf = fmtc::FoldMma<T>::prep(u), wf = fmtc::FoldMma<T>::prep(w);
#pragma unroll
    for (int nc = 0; nc < 8; ++nc) {
      const int c = 8 * nc + g;
      const uint32_t em0 = (m[0] == c ? fmtc::kOne : 0u) | (m[1] == c ? fmtc::kOne << 16 : 0u);
      const uint32_t em1 = (m[2] == c ? fmtc::kOne : 0u) | (m[3] == c ? fmtc::kOne << 16 : 0u);
      const uint32_t ej0 = (j[0] == c ? fmtc::kOne : 0u) | (j[1] == c ? fmtc::kOne << 16 : 0u);
      const uint32_t ej1 = (j[2] == c ? fmtc::kOne : 0u) | (j[3] == c ? fmtc::kOne << 16 : 0u);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      fmtc::FoldMma<T>::expand(part, uf, em0, em1);
      fmtc::FoldMma<T>::expand(part, wf, ej0, ej1);
#pragma unroll
      for (int e = 0; e < 4; ++e) out[nc][e] += part[e];
    }
  }
}

// dq2 = (rnd(df) rnd(S3)^T) w against a rewound S3 tile, folded into the warp's dq sums
template <typename T>
__device__ __forceinline__ void s3_fold(const float* sb, float (&oq)[8][4], int p0, int d,
                                        int rows) {
  const uint16_t* pmj = PairSmem::pmj() + p0;
  tile_planes<T>(sb);
  const int r0 = 16 * (threadIdx.x >> 5);
  if (r0 >= rows) return;
  float t[8][4];
  fmtc::zero_acc(t);
  fmtc::mma_planes<T, 8, false>(t, from_planes<T>(PairSmem::dfpl(), PairSmem::kRowPlane, r0),
                                PairSmem::spl(), PairSmem::kTilePlane, 0, d);
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int code = pmj[acc_col(0, nt, e)];
      if ((code & 255) != (code >> 8)) t[nt][e] *= 2.f;  // w
    }
  fold<T>(oq, t, PairSmem::qs() + r0 * kLDF, pmj);
}

// dv += K2 rnd(dS3) and the fold of dk2 = rnd(v) rnd(dS3)^T into the warp's dk sums, with
// the tile's incoming value (its planes are made here from the f32 tile)
template <typename T>
__device__ __forceinline__ void ds3_reads(const float* sb, float (&ok)[8][4], float (&gv)[8][4],
                                          int p0, int d, int rows) {
  tile_planes<T>(sb);
  const uint16_t* pmj = PairSmem::pmj() + p0;
  const int r0 = 16 * (threadIdx.x >> 5);
  if (r0 >= rows) return;
  const float* ks = PairSmem::ks();
  auto k2 = [ks, pmj](int r, int pp) {  // K2[r, pp] = rnd(k_m k_j)
    const int code = pmj[pp];
    return rnd<T>(ks[r * kLDF + (code & 255)] * ks[r * kLDF + (code >> 8)]);
  };
  fmtc::mma_planes<T, 8, true>(gv, from_values<T>(k2, r0), PairSmem::spl(),
                               PairSmem::kTilePlane, 0, kPT);
  float t[8][4];
  fmtc::zero_acc(t);
  fmtc::mma_planes<T, 8, false>(t, from_planes<T>(PairSmem::vpl(), PairSmem::kRowPlane, r0),
                                PairSmem::spl(), PairSmem::kTilePlane, 0, d);
  fold<T>(ok, t, PairSmem::ks() + r0 * kLDF, pmj);
}

// the held rows' part of the chunk's own update of a dS3 tile, dS3 += (Q2 w)^T rnd(df) /
// (2 z^2), written to the f32 tile and to device memory. Ends synchronised.
template <typename T>
__device__ __forceinline__ void ds3_update(float* sb, float* ds3, int p0, int np, int d,
                                           int rows, float inv_z2) {
  const uint16_t* pmj = PairSmem::pmj() + p0;
  const float* qs = PairSmem::qs();
  const int row0 = quad_row0(), col0 = quad_col0();
  const int pa = row0 + fmtc::lane_g(), code0 = pmj[pa], code1 = pmj[pa + 8];
  auto q2t = [qs, pa, code0, code1](int pp, int r) {  // (Q2 w)^T[pp, r] = rnd(w q_m q_j)
    const int code = pp == pa ? code0 : code1, m = code & 255, j = code >> 8;
    float a = qs[r * kLDF + m] * qs[r * kLDF + j];
    if (m != j) a *= 2.f;
    return rnd<T>(a);
  };
  float acc[4][4];
  fmtc::zero_acc(acc);
  fmtc::mma_planes<T, 4, true>(acc, from_values<T>(q2t, row0), PairSmem::dfpl(),
                               PairSmem::kRowPlane, col0, rows);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int pp = acc_row(row0, e), c = acc_col(col0, nt, e), i = pp * kLDA + c;
      if (pp < np && c < d) {
        const float updated = sb[i] + inv_z2 * acc[nt][e];
        sb[i] = updated;
        ds3[static_cast<size_t>(p0 + pp) * d + c] = updated;
      }
    }
  __syncthreads();
}

// A pair CTA: the five pair products of the pairs [lo, hi), whole 64-pair tiles. It holds
// at most kMaxC of a chunk's rows at a time (a sub-chunk) and walks its tiles in passes,
// each pass one visit to every tile with one sub-chunk held. Over S3: the rewind by every
// sub-chunk but the last, then the rewind by the last fused with its dq fold, then the dq
// folds of the others, so every fold sees the whole chunk's rewind. Over dS3: dv and the
// dk fold of every sub-chunk but the last with the incoming tile, then the last's fused
// with its share of the update, then the others' shares, so every read comes before the
// update. A chunk of at most kMaxC rows is one pass over each.
template <typename T>
__device__ __forceinline__ void pair_cta(const T* q, const T* k, const T* v, const T* dout,
                                         const T* o, const float* g, float* s3, float* ds3,
                                         float* dq_acc, float* dk_acc, float* dv_acc, int n,
                                         int d, int chunk, float z, int lo, int hi) {
  const int tid = threadIdx.x, bh = blockIdx.x;
  const size_t base = static_cast<size_t>(bh) * n * d;
  const int ntile = (hi - lo + kPT - 1) / kPT;
  const int nsub = (chunk + kMaxC - 1) / kMaxC, per = 2 * nsub - 1, steps = 2 * per * ntile;
  const float inv_z2 = 1.f / (2.f * z * z);
  const int r0 = 16 * (tid >> 5);  // the warp's rows of the sub-chunk

  fmtc::pair_setup(d);

  // stage step `step` of a chunk (its S3 passes, then its dS3 passes) into ring[step & 1]
  auto issue = [=](int step) {
    fmtc::stage_tile(PairSmem::ring(step & 1), step < per * ntile ? s3 : ds3,
                     lo + (step % ntile) * kPT, lo, hi, d);
  };
  // rows [r_beg, r_beg + rows) of the head: q and k in f32, the planes of v and of
  // rnd(df) = rnd(do / g), zero at c >= d
  auto hold = [=](int r_beg, int rows) {
    load_rows<kLDF>(PairSmem::qs(), q + base + static_cast<size_t>(r_beg) * d, rows, d);
    load_rows<kLDF>(PairSmem::ks(), k + base + static_cast<size_t>(r_beg) * d, rows, d);
    for (int idx = tid; idx < rows * 16; idx += fmtc::kThreads) {
      const int r = idx / 16, c = (idx % 16) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (c < d) {
        const size_t at = base + static_cast<size_t>(r_beg + r) * d + c;
        const float gv = g[static_cast<size_t>(bh) * n + r_beg + r];
        x = load4(v + at);
        y = load4(dout + at);
        y = make_float4(y.x / gv, y.y / gv, y.z / gv, y.w / gv);
      }
      fmtc::put_planes<T>(PairSmem::vpl(), PairSmem::kRowPlane, r, c, x.x, x.y);
      fmtc::put_planes<T>(PairSmem::vpl(), PairSmem::kRowPlane, r, c + 2, x.z, x.w);
      fmtc::put_planes<T>(PairSmem::dfpl(), PairSmem::kRowPlane, r, c, y.x, y.y);
      fmtc::put_planes<T>(PairSmem::dfpl(), PairSmem::kRowPlane, r, c + 2, y.z, y.w);
    }
  };
  // the warp's 16 rows x 64 columns of an f32 sum, scaled, into a part buffer
  auto flush = [=](const float (&acc)[8][4], float* dst, int r_beg, int rows, float scale) {
    if (r0 >= rows) return;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = acc_row(r0, e), c = acc_col(0, nt, e);
        if (c < d) dst[base + static_cast<size_t>(r_beg + r) * d + c] = acc[nt][e] * scale;
      }
  };

  for (int c0 = n - chunk; c0 >= 0; c0 -= chunk) {
    __syncthreads();
    issue(0);
    int held = -1;
    for (int pass = 0; pass < 2 * per; ++pass) {
      const bool on_s3 = pass < per;
      const int b = on_s3 ? pass : pass - per, sub = b < nsub ? b : b - nsub;
      const bool first = b < nsub, second = b >= nsub - 1;  // rewind | reads; fold | update
      const int r_beg = c0 + sub * kMaxC, rows = min(kMaxC, chunk - sub * kMaxC);
      if (sub != held) {
        if (held >= 0) __syncthreads();  // the held rows are free
        hold(r_beg, rows);
        held = sub;
      }
      float sums[8][4], gv[8][4];  // the pass's dq (or dk) and dv of the warp's rows
      fmtc::zero_acc(sums);
      fmtc::zero_acc(gv);
      for (int tile = 0; tile < ntile; ++tile) {
        const int step = pass * ntile + tile;
        // a lone tile is staged for the next pass over the same state only once written
        const bool ahead = step + 1 < steps && (ntile > 1 || step + 1 == per);
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
        if (on_s3) {
          if (first) fmtc::s3_update<T>(sb, s3, p0, np, d, rows, -1.f);
          if (second) s3_fold<T>(sb, sums, p0, d, rows);
        } else {
          if (first) ds3_reads<T>(sb, sums, gv, p0, d, rows);
          if (second) ds3_update<T>(sb, ds3, p0, np, d, rows, inv_z2);
        }
        if (step + 1 < steps && !ahead) {
          __syncthreads();  // the tile's writes are done
          issue(step + 1);
        }
      }
      if (on_s3 && second) flush(sums, dq_acc, r_beg, rows, inv_z2);
      if (!on_s3 && first) {
        flush(sums, dk_acc, r_beg, rows, 1.f);
        flush(gv, dv_acc, r_beg, rows, 1.f);
      }
    }
  }
}

// CTA 0 of a head: the intra-chunk VJP and the D x D terms; CTAs 1 .. nsplit - 1: the pair
// terms, the pairs split between them in whole 64-pair tiles
template <typename T>
__global__ void __launch_bounds__(fmtc::kThreads, 1) fastmax_bwd_tc_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const T* __restrict__ o, const float* __restrict__ g,
    const float* __restrict__ skv_in, const float* __restrict__ sk_in,
    const float* __restrict__ skk_in, float* __restrict__ s3_all, float* __restrict__ ds3_all,
    float* __restrict__ part, int n, int d, int chunk, float z, int s3_rows) {
  const int bh = blockIdx.x, split = blockIdx.y;
  const size_t total = static_cast<size_t>(gridDim.x) * n * d;
  float* dq_acc = part + static_cast<size_t>(split) * 3 * total;
  float* dk_acc = dq_acc + total;
  float* dv_acc = dk_acc + total;
  if (split == 0) {
    dense_cta<T>(q, k, v, dout, o, g, skv_in, sk_in, skk_in, dq_acc, dk_acc, dv_acc, n, d, chunk,
                 z, fm_tc_smem);
    return;
  }
  const int npairs = d * (d + 1) / 2, tiles = (npairs + kPT - 1) / kPT, ctas = gridDim.y - 1;
  const int lo = min((split - 1) * tiles / ctas * kPT, npairs);
  const int hi = min(split * tiles / ctas * kPT, npairs);
  if (lo >= hi) return;
  const size_t head = static_cast<size_t>(bh) * s3_rows * d;
  pair_cta<T>(q, k, v, dout, o, g, s3_all + head, ds3_all + head, dq_acc, dk_acc, dv_acc, n, d,
              chunk, z, lo, hi);
}

}  // namespace tcp

// dq, dk, dv = the sums of the splits' f32 buffers, in the input's type
template <typename T>
__global__ void fastmax_bwd_finish(const float* __restrict__ part, T* __restrict__ dq,
                                   T* __restrict__ dk, T* __restrict__ dv, size_t total,
                                   int nsplit) {
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; idx < total;
       idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, b = 0.f, c = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float* ps = part + static_cast<size_t>(s) * 3 * total;
      a += ps[idx];
      b += ps[total + idx];
      c += ps[2 * total + idx];
    }
    dq[idx] = from_f32<T>(a);
    dk[idx] = from_f32<T>(b);
    dv[idx] = from_f32<T>(c);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, const float* g, const float* skv, const float* sk,
                   const float* skk, float* s3, float* ds3, float* part, void* dq, void* dk,
                   void* dv, int bh, int n, int d, int chunk, int p2, float z, int s3_rows,
                   int nsplit, int tc, cudaStream_t stream) {
  // set once, before any CUDA-graph capture of a launch
  static bool smem_set = false, tc_smem_set = false;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dt = static_cast<const T*>(dout);
  const T* ot = static_cast<const T*>(o);
  cudaError_t err;
  if (tc) {
    auto kernel = tcp::fastmax_bwd_tc_kernel<T>;
    err = set_smem(kernel, tcp::smem_bytes(), tc_smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, nsplit), fmtc::kThreads, tcp::smem_bytes(), stream>>>(
        qt, kt, vt, dt, ot, g, skv, sk, skk, s3, ds3, part, n, d, chunk, z, s3_rows);
  } else {
    auto kernel = fastmax_bwd_kernel<T>;
    err = set_smem(kernel, smem_bytes(), smem_set);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(bh, nsplit), kThreads, smem_bytes(), stream>>>(
        qt, kt, vt, dt, ot, g, skv, sk, skk, s3, ds3, part, n, d, chunk, p2, z, s3_rows);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(bh) * n * d;
  const int blocks = static_cast<int>(std::min<size_t>((total + 255) / 256, 4096));
  fastmax_bwd_finish<T><<<blocks, 256, 0,
                          stream>>>(part, static_cast<T*>(dq), static_cast<T*>(dk),
                                    static_cast<T*>(dv), total, nsplit);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, o: (BH, N, D) contiguous in f32 (bf16 = 0) or bf16 (bf16 = 1); g (BH, N)
// f32; skv, skk (BH, D, D), sk (BH, D): the forward's final state. s3 (BH, s3_rows, D):
// the forward's S3, rewound in place; ds3 the same shape, zeroed. nsplit CTAs a head
// (1 unless p2); part: (nsplit, 3, BH, N, D) f32, zeroed. dq, dk, dv: (BH, N, D), the
// gradients in the input's type. tc = 1 runs fastmax_bwd_tc_kernel, which takes p2,
// D % 16 == 0 and nsplit >= 2 (CTA 0 and a pair CTA);
// tc = 0 the FMA kernel.
int fm_fastmax_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, int bf16, const float* g, const float* skv, const float* sk,
                   const float* skk, float* s3, float* ds3, float* part, void* dq, void* dk,
                   void* dv, int bh, int n, int d, int chunk, int p2, float z, int s3_rows,
                   int nsplit, int tc, cudaStream_t stream) {
  if (d < 1 || d > fm::kMaxD || chunk % fm::kR || chunk < fm::kR || n % chunk || nsplit < 1 ||
      (nsplit > 1 && !p2))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc && (!p2 || d % 16 || nsplit < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, dout, o, g, skv, sk, skk, s3, ds3, part, dq, dk,
                                   dv, bh, n, d, chunk, p2, z, s3_rows, nsplit, tc, stream)
           : launch<float>(q, k, v, dout, o, g, skv, sk, skk, s3, ds3, part, dq, dk, dv, bh, n,
                           d, chunk, p2, z, s3_rows, nsplit, tc, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
