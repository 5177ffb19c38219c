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
// State placement: s_kv, s_k, s_kk and their cotangents (69 KB at D = 64) live in
// shared memory; S3 and dS3 (532 KB each a head at D = 64) stay in device memory,
// 34 MB for the 32 heads of the training shape, inside the 50 MB L2.
//
// Parallelism: the pair terms (five products of 2 P D flops a row: the rewind,
// dq2, dk2, dv and the dS3 update; 90 % of the work at D = 64) are split over
// `nsplit` CTAs a head by ranges of pairs. Each CTA rewinds and updates its own
// rows of S3 and dS3, so the CTAs never wait on each other; split 0 also does the
// intra-chunk VJP and every D x D term. Each CTA sums its part of dq, dk and dv in
// its own f32 buffer (one CTA a buffer row, so no atomics and a fixed order), and
// fastmax_bwd_finish adds the splits' buffers and writes dq, dk, dv in the input's
// type.
//
// Bound: operations, about 2.5 times the forward's, all f32 FMAs from shared memory
// in this first version.

#include <algorithm>

#include "fastmax_common.cuh"

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
                   int nsplit, cudaStream_t stream) {
  static bool smem_set = false;  // set once, before any CUDA-graph capture of a launch
  auto kernel = fastmax_bwd_kernel<T>;
  cudaError_t err = set_smem(kernel, smem_bytes(), smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, nsplit), kThreads, smem_bytes(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const T*>(o), g, skv, sk, skk, s3, ds3, part, n,
      d, chunk, p2, z, s3_rows);
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
// gradients in the input's type.
int fm_fastmax_bwd(const void* q, const void* k, const void* v, const void* dout,
                   const void* o, int bf16, const float* g, const float* skv, const float* sk,
                   const float* skk, float* s3, float* ds3, float* part, void* dq, void* dk,
                   void* dv, int bh, int n, int d, int chunk, int p2, float z, int s3_rows,
                   int nsplit, cudaStream_t stream) {
  if (d < 1 || d > fm::kMaxD || chunk % fm::kR || chunk < fm::kR || n % chunk || nsplit < 1 ||
      (nsplit > 1 && !p2))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, dout, o, g, skv, sk, skk, s3, ds3, part, dq, dk,
                                   dv, bh, n, d, chunk, p2, z, s3_rows, nsplit, stream)
           : launch<float>(q, k, v, dout, o, g, skv, sk, skk, s3, ds3, part, dq, dk, dv, bh, n,
                           d, chunk, p2, z, s3_rows, nsplit, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
