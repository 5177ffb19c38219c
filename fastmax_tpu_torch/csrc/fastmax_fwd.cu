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
// State placement: the TPU kernel keeps the whole state in VMEM. Here s_v, s_k,
// s_kv and s_kk (17 KB at D = 64) live in shared memory, but S3 (2080 x 64 f32 =
// 532 KB a head) does not fit in the 227 KB a CTA can have, so it stays in device
// memory, where the 50 MB L2 holds all of them at the training shape (32 heads,
// 17 MB), and is streamed through shared memory 64 pairs at a time.
//
// Parallelism: with one CTA a head, the training shape (32 heads) fills 32 of the
// 132 SMs. So the pair terms, f2 and the S3 update (2 P D 64 flops each per 64-row
// tile, 85 % of the work at D = 64), are split over `nsplit` CTAs a head by
// ranges of pairs: each CTA owns its rows of S3 and writes a partial f2, and split
// 0 adds the rest of f and writes g; fastmax_fwd_finish then writes
// o = sum of the partials / g. With nsplit = 1 the CTA writes o itself.
//
// Bound: operations, all f32 FMAs from shared memory in this first version;
// wgmma on bf16 pair operands is the later work.

#include <algorithm>

#include "fastmax_common.cuh"

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
                   int d, int chunk, int p2, float z, int s3_rows, int nsplit,
                   cudaStream_t stream) {
  static bool smem_set = false;  // set once, before any CUDA-graph capture of a launch
  auto kernel = fastmax_fwd_kernel<T>;
  cudaError_t err = set_smem(kernel, smem_bytes(), smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(bh, nsplit), kThreads, smem_bytes(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), g, skv, sk, s3, skk, fpart, n, d, chunk, p2, z, s3_rows);
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
// (nsplit, BH, N, D) f32 scratch when nsplit > 1.
int fm_fastmax_fwd(const void* q, const void* k, const void* v, void* o, int bf16, float* g,
                   float* skv, float* sk, float* s3, float* skk, float* fpart, int bh, int n,
                   int d, int chunk, int p2, float z, int s3_rows, int nsplit,
                   cudaStream_t stream) {
  if (d < 1 || d > fm::kMaxD || chunk % fm::kR || chunk < fm::kR || n % chunk || nsplit < 1 ||
      (nsplit > 1 && (!p2 || g == nullptr || fpart == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(q, k, v, o, g, skv, sk, s3, skk, fpart, bh, n, d, chunk, p2,
                                   z, s3_rows, nsplit, stream)
           : launch<float>(q, k, v, o, g, skv, sk, s3, skk, fpart, bh, n, d, chunk, p2, z,
                           s3_rows, nsplit, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
