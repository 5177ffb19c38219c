// Causal flash attention (forward) for KV-cache prefill, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel flash_attention (fastmax_tpu/ops/flash_attention.py).
// q: (B, Hq, T, D); k, v: (B, G, S, D) in q's dtype (float32 or bfloat16), read at
// group granularity: query head h uses kv head h / (Hq / G), with no expanded copy.
// Query row i (absolute position pos0 + i) attends key j iff j <= pos0 + i and
// j < kv_len. The arithmetic is the Pallas kernel's, block for block:
//
//   for each key block of 128 (blocks past the causal frontier or kv_len skipped):
//     s     = (q . k) * scale in f32, masked with -1e30
//     m_new = max(m, rowmax(s));  p = exp(s - m_new);  alpha = exp(m - m_new)
//     l     = l * alpha + rowsum(p)                      (the unrounded f32 p)
//     acc   = acc * alpha + round_to_v_dtype(p) . v       (f32 accumulation)
//   out = acc / (l == 0 ? 1 : l), in q's dtype.
//
// The TPU grid walks the key blocks in order with (m, l, acc) in VMEM scratch;
// here one CTA owns a 64-row query tile of one head and loops over the key
// blocks itself, keeping (m, l) in shared memory and acc in registers. Only
// the T real rows are written: a ragged last tile is masked, not padded.
//
// Bound: at prefill lengths, operations (4 * D flops per visible (row, key)
// pair) against the f32 FMA rate, since this first version computes both
// products with f32 FMAs from shared memory; the tensor-core (wgmma) version
// is later work. The k/v tile is staged in two 64-key halves so a CTA uses
// ~100 KB of shared memory at D=128 and two CTAs fit on an SM; D=192 and 256
// (134 and 167 KB) run one CTA an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;    // query rows per CTA
constexpr int kBK = 128;   // keys per online-softmax block (the Pallas block_k)
constexpr int kHK = 64;    // keys staged in shared memory at a time
constexpr int kSS = kBK + 4;  // padded row stride of the score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <int D>
constexpr int smem_floats() {
  return kBQ * (D + 4) + kHK * (D + 1) + kBQ * kSS + 3 * kBQ;
}

// Thread layout: ty = tid / 16 owns query rows 4*ty .. 4*ty+3 of the tile;
// tx = tid % 16 owns key columns tx + 16*c of a staged half (scores) and
// head-dim columns tx + 16*c (the accumulator).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int hq, int g_count, int t_len, int s_len, int pos0, int kv_len,
    float scale) {
  constexpr int QS = D + 4;   // padded row strides: the two row groups of a warp
  constexpr int KS = D + 1;   // and the 16 key columns fall on distinct banks
  constexpr int CD = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                 // (kBQ, QS)  query tile
  float* kvs = qs + kBQ * QS;       // (kHK, KS)  half a key block of k, then of v
  float* ss = kvs + kHK * KS;       // (kBQ, kSS) scores, then p rounded to T
  float* m_s = ss + kBQ * kSS;      // (kBQ) running max
  float* l_s = m_s + kBQ;           // (kBQ) running sum
  float* a_s = l_s + kBQ;           // (kBQ) this block's alpha

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / hq, h = bh % hq;
  const int kvh = b * g_count + h / (hq / g_count);
  const int q0 = blockIdx.x * kBQ;
  const int rows = min(kBQ, t_len - q0);
  const T* qb = q + (static_cast<size_t>(bh) * t_len + q0) * D;
  const T* kb = k + static_cast<size_t>(kvh) * s_len * D;
  const T* vb = v + static_cast<size_t>(kvh) * s_len * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * QS + c] = r < rows ? to_f32(qb[static_cast<size_t>(r) * D + c]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  // key blocks needed by some real row of the tile: below kv_len and at or
  // below the last row's causal frontier (a skipped block is one the Pallas
  // kernel skips, or one whose every score is masked: exp gives 0, alpha 1)
  const int frontier = pos0 + q0 + rows - 1;
  const int n_blocks = max(0, min((min(kv_len, s_len) + kBK - 1) / kBK, frontier / kBK + 1));

  for (int jb = 0; jb < n_blocks; ++jb) {
    const int k0 = jb * kBK;
    // ---- scores of this block, one staged half at a time
    for (int half = 0; half < kBK / kHK; ++half) {
      const int kh0 = k0 + half * kHK;
      __syncthreads();  // kvs is free (last read by the previous value pass)
      for (int i = tid; i < kHK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kh0 + r;
        kvs[r * KS + c] = key < s_len ? to_f32(kb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
      float sc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = kvs[(tx + 16 * c) * KS + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qpos = pos0 + q0 + 4 * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kh0 + tx + 16 * c;
          const bool ok = key <= qpos && key < kv_len;
          ss[(4 * ty + i) * kSS + half * kHK + tx + 16 * c] = ok ? sc[i][c] * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    // ---- online softmax: warp w takes rows 8w .. 8w+7, each lane 4 columns
    const int lane = tid % 32, warp = tid / 32;
    for (int r = warp * (kBQ / kWarps); r < (warp + 1) * (kBQ / kWarps); ++r) {
      float* row = ss + r * kSS;
      float s4[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s4[c] = row[lane + 32 * c];
        mx = fmaxf(mx, s4[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s4[c] - m_new);
        sum += p;
        row[lane + 32 * c] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[4 * ty + i];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    // ---- acc += p . v, one staged half at a time
    for (int half = 0; half < kBK / kHK; ++half) {
      const int kh0 = k0 + half * kHK;
      __syncthreads();  // kvs was last read by the score pass
      for (int i = tid; i < kHK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kh0 + r;
        kvs[r * KS + c] = key < s_len ? to_f32(vb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < kHK; ++j) {
        float pv[4], vv[CD];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = ss[(4 * ty + i) * kSS + half * kHK + j];
#pragma unroll
        for (int c = 0; c < CD; ++c) vv[c] = kvs[j * KS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<size_t>(bh) * t_len + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r < rows) {
      const float l = l_s[r];
      const float inv_l = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
      for (int c = 0; c < CD; ++c)
        ob[static_cast<size_t>(r) * D + tx + 16 * c] = from_f32<T>(acc[i][c] * inv_l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int b, int hq,
                   int g, int t_len, int s_len, int pos0, int kv_len, float scale,
                   cudaStream_t stream) {
  auto kernel = flash_attention_kernel<T, D>;
  const size_t smem = sizeof(float) * smem_floats<D>();
  static bool smem_set = false;  // set once, before any CUDA-graph capture of a launch
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const dim3 grid((t_len + kBQ - 1) / kBQ, b * hq);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), hq, g, t_len, s_len, pos0, kv_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, int b, int hq,
                     int g, int t_len, int s_len, int d, int pos0, int kv_len, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale, stream);
    case 192:
      return launch<T, 192>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, b, hq, g, t_len, s_len, pos0, kv_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, Hq, T, D); k, v: (B, G, S, D); out: (B, Hq, T, D); all contiguous, in
// f32 (bf16 = 0) or bf16 (bf16 = 1). D is 64, 128, 192 or 256; Hq % G == 0; T >= 1.
int fm_flash_attention(const void* q, const void* k, const void* v, void* out, int bf16,
                       int b, int hq, int g, int t_len, int s_len, int d, int pos0,
                       int kv_len, float scale, cudaStream_t stream) {
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, b, hq, g, t_len, s_len, d, pos0, kv_len,
                                     scale, stream)
           : launch_d<float>(q, k, v, out, b, hq, g, t_len, s_len, d, pos0, kv_len, scale,
                             stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
