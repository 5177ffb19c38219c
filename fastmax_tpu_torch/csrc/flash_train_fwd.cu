// Trainable causal softmax attention, forward (out and log-sum-exp), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels _whole_fwd (fastmax_tpu/ops/flash_attention.py:561, entry
// flash_attention_fused) and _fwd_lse (:230, entry flash_attention_trainable). The two
// compute one function and differ only in the key block of their online softmax: 512 keys
// (or the whole T when T <= 512) for the fused entry, block_k (128) for the other. The
// block matters in bfloat16, where p is rounded against the running max of the blocks seen
// so far, so it is a run-time argument here ("ob") and this kernel serves both entries.
//
// q, k, v: (BH, T, D), k/v already repeated to the query heads; out (BH, T, D) in q's type;
// lse (BH, T) f32. Row i attends key j iff j <= i. Per row, as the reference does:
//
//   for each online block of ob keys (blocks past the row skipped: all masked, a no-op):
//     s     = (q . k) * scale in f32, masked with -1e30
//     m_new = max(m, rowmax s);  p = exp(s - m_new);  alpha = exp(m - m_new)
//     l     = l * alpha + rowsum p                (the unrounded f32 p)
//     acc   = acc * alpha + round_to_v_type(p) . v  (f32 sums)
//   out = acc / l in q's type;  lse = m + log(l).
//
// The TPU kernel walks a head's blocks in order on one core; here one CTA owns a tile of BQ
// query rows of one head (BQ = 64, or 32 for D >= 192) and loops over the online blocks
// itself, so a head's rows spread over T / BQ CTAs (2048 CTAs at B=2, H=32, T=2048). A
// block's scores are kept whole in shared memory (BQ x ob f32) until its row max is known:
// that is what lets p be rounded against the reference's running max. Keys are staged 64
// at a time. Tiles are issued heaviest first (the last query tile sees the most keys).
//
// Bound: operations, 4 D flops per visible (row, key) pair. This first version computes
// both products with f32 FMAs from shared memory (bf16 inputs are widened on load); the
// tensor-core (wgmma) and TMA version is later work. No atomics: every sum has one order,
// so repeated calls give the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;        // keys staged in shared memory at a time
constexpr int kMaxBlock = 512; // the largest online block the kernel takes
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <int D> __host__ __device__ constexpr int tile_rows() { return D <= 128 ? 64 : 32; }

// shared floats for an online block of `ob_pad` (ob rounded up to 64) keys
template <int D>
size_t smem_bytes(int ob_pad) {
  constexpr int BQ = tile_rows<D>();
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (D + 4) + kBK * (D + 1) + BQ * (ob_pad + 4) + 3 * BQ);
}

// Thread layout: ty = tid / 16 owns query rows R*ty .. R*ty+R-1 (R = BQ / 16) of the tile;
// tx = tid % 16 owns key columns tx + 16c of a staged tile (scores) and head-dim columns
// tx + 16c (the accumulator).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) flash_train_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ lse, int t_len, int ob, float scale) {
  constexpr int BQ = tile_rows<D>();
  constexpr int R = BQ / 16;
  constexpr int QS = D + 4;   // padded row strides: the 16 key columns of a warp
  constexpr int KS = D + 1;   // fall on distinct banks
  constexpr int CD = D / 16;  // accumulator columns per thread
  const int ob_pad = (ob + kBK - 1) / kBK * kBK;
  const int SS = ob_pad + 4;
  extern __shared__ float smem[];
  float* qs = smem;                 // (BQ, QS)  query tile
  float* kvs = qs + BQ * QS;        // (kBK, KS) staged keys, then values
  float* ss = kvs + kBK * KS;       // (BQ, SS)  a block's scores, then p rounded to T
  float* m_s = ss + BQ * SS;        // (BQ) running max
  float* l_s = m_s + BQ;            // (BQ) running sum
  float* a_s = l_s + BQ;            // (BQ) this block's alpha

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y;
  const int tile = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = tile * BQ;
  const int rows = min(BQ, t_len - q0);
  const int last_row = q0 + rows - 1;
  const size_t head = static_cast<size_t>(bh) * t_len * D;
  const T* qb = q + head + static_cast<size_t>(q0) * D;
  const T* kb = k + head;
  const T* vb = v + head;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    qs[r * QS + c] = r < rows ? to_f32(qb[static_cast<size_t>(r) * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[R][CD];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 <= last_row; k0 += ob) {
    // keys past the tile's last row are masked for every row of it: leaving them out of
    // the block changes neither its max nor its sums
    const int kend = min(k0 + ob, last_row + 1);
    const int nk = kend - k0;
    // ---- the block's scores, one staged tile of keys at a time
    for (int kt = k0; kt < kend; kt += kBK) {
      __syncthreads();  // kvs is free
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kt + r;
        kvs[r * KS + c] = key < kend ? to_f32(kb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
      float sc[R][4];
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[R], kv[4];
#pragma unroll
        for (int i = 0; i < R; ++i) qv[i] = qs[(R * ty + i) * QS + d];
#pragma unroll
        for (int c = 0; c < 4; ++c) kv[c] = kvs[(tx + 16 * c) * KS + d];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(qv[i], kv[c], sc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int qpos = q0 + R * ty + i;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = kt + tx + 16 * c;
          const bool ok = key <= qpos && key < kend;
          if (key < kend) ss[(R * ty + i) * SS + key - k0] = ok ? sc[i][c] * scale : kNegInf;
        }
      }
    }
    __syncthreads();
    // ---- online softmax: warp w takes rows w*BQ/8 .. ; lanes stride over the block
    for (int r = warp * (BQ / kWarps); r < (warp + 1) * (BQ / kWarps); ++r) {
      float* row = ss + r * SS;
      float mx = kNegInf;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(row[j] - m_new);
        sum += p;
        row[j] = round_to<T>(p);
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
    for (int i = 0; i < R; ++i) {
      const float alpha = a_s[R * ty + i];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    // ---- acc += p . v, one staged tile of values at a time
    for (int kt = k0; kt < kend; kt += kBK) {
      __syncthreads();  // kvs was last read by the score pass or the previous tile
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int r = i / D, c = i % D;
        const int key = kt + r;
        kvs[r * KS + c] = key < kend ? to_f32(vb[static_cast<size_t>(key) * D + c]) : 0.f;
      }
      __syncthreads();
      const int nj = min(kBK, kend - kt);
      const float* pb = ss + (kt - k0);
      for (int j = 0; j < nj; ++j) {
        float pv[R], vv[CD];
#pragma unroll
        for (int i = 0; i < R; ++i) pv[i] = pb[(R * ty + i) * SS + j];
#pragma unroll
        for (int c = 0; c < CD; ++c) vv[c] = kvs[j * KS + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
      }
    }
  }
  __syncthreads();
  T* ob_out = out + head + static_cast<size_t>(q0) * D;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = R * ty + i;
    if (r < rows) {
      const float l = l_s[r];
#pragma unroll
      for (int c = 0; c < CD; ++c)
        ob_out[static_cast<size_t>(r) * D + tx + 16 * c] = from_f32<T>(acc[i][c] / l);
      if (tx == 0) lse[static_cast<size_t>(bh) * t_len + q0 + r] = m_s[r] + logf(l);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                   int t_len, int ob, float scale, cudaStream_t stream) {
  auto kernel = flash_train_fwd_kernel<T, D>;
  // set once for the largest block, before any CUDA-graph capture of a launch
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes<D>(kMaxBlock)));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  constexpr int BQ = tile_rows<D>();
  const dim3 grid((t_len + BQ - 1) / BQ, bh);
  kernel<<<grid, kThreads, smem_bytes<D>((ob + kBK - 1) / kBK * kBK), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, t_len, ob, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out, float* lse, int bh,
                     int t_len, int d, int ob, float scale, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 128: return launch<T, 128>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 192: return launch<T, 192>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    case 256: return launch<T, 256>(q, k, v, out, lse, bh, t_len, ob, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, k, v, out: (BH, T, D) contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1); lse: (BH, T) f32.
// D is 64, 128, 192 or 256; T >= 1; 1 <= ob <= 512 (the online block, in keys).
int fm_flash_train_fwd(const void* q, const void* k, const void* v, void* out, void* lse,
                       int bf16, int bh, int t_len, int d, int ob, float scale,
                       cudaStream_t stream) {
  if (ob < 1 || ob > kMaxBlock || t_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  float* l = static_cast<float*>(lse);
  const cudaError_t err =
      bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, l, bh, t_len, d, ob, scale, stream)
           : launch_d<float>(q, k, v, out, l, bh, t_len, d, ob, scale, stream);
  return static_cast<int>(err);
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
