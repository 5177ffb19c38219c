// Read-rate probes (Hopper, sm_90a): kernels whose time is the time to read
// their input from device memory, with the Pallas probes' outputs bit for bit.
//
// mode 0, stream_ref (tools/int4_opt_r05.py): tiled words (gk, gn, tk, 128) int32;
//   out (1, gn*1024) f32: at column 1024 i + l, l < 128, the f32 sum over j in
//   order of f32(word[j, i, 0, l]) (the int32 rounded to f32); zeros elsewhere.
// mode 1, stream_bytes (tools/nf4_lab_r04.py): q4 bytes (k/2, n) u8 and absmax
//   (k/64, n) f32 over J = k/tk row tiles (tk/2 byte rows each; rows past J tiles
//   are not read, as the Pallas grid does not reach them); out (1, n) f32 =
//   sum over j in order of (f32(column sum of tile j's bytes) + absmax[j tk/64]).
//
// The Pallas probes read whole blocks and use a row of each. Here every word of
// what they read is loaded and folded (xor) into a checksum, written to a small
// second output, so that no load can be dropped; the wrapper returns the
// reference's output only. Column sums are integers (exact in any order); the f32
// adds run in j order.
//
// Bound: the bytes read, at the card's memory rate. Mode 0 loads 16 bytes a
// thread, a 512-byte row a warp, the grid's warps striding over the rows; mode 1
// 4 bytes a thread (4 columns) a row over blocks of 256 columns by one tile. The
// loads are marked streaming (__ldcs): read once, not kept in the caches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColT = 64;
constexpr int kRowT = kThreads / kColT;

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// mode 0: every word into the checksum; a warp loads one 128-word row (16 bytes
// a thread) a step, 4 steps' loads in flight, the grid's warps striding over the
// rows of all blocks.
constexpr int kRowsInFlight = 4;

__global__ void __launch_bounds__(kThreads) stream_words_kernel(const uint4* __restrict__ w,
                                                                long long n_rows, int tk,
                                                                uint32_t* __restrict__ checksum) {
  uint32_t h = 0u;
  const int lane = threadIdx.x % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (blockDim.x / 32);
  for (long long row0 = static_cast<long long>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
       row0 < n_rows; row0 += warps * kRowsInFlight) {
    uint4 v[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const long long row = row0 + u * warps;
      const long long blk = row / tk, r = row % tk;  // the (j, i) block and the row in it
      v[u] = row < n_rows ? __ldcs(w + (blk * tk + r) * 32 + lane) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) h ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  h = warp_xor(h);
  if (threadIdx.x % 32 == 0) atomicXor(checksum, h);
}

// mode 0: row 0 of every (j, i) block, summed over j in order.
__global__ void stream_ref_out_kernel(const int32_t* __restrict__ w, int gk, int gn, int tk,
                                      float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= gn * 1024) return;
  const int i = col / 1024, l = col % 1024;
  float sum = 0.f;
  if (l < 128)
    for (int j = 0; j < gk; ++j)
      sum += __int2float_rn(w[(static_cast<size_t>(j) * gn + i) * tk * 128 + l]);
  out[col] = sum;
}

// mode 1: column sums of one row tile's bytes (grid: 256-column blocks x tiles),
// every byte and the tile's absmax rows into the checksum.
__global__ void __launch_bounds__(kThreads) stream_bytes_kernel(
    const uint8_t* __restrict__ q, const float* __restrict__ absmax, int n, int tk,
    int32_t* __restrict__ colsum, uint32_t* __restrict__ checksum) {
  __shared__ int red[kRowT][kColT * 4];
  const int tx = threadIdx.x % kColT, ty = threadIdx.x / kColT;
  const int col0 = blockIdx.x * kColT * 4 + tx * 4;
  const int j = blockIdx.y;
  const int rows = tk / 2;
  int s[4] = {0, 0, 0, 0};
  uint32_t h = 0u;
  if (col0 < n) {
    const uint8_t* base = q + static_cast<size_t>(j) * rows * n + col0;
    for (int r = ty; r < rows; r += kRowT) {
      const uint32_t v =
          __ldcs(reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(r) * n));
      h ^= v;
      s[0] += v & 0xFFu;
      s[1] += (v >> 8) & 0xFFu;
      s[2] += (v >> 16) & 0xFFu;
      s[3] += v >> 24;
    }
    const float* arow = absmax + static_cast<size_t>(j) * (tk / 64) * n + col0;
    for (int r = ty; r < tk / 64; r += kRowT) {
      const uint4 a = __ldcs(reinterpret_cast<const uint4*>(arow + static_cast<size_t>(r) * n));
      h ^= a.x ^ a.y ^ a.z ^ a.w;
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) red[ty][tx * 4 + c] = s[c];
  h = warp_xor(h);
  if (threadIdx.x % 32 == 0) atomicXor(checksum, h);
  __syncthreads();
  const int col = blockIdx.x * kColT * 4 + threadIdx.x;
  if (col < n) {
    int sum = 0;
#pragma unroll
    for (int t = 0; t < kRowT; ++t) sum += red[t][threadIdx.x];
    colsum[static_cast<size_t>(j) * n + col] = sum;
  }
}

__global__ void stream_bytes_out_kernel(const int32_t* __restrict__ colsum,
                                        const float* __restrict__ absmax, int n, int tiles,
                                        int tk, float* __restrict__ out) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  float sum = 0.f;
  for (int j = 0; j < tiles; ++j)
    sum += static_cast<float>(colsum[static_cast<size_t>(j) * n + col]) +
           absmax[static_cast<size_t>(j) * (tk / 64) * n + col];
  out[col] = sum;
}

}  // namespace

extern "C" {

// mode 0: words (tiles=gk, cols=gn, rows=tk, 128) int32, n_words = gk*gn*tk*128,
//   out (1, gn*1024) f32; absmax, tn, colsum unused.
// mode 1: words = q4 bytes (rows = k/2, cols = n) u8, n % 4 == 0, tiles = J,
//   absmax (k/64, n) f32 16-byte aligned, out (1, n) f32, colsum (J, n) int32
//   scratch; n_words unused.
// checksum: one uint32, zeroed by the caller. Returns the cudaError_t of the launches.
int fm_stream_probe(int mode, const void* words, long long n_words, int rows, int cols,
                    int tiles, const float* absmax, int tk, int tn, float* out, int n_out,
                    int32_t* colsum, uint32_t* checksum, cudaStream_t stream) {
  (void)tn;
  cudaError_t err;
  if (mode == 0) {
    const int32_t* w = static_cast<const int32_t*>(words);
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    stream_words_kernel<<<sms * 8, kThreads, 0, stream>>>(reinterpret_cast<const uint4*>(w),
                                                          n_words / 128, rows, checksum);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stream_ref_out_kernel<<<(n_out + 255) / 256, 256, 0, stream>>>(w, tiles, cols, rows, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int n = cols;
  const dim3 grid((n + kColT * 4 - 1) / (kColT * 4), tiles);
  stream_bytes_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const uint8_t*>(words), absmax,
                                                     n, tk, colsum, checksum);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stream_bytes_out_kernel<<<(n + 255) / 256, 256, 0, stream>>>(colsum, absmax, n, tiles, tk, out);
  return static_cast<int>(cudaGetLastError());
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
