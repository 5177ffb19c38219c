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
// what they read is loaded and folded (xor) into a checksum, one word a block
// written to the caller's scratch, so that no load can be dropped; the wrapper
// returns the reference's output only. Column sums are integers (exact in any
// order); the f32 adds run in j order.
//
// Bound: the bytes read, at the card's memory rate. One launch a call, and no
// memset: every output and every checksum word is written by the kernel.
// * mode 0: a persistent grid (the caller's block count, about 2 an SM); each
//   block streams one contiguous range of the words, 8 loads of 16 bytes a thread
//   in flight (32 KB a block), marked streaming (__ldcs); the blocks also write
//   the output, reading row 0 of each (j, i) block again (a 128th of the words).
// * mode 1: a block takes a strip of 128 columns (16 bytes a thread, or 32
//   columns of 4 bytes where n % 16 != 0) and a run of row tiles (the wrapper's
//   plan: the busiest SM reads as few tiles as one wave allows); a tile's bytes,
//   its absmax rows and the absmax it adds are loaded at once (8 loads of 16 bytes
//   a thread, 32 KB a block, in flight), its column sums go through shared memory
//   into f32(sum) + absmax, written to the tile's row of `vals`. Each block then
//   counts itself in its strip's counter; the last to arrive adds the tiles' values
//   in j order, writes out and sets the counter back to zero for the next call (a
//   thread-block cluster cost more in its launch than the whole reduction).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;      // mode 0: 16-byte loads in flight a thread
constexpr int kColThreads = 8;  // mode 1: threads across a strip
constexpr int kRowThreads = kThreads / kColThreads;
constexpr int kBatch = 8;       // mode 1: rows in flight a thread (8 * 255 fits 16 bits)
constexpr int kMaxSplits = 16;  // mode 1
constexpr int kBlocksPerSm = 4; // mode 1

__device__ __forceinline__ uint32_t fold(uint4 v) { return v.x ^ v.y ^ v.z ^ v.w; }
__device__ __forceinline__ uint32_t fold(uint32_t v) { return v; }

// The xor of every thread's h into checksum[0].
__device__ __forceinline__ void block_checksum(uint32_t h, uint32_t* checksum) {
  __shared__ uint32_t warps[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) h ^= __shfl_xor_sync(0xffffffffu, h, o);
  if (threadIdx.x % 32 == 0) warps[threadIdx.x / 32] = h;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t all = 0u;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) all ^= warps[i];
    *checksum = all;
  }
}

// mode 0 (grid: the persistent blocks): the output, then every word into the checksum.
__global__ void __launch_bounds__(kThreads) stream_words_kernel(
    const int32_t* __restrict__ w, long long n16, int gk, int gn, int tk,
    float* __restrict__ out, uint32_t* __restrict__ checksum) {
  for (int col = blockIdx.x * kThreads + threadIdx.x; col < gn * 1024;
       col += gridDim.x * kThreads) {
    const int i = col / 1024, l = col % 1024;
    float sum = 0.f;
    if (l < 128)
      for (int j = 0; j < gk; ++j)
        sum += __int2float_rn(w[(static_cast<size_t>(j) * gn + i) * tk * 128 + l]);
    out[col] = sum;
  }
  const uint4* src = reinterpret_cast<const uint4*>(w);
  const long long per = (n16 + gridDim.x - 1) / gridDim.x;
  const long long first = blockIdx.x * per, last = min(n16, first + per);
  uint32_t h = 0u;
  for (long long i = first + threadIdx.x; i < last; i += kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long at = i + static_cast<long long>(u) * kThreads;
      v[u] = at < last ? __ldcs(src + at) : make_uint4(0u, 0u, 0u, 0u);
    }
    for (int u = 0; u < kUnroll; ++u) h ^= fold(v[u]);  // every load into the checksum
  }
  block_checksum(h, checksum + blockIdx.x);
}

// Byte column sums of one load, added to s: VEC bytes = VEC columns.
template <int VEC> struct Bytes;
template <> struct Bytes<16> {
  using T = uint4;
  static __device__ __forceinline__ T load(const uint8_t* p) {
    return __ldcs(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ T zero() { return make_uint4(0u, 0u, 0u, 0u); }
};
template <> struct Bytes<4> {
  using T = uint32_t;
  static __device__ __forceinline__ T load(const uint8_t* p) {
    return __ldcs(reinterpret_cast<const unsigned int*>(p));
  }
  static __device__ __forceinline__ T zero() { return 0u; }
};

__device__ __forceinline__ void words_of(const uint4& v, uint32_t w[4]) {
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void words_of(uint32_t v, uint32_t w[1]) { w[0] = v; }

// The calling block's arrival at *counter, counted at device scope with acquire and
// release: after a __syncthreads, the writes of every thread of the block are
// visible to the block that counts last, once it passes a __syncthreads of its own.
// Returns the count before.
__device__ __forceinline__ int count_arrival(int* counter) {
  int before;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(before) : "l"(counter) : "memory");
  return before;
}

// mode 1 (grid: (splits, strips)): block (s, b) reads tiles [s * per, (s + 1) *
// per) of strip b. vals: (tiles, n) f32 scratch; counter: one int a strip, zero.
template <int VEC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) stream_bytes_kernel(
    const uint8_t* __restrict__ q, const float* __restrict__ absmax, int n, int tiles, int tk,
    int per, float* __restrict__ out, uint32_t* __restrict__ checksum, float* __restrict__ vals,
    int* __restrict__ counter) {
  constexpr int kCols = kColThreads * VEC;  // columns of a strip
  constexpr int kWords = VEC / 4;
  __shared__ int red[kRowThreads][kCols];
  __shared__ bool last;
  const int split = blockIdx.x, splits = gridDim.x;
  const int col0 = blockIdx.y * kCols;
  const int tx = threadIdx.x % kColThreads, ty = threadIdx.x / kColThreads;
  const bool in = col0 + tx * VEC < n;  // n % VEC == 0: a load is all in or all out
  const int rows = tk / 2;
  const int arows = tk / 64;  // absmax rows of a tile
  const int j0 = split * per, j1 = min(tiles, j0 + per);
  uint32_t h = 0u;
  for (int j = j0; j < j1; ++j) {
    // the absmax this tile adds, and its absmax rows into the checksum, loaded first
    const int acol = col0 + threadIdx.x;
    const float a0 = threadIdx.x < kCols && acol < n
                         ? absmax[static_cast<size_t>(j * arows) * n + acol] : 0.f;
    for (int e = threadIdx.x; e < arows * (kCols / 4); e += kThreads) {
      const int col = col0 + (e % (kCols / 4)) * 4;
      if (col < n)
        h ^= fold(__ldcs(reinterpret_cast<const uint4*>(
            absmax + static_cast<size_t>(j * arows + e / (kCols / 4)) * n + col)));
    }
    int s[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) s[c] = 0;
    const uint8_t* base = q + static_cast<size_t>(j) * rows * n + col0 + tx * VEC;
    for (int r0 = ty; r0 < rows; r0 += kRowThreads * kBatch) {
      typename Bytes<VEC>::T v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int r = r0 + b * kRowThreads;
        v[b] = in && r < rows ? Bytes<VEC>::load(base + static_cast<size_t>(r) * n)
                              : Bytes<VEC>::zero();
      }
      for (int b = 0; b < kBatch; ++b) h ^= fold(v[b]);
      uint32_t even[kWords], odd[kWords];  // 16-bit sums of bytes 0, 2 and 1, 3 of each word
#pragma unroll
      for (int e = 0; e < kWords; ++e) even[e] = odd[e] = 0u;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        uint32_t wd[kWords];
        words_of(v[b], wd);
#pragma unroll
        for (int e = 0; e < kWords; ++e) {
          even[e] += wd[e] & 0x00FF00FFu;
          odd[e] += (wd[e] >> 8) & 0x00FF00FFu;
        }
      }
#pragma unroll
      for (int e = 0; e < kWords; ++e) {
        s[4 * e] += even[e] & 0xFFFFu;
        s[4 * e + 1] += odd[e] & 0xFFFFu;
        s[4 * e + 2] += even[e] >> 16;
        s[4 * e + 3] += odd[e] >> 16;
      }
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c) red[ty][tx * VEC + c] = s[c];
    __syncthreads();
    if (threadIdx.x < kCols) {
      int sum = 0;
#pragma unroll
      for (int r = 0; r < kRowThreads; ++r) sum += red[r][threadIdx.x];
      if (acol < n) vals[static_cast<size_t>(j) * n + acol] = static_cast<float>(sum) + a0;
    }
    __syncthreads();
  }
  block_checksum(h, checksum + blockIdx.y * splits + split);
  __syncthreads();
  if (threadIdx.x == 0) last = count_arrival(counter + blockIdx.y) == splits - 1;
  __syncthreads();
  if (!last) return;
  const int col = col0 + threadIdx.x;
  if (threadIdx.x < kCols && col < n) {
    float sum = 0.f, v[8];
    for (int j0 = 0; j0 < tiles; j0 += 8) {  // 8 tiles' values loaded, then added in order
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = j0 + u < tiles ? __ldcg(vals + static_cast<size_t>(j0 + u) * n + col) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < tiles) sum += v[u];
    }
    out[col] = sum;
  }
  if (threadIdx.x == 0) counter[blockIdx.y] = 0;  // zero again for the next call
}

template <int VEC>
cudaError_t launch_bytes(const uint8_t* q, const float* absmax, int n, int tiles, int tk,
                         int splits, int per, float* out, uint32_t* checksum, float* vals,
                         int* counter, cudaStream_t stream) {
  constexpr int kCols = kColThreads * VEC;
  const dim3 grid(splits, (n + kCols - 1) / kCols);
  stream_bytes_kernel<VEC><<<grid, kThreads, 0, stream>>>(q, absmax, n, tiles, tk, per, out,
                                                           checksum, vals, counter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode 0: words (tiles=gk, cols=gn, tk, 128) int32, n_words = gk*gn*tk*128,
//   out (1, gn*1024) f32; grid blocks, checksum[grid]; absmax, per, vals, counter
//   unused.
// mode 1: words = q4 bytes (rows >= tiles*tk/2, cols = n) u8, n % 4 == 0, tk % 64
//   == 0, absmax (>= tiles*tk/64, n) f32 16-byte aligned, out (1, n) f32; the tiles
//   in grid splits of per (1 <= grid <= 16, every split non-empty), checksum[grid *
//   strips], strips = ceil(n / 128) where n % 16 == 0, else ceil(n / 32), vals
//   (tiles, n) f32 scratch, counter[strips] zero (each call leaves them zero);
//   n_words unused. Returns the cudaError_t of the launch.
int fm_stream_probe(int mode, const void* words, long long n_words, int tk, int cols, int tiles,
                    const float* absmax, float* out, int grid, int per, uint32_t* checksum,
                    float* vals, int* counter, cudaStream_t stream) {
  if (mode == 0) {
    if (grid < 1 || n_words % 4) return static_cast<int>(cudaErrorInvalidValue);
    stream_words_kernel<<<grid, kThreads, 0, stream>>>(static_cast<const int32_t*>(words),
                                                        n_words / 4, tiles, cols, tk, out,
                                                        checksum);
    return static_cast<int>(cudaGetLastError());
  }
  if (cols % 4 || tk % 64 || grid < 1 || grid > kMaxSplits || per < 1 ||
      (grid - 1) * per >= tiles || grid * per < tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* q = static_cast<const uint8_t*>(words);
  return static_cast<int>(
      cols % 16 == 0
          ? launch_bytes<16>(q, absmax, cols, tiles, tk, grid, per, out, checksum, vals, counter,
                             stream)
          : launch_bytes<4>(q, absmax, cols, tiles, tk, grid, per, out, checksum, vals, counter,
                            stream));
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
