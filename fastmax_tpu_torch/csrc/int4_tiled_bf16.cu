// Raw signed int4 nibbles of tiled words times bf16 x on the tensor cores
// (Hopper, sm_90a):
//   y[m, n] = sum_k x[m, k] * q[k, n],   x bf16, q in [-8, 7], sums in f32,
// for every column of the packed order (column = tile*1024 + plane*128 + lane).
//
// Replaces the Pallas TPU kernels of the tools/ experiments that take this product
// with bf16 operands: bf16_matmul (tools/int4_opt_r05.py, onedot False and True:
// the same function), m8_matmul with dtype=bf16 (tools/int4_opt_r04.py) and
// _run_v12 with bf16=True (tools/nf4_variants_r04.py; its u and v stay outside).
// A nibble is exact in bf16 and every product is exact in f32, so the only
// freedom is the order of the f32 sums.
//
// Layout: the tiled words of K1/K9 (int4_tiled.cuh): word (gk_i, gn_i, r, lane)
// holds in nibble p the code of row gk_i*tk + r, column gn_i*1024 + p*128 + lane.
//
// Bound: 0.5 byte per weight read from device memory; 2 m k n operations on the
// tensor cores, far below the bytes at m <= 64. At m <= 8 the decode, not the
// mma, is the work: about 140 instructions a warp for each kilobyte of words, so
// the SMs must issue well and every SM must stream. What the design does:
//
// * Bytes in flight, no block barrier in the stream. A block takes a 16-lane unit
//   of a column tile (64 bytes of each packed row, 128 columns), 8 rows of x and
//   one k split; its 4 warps take the split's 16-row steps in turn (warp w steps
//   w, w + 4, ...). Each warp streams its steps through its own ring of kRing
//   slots in shared memory, filled by cp.async (16-byte copies: a step's 1 KB of
//   words and its 16 k of x), kRing - 1 steps in flight, waited on by the warp
//   alone (cp.async.wait_group + __syncwarp): 3 KB a warp, about 70 KB an SM at
//   kBlocksPerSm blocks, and no register holds a word in flight, so the decode
//   keeps the registers for occupancy. (A ring shared by the block, one barrier a
//   stage, made the warps wait on each other; words held in registers left too
//   few bytes in flight, or too few warps: PERF.md.) A slot's rows are 80 bytes
//   apart and its rows of x 48, so a warp's reads meet no bank conflict. The
//   wrapper picks the splits so that the busiest SM streams as few rows as one
//   wave allows (lab_kernels.k10_plan).
// * Decode. Each thread's 8 words of a step (lanes 2g, 2g + 1 at k rows 2t, 2t+1,
//   2t+8, 2t+9) become the A operands of mma.sync m16n8k16 (bf16 in, f32 sums),
//   one a plane, with K9's decoder (nibble_bytes + code_pair_bf16x2: three
//   instructions a bf16 pair). A rows g, g + 8 are lanes 2g, 2g + 1 of the unit;
//   B is 16 k by the 8 rows of x, zero past m.
// * One launch, deterministic. Each block adds its warps' sums in warp order in
//   shared memory, kept compact (rows floats a column, rows = the chunk's rows of
//   x), writes them to its split's slot of `part`, and counts itself in its unit's
//   counter; the last block of the unit to arrive adds the splits' sums in split
//   order, writes y and sets the counter back to zero, so the next call (or a CUDA
//   graph's replay) finds it zero. No float atomics, and a repeat gives the same
//   bits. (The splits as a thread-block cluster, added through distributed shared
//   memory, cost more in the cluster launch than the whole reduction: PERF.md.)

#include "int4_tiled.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace int4t;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kUnitLanes = 16;                      // lanes of a packed row a block takes
constexpr int kSlices = kLanes / kUnitLanes;        // units of a 1024-column tile
constexpr int kCols = kUnitLanes * 8;               // columns of a block
constexpr int kStep = 16;                           // k rows of one mma
constexpr int kSplitRows = kWarps * kStep;          // a split is whole rounds of the warps
constexpr int kMChunk = 8;                          // rows of x in one B tile
constexpr int kRing = 4;                            // slots of a warp's ring
constexpr int kRowPitch = kUnitLanes * 4 + 16;      // bytes between a slot's rows of words
constexpr int kXPitch = 48;                         // bytes between a slot's rows of x
constexpr int kSlotBytes = kStep * kRowPitch + kMChunk * kXPitch;
constexpr int kSmemBytes = kWarps * kRing * kSlotBytes;
constexpr int kBlocksPerSm = 6;
constexpr int kMaxSplits = 8;
static_assert(kSlotBytes % 16 == 0 && kWarps * kCols * kMChunk * 4 <= kSmemBytes, "smem");

// The calling block's arrival at *counter, counted at device scope with acquire and
// release: after a __syncthreads, the writes of every thread of the block are
// visible to the block that counts last, once it passes a __syncthreads of its own.
// Returns the count before.
__device__ __forceinline__ int count_arrival(int* counter) {
  int before;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n" : "=r"(before) : "l"(counter) : "memory");
  return before;
}

// grid: (splits, gn * kSlices, m chunks of 8); part: kCols * kMChunk floats for each
// block, by (chunk, unit, split); counter: one int for each (chunk, unit), zero
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) int4_tiled_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, int m, const int32_t* __restrict__ w, int gk, int gn,
    int tk, int rows_per_split, float* __restrict__ y, float* __restrict__ part,
    int* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem[];  // the warps' rings, then their sums
  __shared__ bool last;
  const int split = blockIdx.x, splits = gridDim.x;
  const int gni = blockIdx.y / kSlices;
  const int lane0 = (blockIdx.y % kSlices) * kUnitLanes;
  const int m0 = blockIdx.z * kMChunk;
  const int rows = min(kMChunk, m - m0);  // rows of x, and of y, of this chunk
  const int k = gk * tk;
  const int k0 = split * rows_per_split, k1 = min(k0 + rows_per_split, k);
  const int steps = (k1 - k0) / kStep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* ring = smem + warp * kRing * kSlotBytes;

  // the split's step st into slot s of this warp's ring: 64 16-byte pieces of
  // words (row c / 4, piece c % 4) and up to 16 of x (row c / 2, half c % 2); one
  // commit group a step, empty past the last
  auto fill = [&](int s, int st) {
    if (st < steps) {
      unsigned char* slot = ring + s * kSlotBytes;
      const int ks = k0 + st * kStep;
#pragma unroll
      for (int c = lane; c < kStep * 4; c += 32)
        cp_async16(slot + (c / 4) * kRowPitch + (c % 4) * 16,
                   word_ptr(w, ks + c / 4, gni, gk, gn, tk) + lane0 + (c % 4) * 4, true);
      if (lane < 2 * rows)
        cp_async16(slot + kStep * kRowPitch + (lane / 2) * kXPitch + (lane % 2) * 16,
                   x + static_cast<size_t>(m0 + lane / 2) * k + ks + (lane % 2) * 8, true);
    }
    cp_async_commit();
  };

  float acc[8][4];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[p][j] = 0.f;

  // k rows of this thread's fragments within a step: 2t, 2t+1, 2t+8, 2t+9
  const int rofs[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) fill(s, warp + s * kWarps);
  for (int it = 0, st = warp; st < steps; ++it, st += kWarps) {
    cp_async_wait<kRing - 2>();
    __syncwarp();  // the step landed for every lane; every lane is done with the slot refilled
    fill((it + kRing - 1) % kRing, st + (kRing - 1) * kWarps);
    const unsigned char* slot = ring + (it % kRing) * kSlotBytes;
    uint32_t n[2][4][2];  // nibble_bytes of lane 2g (A row g) and 2g + 1 (A row g + 8)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint2 wv = *reinterpret_cast<const uint2*>(slot + rofs[r] * kRowPitch + 8 * g);
      nibble_bytes(wv.x, n[0][r]);
      nibble_bytes(wv.y, n[1][r]);
    }
    uint32_t b0 = 0u, b1 = 0u;  // B column g: x row m0 + g at k 2t, 2t+1 and 2t+8, 2t+9
    if (g < rows) {
      const unsigned char* xs = slot + kStep * kRowPitch + g * kXPitch + 4 * t;
      b0 = *reinterpret_cast<const uint32_t*>(xs);
      b1 = *reinterpret_cast<const uint32_t*>(xs + 16);
    }
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const uint32_t a[4] = {code_pair_bf16x2(n[0][0], n[0][1], p),   // row g, k 2t, 2t+1
                             code_pair_bf16x2(n[1][0], n[1][1], p),   // row g+8
                             code_pair_bf16x2(n[0][2], n[0][3], p),   // row g, k 2t+8, 2t+9
                             code_pair_bf16x2(n[1][2], n[1][3], p)};  // row g+8
      mma_bf16(acc[p], a, b0, b1);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are free: each warp's sums go there
  float* red = reinterpret_cast<float*>(smem);

  // acc[p][j]: lane 2g + (j >> 1) of the unit in plane p, x row m0 + 2t + (j & 1);
  // block column c = p * kUnitLanes + lane, its rows at c * rows + i
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 2 * t + (j & 1);
      const int c = p * kUnitLanes + 2 * g + (j >> 1);
      if (i < rows) red[warp * kCols * kMChunk + c * rows + i] = acc[p][j];
    }
  __syncthreads();
  const int outs = kCols * rows;
  const int uc = blockIdx.z * gridDim.y + blockIdx.y;  // this block's (chunk, unit)
  float* const slots = part + static_cast<size_t>(uc) * splits * kCols * kMChunk;
  for (int e = threadIdx.x; e < outs; e += kThreads) {
    float sum = red[e];
#pragma unroll
    for (int wi = 1; wi < kWarps; ++wi) sum += red[wi * kCols * kMChunk + e];
    slots[split * kCols * kMChunk + e] = sum;
  }
  __syncthreads();
  if (threadIdx.x == 0) last = count_arrival(counter + uc) == splits - 1;
  __syncthreads();
  if (!last) return;
  // outputs e = tid + q kThreads, 4 at a time, every split's sums loaded before any is added
  for (int q0 = 0; q0 < kCols * kMChunk / kThreads; q0 += 4) {
    float v[kMaxSplits][4];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e = threadIdx.x + (q0 + q) * kThreads;
        v[sp][q] = sp < splits && e < outs ? __ldcg(slots + sp * kCols * kMChunk + e) : 0.f;
      }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = threadIdx.x + (q0 + q) * kThreads;
      if (e >= outs) break;
      float sum = 0.f;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (sp < splits) sum += v[sp][q];  // the splits in order
      const int c = e / rows, i = e - c * rows;
      const int col = gni * kTileN + (c / kUnitLanes) * kLanes + lane0 + c % kUnitLanes;
      y[static_cast<size_t>(m0 + i) * gn * kTileN + col] = sum;
    }
  }
  if (threadIdx.x == 0) counter[uc] = 0;  // zero again for the next call
}

}  // namespace

extern "C" {

// x: (m, gk*tk) bf16 row-major, 16-byte aligned; w: (gk, gn, tk, 128) int32 words,
// tk % 16 == 0; y: (m, gn*1024) f32. The k rows in splits of rows_per_split
// (a multiple of 64), 1 <= splits <= 8. part: ceil(m/8) * gn*8 * splits * 1024 f32
// scratch; counter: ceil(m/8) * gn*8 ints, zero (each call leaves them zero).
// Returns the cudaError_t of the launch.
int fm_int4_tiled_bf16(const void* x, int m, const int32_t* w, int gk, int gn, int tk, float* y,
                       float* part, int* counter, int splits, int rows_per_split,
                       cudaStream_t stream) {
  if (m < 1 || tk % kStep || rows_per_split % kSplitRows || splits < 1 || splits > kMaxSplits ||
      static_cast<long long>(splits - 1) * rows_per_split >= static_cast<long long>(gk) * tk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(int4_tiled_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(splits, gn * kSlices, (m + kMChunk - 1) / kMChunk);
  int4_tiled_bf16_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), m, w, gk, gn, tk, rows_per_split, y, part, counter);
  return static_cast<int>(cudaGetLastError());
}

const char* fm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
