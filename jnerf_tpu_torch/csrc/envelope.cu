// Envelope kernels for Hopper (sm_90a): the card's counterparts of the
// thirteen pallas_calls of the archived TPU envelope probes
// (tools/archive/), which measured what a random-access primitive could do
// on the TPU before kernels F and B were designed.  On the card they
// measure the same access patterns: a row gather, an element gather, a
// row scatter-add and the packed hash-gradient scatter.
//
// K1 row gather: out[n] = table[idx[n]] (optionally times w[n], or summed
//   over the row's lanes).  Replaces probe_loop.py:52 (mk_gather),
//   probe_round2.py:138 (k_loop) and :177 (k_fused, with w),
//   probe_tpu.py:72 over k_rows (lane sum) and k_onehot (a one-hot matmul
//   of a 128-row table: an index past the table gives a zero row, which is
//   K1's rule for every index outside the table), probe_tpu2.py:93 over
//   k_rowtake.
// K2 element gather: a flat take, take_along_axis on axis 0 or axis 1.
//   Replaces probe_tpu.py:72 over k_flat and k_lane, probe_tpu2.py:93 over
//   k_tala0 and k_tala1, probe_round2.py:240 (k_lane).
// K3 row scatter-add: out[idx[n]] += vals[n], out [n_rows, W] f32.
//   Replaces probe_rmw.py:74 (make_kernel), probe_scatter.py:72
//   (mk_scatter), probe_scatter2.py:55 (mk_scatter_k), probe_loop.py:100
//   (mk_scatter), probe_final.py:77 (sec_pallas_scatter.k_fn),
//   probe_round2.py:212 (k_scat).  The TPU kernels carry a VMEM
//   accumulator across an ordered grid and zero it at program 0; their
//   slab, unroll and interleaved-accumulator variants cut the TPU's issued
//   vector ops and compute one function; they add in grid order.  Here the
//   indices are sorted stably by row first (bins.cuh's radix sort on K4's
//   bin pass, an index outside the rows sorted after every row, then each
//   row's first position), and row_sum_kernel adds each row's sources in
//   index order from +0.0 and writes the row once: the twin's index_add_
//   order, with no zeroing and no float atomics.
// K4 packed hash scatter: probe_bwd_var.py:101 (make, with vals_phase :40).
//   For level l and sample n the 16 non-zero lanes of the packed row
//   (lane = slot*16 + corner*2 + feature) are X*Y*Z*G, added into row
//   (l*n_acc + n % n_acc)*n_rows + rows[l, n].  Modes: v2d (alt2 by
//   n_acc 2), novals (ones into all 128 lanes), noscat (the TPU variant's
//   own output: each level's row 0 gets the first sample of each
//   blk-sample block, and every contribution is stored to a scratch
//   buffer, as the TPU kernel stores its vals slab to VMEM scratch).
//   The TPU kernel keeps a level's whole [ROWS, 128] slab in VMEM across
//   its ordered grid, so it adds on the chip, in grid order, and writes
//   each row once.  Here (v2d, alt2, novals) a block holds a tile of
//   tile_rows packed rows of one (level, accumulator copy) slab on the chip
//   instead, and a bin pass first hands it its entries in sample order:
//   1. bins: a stable counting sort of the L*n entries by tile.  Per-block
//      tile counts of each (level, chunk of 2048 samples); a three-kernel
//      scan gives each (tile, chunk) its first position; then each block
//      sorts its chunk by tile in shared memory (ranks from
//      __match_any_sync and per-warp counts) and writes each tile's records
//      as one run.  A record is what the contributions need, 24 bytes: the
//      three fractions fract(p*scale + 0.5), g0, g1 and the segment
//      (row-in-tile*8 + slot); novals 8.  Re-reading pos and g at random
//      samples instead would cost a 32-byte sector for 4-12 useful bytes;
//      and records stored one at a time, 16 + 8 bytes at random addresses,
//      cost about as much as the atomics they replace, hence the runs.
//   2. accumulate: one block a tile, its 64-byte slot segments' sums in
//      registers (thread t owns segments t, t+256, ...).  The tile's
//      records are staged 2048 at a time, in order, sorted by segment in
//      shared memory, and each thread adds its segments' contributions in
//      ascending sample order from +0.0; then the tile goes out through
//      shared memory, each row written once with 16-byte stores (a tile
//      with no entries writes zeros).  novals counts each row's hits as
//      integers.  So every launch gives the same bits, those of the twin's
//      index_add_ (sample order, from zero), with no zeroing of the output
//      and no global atomics.
//   tile_rows (ops/envelope.py's k4_tile_rows): 64 for v2d, where two
//   segments of 16 floats a thread leave 78 registers and three 256-thread
//   blocks an SM (128 rows take 128 registers, spill, and fit two); 128
//   for alt2 (two accumulator copies double the tiles a level, and with
//   them the bin pass's tile tables and strided count stores) and for
//   novals (no sums held).
//   PERF.md §6 has both heights' times at probe_bwd_var's shape.
//   noscat keeps its contribution pass and its few float4 atomics.
//
// What bounds them: bytes, at random addresses.  K1 and K2 read each
// index and write each output once; the rows they read are random, and a
// DRAM or L2 sector is 32 bytes, so a 16-byte row read costs a whole
// sector.  So the design keeps each access as wide as the row allows:
// K1 moves 16 bytes a thread (int4), neighbouring threads on one row's
// neighbouring chunks, so a row of 32 bytes or more is read by one
// coalesced group.  K3 reads each source row once, its row's threads
// side by side (a 512-byte row is one warp's coalesced read), and moves
// the sort's (key, index) pairs twice a pass.  K4 moves its
// inputs twice (the rows and slots), the records twice and its output
// once.  The arithmetic is a
// few operations a byte at most.
//
// Indices are int32.  An index outside its table is the caller's fault:
// gathers write 0 for it and scatters drop it, so no launch reads or
// writes outside its buffers.  All sizes a launch walks are below 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bins.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLevels = 32;

int blocks_for(uint32_t work) {
  uint32_t b = (work + kThreads - 1) / kThreads;
  if (b > (1u << 20)) b = 1u << 20;  // the loops stride past this
  return (int)(b < 1 ? 1 : b);
}

__device__ __forceinline__ uint32_t stride() { return gridDim.x * blockDim.x; }

// K1: one 16-byte chunk a thread; chunks = row bytes / 16.
__global__ void __launch_bounds__(kThreads)
row_gather_kernel(const int4* __restrict__ table, const int32_t* __restrict__ idx,
                  int4* __restrict__ out, uint32_t total, uint32_t chunks,
                  uint32_t n_rows) {
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride()) {
    const uint32_t i = t / chunks, c = t - i * chunks;
    const int32_t r = __ldg(idx + i);
    int4 v = make_int4(0, 0, 0, 0);
    if (r >= 0 && (uint32_t)r < n_rows)
      v = __ldg(table + (size_t)r * chunks + c);
    out[t] = v;
  }
}

// K1 with w: f32 rows times w, one rounding a product.
__global__ void __launch_bounds__(kThreads)
row_gather_w_kernel(const float4* __restrict__ table,
                    const int32_t* __restrict__ idx,
                    const float4* __restrict__ w, float4* __restrict__ out,
                    uint32_t total, uint32_t chunks, uint32_t n_rows) {
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride()) {
    const uint32_t i = t / chunks, c = t - i * chunks;
    const int32_t r = __ldg(idx + i);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r >= 0 && (uint32_t)r < n_rows)
      v = __ldg(table + (size_t)r * chunks + c);
    const float4 s = __ldg(w + t);
    out[t] = make_float4(__fmul_rn(v.x, s.x), __fmul_rn(v.y, s.y),
                         __fmul_rn(v.z, s.z), __fmul_rn(v.w, s.w));
  }
}

// K1 lane sum: an f32 row's lanes summed in a fixed order, the plain
// twin's: each 4-float chunk left to right, then the chunks by halves
// (chunk c + chunk c + chunks/2, ...), a group of `chunks` threads (a power
// of two <= 32, so a group never straddles a warp) sharing its partial
// sums by xor shuffles.  The loop bound is block-uniform, so every lane
// of a warp takes part in every shuffle.
__global__ void __launch_bounds__(kThreads)
row_lane_sum_kernel(const float4* __restrict__ table,
                    const int32_t* __restrict__ idx, float* __restrict__ out,
                    uint32_t total, uint32_t chunks, uint32_t n_rows) {
  for (uint32_t t0 = blockIdx.x * blockDim.x; t0 < total; t0 += stride()) {
    const uint32_t t = t0 + threadIdx.x;
    const uint32_t i = t / chunks, c = t - i * chunks;
    float s = 0.f;
    if (t < total) {
      const int32_t r = __ldg(idx + i);
      if (r >= 0 && (uint32_t)r < n_rows) {
        const float4 v = __ldg(table + (size_t)r * chunks + c);
        s = __fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w);
      }
    }
    for (uint32_t off = chunks >> 1; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (t < total && c == 0) out[i] = s;
  }
}

// K2: one f32 element a thread.  MODE 0: out[t] = src[idx[t]] over
// src_rows * src_w elements; 1: out[i, j] = src[idx[i, j], j] (src
// [src_rows, w]); 2: out[i, j] = src[i, idx[i, j]] (src [rows, src_w]).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
elem_gather_kernel(const float* __restrict__ src, const int32_t* __restrict__ idx,
                   float* __restrict__ out, uint32_t total, uint32_t w,
                   uint32_t src_rows, uint32_t src_w) {
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride()) {
    const int32_t k = __ldg(idx + t);
    float v = 0.f;
    if (MODE == 0) {
      if (k >= 0 && (uint64_t)k < (uint64_t)src_rows * src_w) v = __ldg(src + k);
    } else if (MODE == 1) {
      const uint32_t i = t / w, j = t - i * w;
      if (k >= 0 && (uint32_t)k < src_rows)
        v = __ldg(src + (size_t)k * src_w + j);
    } else {
      const uint32_t i = t / w;
      if (k >= 0 && (uint32_t)k < src_w) v = __ldg(src + (size_t)i * src_w + k);
    }
    out[t] = v;
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// K3's sum: thread t takes 16-byte chunk t % chunks of output row t /
// chunks, so that the threads of one row read a source row as one
// coalesced span (a 512-byte row is one warp's read; a 16-byte row one
// thread's).  It adds the row's sources, order[start[r]] ..
// order[start[r + 1] - 1] (ascending source index), from +0.0 and writes
// the chunk once; eight sources' loads are started before they are added.
__global__ void __launch_bounds__(kThreads)
row_sum_kernel(const int32_t* __restrict__ start,
               const uint32_t* __restrict__ order,
               const float4* __restrict__ vals, float4* __restrict__ out,
               uint32_t total, uint32_t chunks) {
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride()) {
    const uint32_t r = t / chunks, c = t - r * chunks;
    int32_t j = __ldg(start + r);
    const int32_t j1 = __ldg(start + r + 1);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (; j + 8 <= j1; j += 8) {
      uint32_t n[8];
      float4 v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) n[k] = __ldg(order + j + k);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldg(vals + (size_t)n[k] * chunks + c);
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = add4(acc, v[k]);
    }
    for (; j < j1; ++j)
      acc = add4(acc, __ldg(vals + (size_t)__ldg(order + j) * chunks + c));
    out[t] = acc;
  }
}

struct Scales {
  float s[kMaxLevels];
};

// fract(p * scale + 0.5) with no FMA contraction, as vals_phase rounds it.
__device__ __forceinline__ float fract_of(float p, float scale) {
  const float q = __fadd_rn(__fmul_rn(p, scale), 0.5f);
  return __fsub_rn(q, floorf(q));
}

// The 16 lanes corner * 2 + feature of one sample's packed row: X * Y * Z
// * G left to right, X = (1 - f) + b (2f - 1), G = g0 + f (g1 - g0).
__device__ __forceinline__ void contributions(const float f[3], float g0,
                                              float g1, float v[16]) {
  float X[3][2];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float x0 = __fsub_rn(1.f, f[d]);
    X[d][0] = x0;
    X[d][1] = __fadd_rn(x0, __fsub_rn(__fmul_rn(2.f, f[d]), 1.f));
  }
  const float G[2] = {g0, __fadd_rn(g0, __fsub_rn(g1, g0))};
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float xyz = __fmul_rn(__fmul_rn(X[0][c & 1], X[1][(c >> 1) & 1]),
                                X[2][(c >> 2) & 1]);
    v[2 * c] = __fmul_rn(xyz, G[0]);
    v[2 * c + 1] = __fmul_rn(xyz, G[1]);
  }
}

// K4's bins.  An entry is a (level l, sample s); its tile is
// (l * n_acc + s % n_acc) * tiles_per_slab + row / tile_rows, numbered
// level-major, so a level's tiles are tiles_per_level consecutive ones.
// A bin block walks kChunk samples of one level.  counts is [levels *
// tiles_per_level, n_chunks] (a tile's row, its chunks in order) and one
// more entry; the scan turns it into each (tile, chunk)'s first position
// in the bins, and its last entry into the number of entries kept, so a
// tile's records are [counts[t * n_chunks], counts[(t + 1) * n_chunks]).
struct BinGeom {
  uint32_t n, L, n_rows, n_acc, tile_rows, tile_shift, tiles_per_slab,
      tiles_per_level, n_chunks;
  int mode;  // 0: v2d, 1: novals
};

constexpr int kChunk = 2048;  // samples a bin block, 8 a thread
constexpr int kAccThreads = 256;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kAccBatch = 2048;  // records staged at a time, 8 a thread

// The entry's tile within its level, or -1 for an entry K4 drops (a row
// outside the level; in v2d also a slot outside 0-7).
__device__ __forceinline__ int bin_of(const BinGeom& G, uint32_t s, int32_t r,
                                      int32_t slot) {
  if (r < 0 || (uint32_t)r >= G.n_rows) return -1;
  if (G.mode == 0 && (slot < 0 || slot >= 8)) return -1;
  // n_acc is 1 or 2 and tile_rows a power of two: masks and shifts.
  return (int)((s & (G.n_acc - 1)) * G.tiles_per_slab +
               ((uint32_t)r >> G.tile_shift));
}

// K4's bins on the shared bin pass (bins.cuh): an item is a (level l,
// sample s) entry, its bin the tile of bin_of; a thread fetches its
// entries' rows and slots before it bins one, and (v2d) loads their pos
// and g only once they are ranked.  Blocks are numbered chunk * L + level, so the L blocks
// of one chunk run together and share its pos and g rows in the L2.  A
// record: recA (f_x, f_y, f_z, g0), recB (g1's bits, row-in-tile * 8 +
// slot); in novals recB only, (0, row-in-tile * 8).  Staged as two arrays,
// [kChunk] float4 then [kChunk] uint2.
struct K4Bins {
  static constexpr int kItems = kChunk / jn_bins::kBinThreads;
  static constexpr int kStageBytes = 16 + 8;
  struct Item {
    int32_t r, slot;
    float p[3], g0, g1;
  };
  const float* pos;
  const float* g;
  const int32_t* rows;
  const int32_t* slots;
  Scales sc;
  BinGeom G;
  float4* recA;
  uint2* recB;

  __device__ __forceinline__ void fetch(uint32_t l, uint32_t s,
                                        Item& it) const {
    const size_t t = (size_t)l * G.n + s;
    it.r = __ldg(rows + t);
    it.slot = G.mode == 0 ? __ldg(slots + t) : 0;
  }
  __device__ __forceinline__ int bin(uint32_t, uint32_t s, const Item& it) const {
    return it.r < 0 ? -1 : bin_of(G, s, it.r, it.slot);
  }
  __device__ __forceinline__ void load(uint32_t l, uint32_t s, Item& it) const {
    if (G.mode != 0) return;
    const float* gs = g + (size_t)s * 2 * G.L + l;
#pragma unroll
    for (int d = 0; d < 3; ++d) it.p[d] = __ldg(pos + (size_t)s * 3 + d);
    it.g0 = __ldg(gs);
    it.g1 = __ldg(gs + G.L);
  }
  __device__ __forceinline__ void stage(float4* stA, int q, uint32_t l,
                                        const Item& it) const {
    uint2* stB = reinterpret_cast<uint2*>(stA + kChunk);
    const uint32_t seg = ((uint32_t)it.r & (G.tile_rows - 1)) * 8;
    if (G.mode == 0) {
      const float scale = sc.s[l];
      stA[q] = make_float4(fract_of(it.p[0], scale), fract_of(it.p[1], scale),
                           fract_of(it.p[2], scale), it.g0);
      stB[q] = make_uint2(__float_as_uint(it.g1), seg + (uint32_t)it.slot);
    } else {
      stB[q] = make_uint2(0u, seg);
    }
  }
  __device__ __forceinline__ void write(const float4* stA, int i,
                                        int32_t dst) const {
    const uint2* stB = reinterpret_cast<const uint2*>(stA + kChunk);
    if (G.mode == 0) recA[dst] = stA[i];
    recB[dst] = stB[i];
  }
};

// The accumulate pass: one block a tile of T packed rows (8T slot
// segments), its sums held in registers, thread t owning segments t, t +
// 256, ...  The tile's records are staged kAccBatch at a time, in order
// (every load of a batch started before the first is used), and sorted by
// segment in shared memory (stably, as the bin pass sorts by tile: order[]
// lists the staged records by segment); each thread then walks its
// segments' records in sample order and adds their contributions from
// +0.0, as the twin's index_add_ does.  Then each segment is written once
// (four 16-byte stores; a tile with no records writes zeros).  novals
// counts each row's hits as integers.
template <int T>
__global__ void __launch_bounds__(kAccThreads)
packed_accumulate_kernel(const int32_t* __restrict__ offsets,
                         const float4* __restrict__ recA,
                         const uint2* __restrict__ recB, BinGeom G,
                         float4* __restrict__ out) {
  constexpr int kS = T * 8;                   // segments a tile
  constexpr int kPer = kS / kAccThreads;      // segments a thread
  constexpr int kItems = kAccBatch / kAccThreads;
  extern __shared__ float4 smem4[];
  __shared__ int32_t ws[kAccWarps];
  const uint32_t t = blockIdx.x;
  const uint32_t slab = t / G.tiles_per_slab;  // l * n_acc + copy
  const uint32_t row0 = (t % G.tiles_per_slab) * T;
  const uint32_t rows_here = min((uint32_t)T, G.n_rows - row0);
  float4* dst = out + ((size_t)slab * G.n_rows + row0) * 32;
  const int32_t b0 = __ldg(offsets + (size_t)t * G.n_chunks);
  const int32_t b1 = __ldg(offsets + (size_t)(t + 1) * G.n_chunks);
  if (G.mode == 1) {
    int32_t* hits = reinterpret_cast<int32_t*>(smem4);  // [T]
    for (uint32_t k = threadIdx.x; k < T; k += kAccThreads) hits[k] = 0;
    __syncthreads();
    for (int32_t i = b0 + threadIdx.x; i < b1; i += kAccThreads)
      atomicAdd(hits + (__ldg(&recB[i].y) >> 3), 1);
    __syncthreads();
    // The f32 sum of c ones from zero stops at 2^24 (2^24 + 1 rounds down).
    for (uint32_t k = threadIdx.x; k < rows_here * 32; k += kAccThreads) {
      const float f = (float)min(hits[k >> 5], 1 << 24);
      dst[k] = make_float4(f, f, f, f);
    }
    return;
  }
  float4* stA = smem4;                                         // [batch]
  float* stG1 = reinterpret_cast<float*>(stA + kAccBatch);     // [batch]
  uint16_t* wcnt = reinterpret_cast<uint16_t*>(stG1 + kAccBatch);  // [w][kS]
  uint16_t* order = wcnt + kAccWarps * kS;                     // [batch]
  int32_t* kst = reinterpret_cast<int32_t*>(order + kAccBatch);  // [kS]
  int32_t* ktot = kst + kS;                                    // [kS]
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint16_t* mine = wcnt + warp * kS;
  float acc[kPer][16];
#pragma unroll
  for (int q = 0; q < kPer; ++q)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[q][k] = 0.f;
  for (int32_t i0 = b0; i0 < b1; i0 += kAccBatch) {  // block-uniform
    const int u0 = (int)(warp * kItems * 32 + lane);  // + it * 32
    int seg[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int32_t i = i0 + u0 + it * 32;
      seg[it] = -1;
      if (i < b1) {
        stA[u0 + it * 32] = __ldg(recA + i);
        const uint2 B = __ldg(recB + i);
        stG1[u0 + it * 32] = __uint_as_float(B.x);
        seg[it] = (int)B.y;
      }
    }
    for (int k = lane; k < kS / 2; k += 32)
      reinterpret_cast<uint32_t*>(mine)[k] = 0u;
    __syncwarp();
    int rank[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const uint32_t peers = __match_any_sync(0xffffffffu, seg[it]);
      const uint32_t before = peers & ((1u << lane) - 1);
      rank[it] = seg[it] >= 0 ? mine[seg[it]] + __popc(before) : 0;
      __syncwarp();
      if (seg[it] >= 0 && before == 0)
        mine[seg[it]] = (uint16_t)(mine[seg[it]] + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    // Each segment's count over the warps (turned into the warps' prefix)
    // and its start: thread t scans segments [t * kPer, t * kPer + kPer).
    int32_t tot[kPer], sum = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int sg = threadIdx.x * kPer + q;
      int32_t run = 0;
#pragma unroll
      for (int w = 0; w < kAccWarps; ++w) {
        const int32_t n_w = wcnt[w * kS + sg];
        wcnt[w * kS + sg] = (uint16_t)run;
        run += n_w;
      }
      tot[q] = run;
      sum += run;
    }
    int32_t ex = jn_bins::block_exclusive_scan<kAccThreads>(sum, ws, nullptr);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      kst[threadIdx.x * kPer + q] = ex;
      ktot[threadIdx.x * kPer + q] = tot[q];
      ex += tot[q];
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kItems; ++it)
      if (seg[it] >= 0)
        order[kst[seg[it]] + mine[seg[it]] + rank[it]] =
            (uint16_t)(u0 + it * 32);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int sg = threadIdx.x + q * kAccThreads;
      const int j1 = kst[sg] + ktot[sg];
      for (int j = kst[sg]; j < j1; ++j) {
        const int u = order[j];
        const float4 a = stA[u];
        const float f[3] = {a.x, a.y, a.z};
        float v[16];
        contributions(f, a.w, stG1[u], v);
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[q][k] = __fadd_rn(acc[q][k], v[k]);
      }
    }
    __syncthreads();
  }
  // The tile through shared memory (its staging area, free now), so that
  // its rows go out as whole 16-byte-a-thread lines.
  float4* tile4 = smem4;  // [T * 32]
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    float4* o = tile4 + (threadIdx.x + q * kAccThreads) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      o[k] = make_float4(acc[q][4 * k], acc[q][4 * k + 1], acc[q][4 * k + 2],
                         acc[q][4 * k + 3]);
  }
  __syncthreads();
  for (uint32_t k = threadIdx.x; k < rows_here * 32; k += kAccThreads)
    dst[k] = tile4[k];
}

// noscat: the contribution pass of every (level, sample), stored to
// scratch [L * n, 16] (the TPU variant stores its vals slab to VMEM
// scratch), and each level's row 0 gets the first sample of each
// blk-sample block (float4 atomics into an output the wrapper zeroes: a
// few adds a level).
__global__ void __launch_bounds__(kThreads)
packed_noscat_kernel(const float* __restrict__ pos, const float* __restrict__ g,
                     const int32_t* __restrict__ slots, Scales sc,
                     float* __restrict__ out, float4* __restrict__ scratch,
                     uint32_t n, uint32_t L, uint32_t n_rows, uint32_t blk) {
  const uint32_t total = n * L;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride()) {
    const uint32_t l = t / n, s = t - l * n;
    const float scale = sc.s[l];
    float f[3];
    for (int d = 0; d < 3; ++d) f[d] = fract_of(__ldg(pos + (size_t)s * 3 + d), scale);
    float v[16];
    contributions(f, __ldg(g + (size_t)s * 2 * L + l),
                  __ldg(g + (size_t)s * 2 * L + L + l), v);
    float4* sp = scratch + (size_t)t * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      sp[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    const int32_t slot = __ldg(slots + t);
    if (slot < 0 || slot >= 8 || s % blk != 0) continue;
    float4* o = reinterpret_cast<float4*>(out + (size_t)l * n_rows * 128 +
                                          slot * 16);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      atomicAdd(o + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                   v[4 * k + 3]));
  }
}

bool fits(int64_t a, int64_t b) { return a >= 0 && b >= 0 && a * b < (1LL << 31); }

// K4's geometry from the wrapper's sizes; false if a size is out of range
// (tile_rows 64 or 128).
bool bin_geom(BinGeom* G, int n, int L, int n_rows, int n_acc, int mode,
              int tile_rows) {
  if (n < 1 || L < 1 || L > kMaxLevels || n_rows < 1 || n_acc < 1 ||
      n_acc > 2 || mode < 0 || mode > 1 ||
      (tile_rows != 64 && tile_rows != 128) || !fits(n, L) ||
      !fits((int64_t)L * n_acc * n_rows, 128))
    return false;
  G->n = n;
  G->L = L;
  G->n_rows = n_rows;
  G->n_acc = n_acc;
  G->tile_rows = tile_rows;
  G->tile_shift = tile_rows == 64 ? 6 : 7;
  G->tiles_per_slab = (n_rows + tile_rows - 1) / tile_rows;
  G->tiles_per_level = n_acc * G->tiles_per_slab;
  G->n_chunks = (n + kChunk - 1) / kChunk;
  G->mode = mode;
  return G->tiles_per_level < 65536 &&
         fits((int64_t)L * G->tiles_per_level, G->n_chunks + 1);
}

// K4's bin pass as the shared binning sees it: one list a level.
jn_bins::BinShape bin_shape(const BinGeom& G) {
  return jn_bins::BinShape{G.n, G.L, G.tiles_per_level, G.n_chunks};
}

// K4's int32 work space: the counts (and the scan's total), then the scan
// blocks' sums.
int64_t bin_work(const BinGeom& G, int64_t* m, int64_t* nb) {
  *m = jn_bins::bin_counts(bin_shape(G));
  *nb = jn_bins::scan_blocks(*m);
  return *m + 1 + *nb;
}

using jn_bins::allow_smem;

size_t acc_smem(int tile_rows, int mode) {
  if (mode == 1) return (size_t)tile_rows * 4;
  const size_t segs = (size_t)tile_rows * 8;
  const size_t batch = kAccBatch * (16 + 4 + 2) + kAccWarps * segs * 2 + segs * 8;
  return batch > segs * 64 ? batch : segs * 64;  // the staging, or the tile
}

}  // namespace

// K1.  table [n_rows, chunks * 16 bytes]; mode 0 copies (any row type),
// 1 multiplies f32 rows by w [n, chunks * 4] f32, 2 sums an f32 row's
// lanes into out [n] f32 (chunks a power of two <= 32).
extern "C" int env_row_gather(const void* table, const void* idx,
                              const void* w, void* out, int n, int chunks,
                              int n_rows, int mode, void* stream) {
  if (n <= 0) return 0;
  if (chunks < 1 || n_rows < 1 || !fits(n, chunks) ||
      !fits(n_rows, chunks) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  if (mode == 2 && (chunks > 32 || (chunks & (chunks - 1))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t total = (uint32_t)n * chunks;
  const int blocks = blocks_for(total);
  const int32_t* ix = (const int32_t*)idx;
  if (mode == 0)
    row_gather_kernel<<<blocks, kThreads, 0, st>>>(
        (const int4*)table, ix, (int4*)out, total, chunks, n_rows);
  else if (mode == 1)
    row_gather_w_kernel<<<blocks, kThreads, 0, st>>>(
        (const float4*)table, ix, (const float4*)w, (float4*)out, total,
        chunks, n_rows);
  else
    row_lane_sum_kernel<<<blocks, kThreads, 0, st>>>(
        (const float4*)table, ix, (float*)out, total, chunks, n_rows);
  return (int)cudaGetLastError();
}

// K2.  n index elements; mode 0 flat (src of src_rows * src_w elements),
// 1 axis 0, 2 axis 1 (idx [n / w, w]).
extern "C" int env_elem_gather(const void* src, const void* idx, void* out,
                               int n, int mode, int w, int src_rows,
                               int src_w, void* stream) {
  if (n <= 0) return 0;
  if (w < 1 || n % w || src_rows < 1 || src_w < 1 ||
      !fits(src_rows, src_w) || mode < 0 || mode > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = blocks_for((uint32_t)n);
  const float* s = (const float*)src;
  const int32_t* ix = (const int32_t*)idx;
  float* o = (float*)out;
  if (mode == 0)
    elem_gather_kernel<0><<<blocks, kThreads, 0, st>>>(s, ix, o, n, w,
                                                       src_rows, src_w);
  else if (mode == 1)
    elem_gather_kernel<1><<<blocks, kThreads, 0, st>>>(s, ix, o, n, w,
                                                       src_rows, src_w);
  else
    elem_gather_kernel<2><<<blocks, kThreads, 0, st>>>(s, ix, o, n, w,
                                                       src_rows, src_w);
  return (int)cudaGetLastError();
}

// K3's int32 work space for n indices into n_rows rows: out[0] its size,
// out[1] and out[2] where the row starts [n_rows + 1] and the sorted
// source indices [n] lie in it; -1 if K3 does not take the sizes.
extern "C" long long env_row_scatter_layout(int n, int n_rows,
                                            long long* out) {
  if (n < 1 || n_rows < 1 || n_rows == INT_MAX) return -1;
  const jn_bins::RadixPlan R =
      jn_bins::radix_plan((uint32_t)n, 1, jn_bins::bits_for((uint32_t)n_rows));
  const int64_t m = n_rows, n4 = ((int64_t)n + 3) / 4 * 4;
  const int64_t starts = (m + 1 + jn_bins::scan_blocks(m) + 3) / 4 * 4;
  // kA, pA, kB, pB, the starts, the counts
  out[1] = 4 * n4;
  out[2] = (R.passes & 1) ? n4 : 3 * n4;
  out[0] = 4 * n4 + starts + R.counts_ints;
  return out[0] < (1LL << 31) ? out[0] : -1;
}

// K3.  vals [n, chunks * 4] f32 into out [n_rows, chunks * 4] f32: the
// indices sorted stably by row (indices outside [0, n_rows) after every
// row), then each row's sources summed in index order and the row written
// once; work as env_row_scatter_layout gives it.  plan_only: the sort and
// the row starts alone.
extern "C" int env_row_scatter_add(const void* idx, const void* vals,
                                   void* out, void* work, int n, int chunks,
                                   int n_rows, int plan_only, void* stream) {
  long long lay[3];
  if (chunks < 1 || !fits(n, chunks) || !fits(n_rows, chunks) ||
      env_row_scatter_layout(n, n_rows, lay) < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const jn_bins::RadixPlan R =
      jn_bins::radix_plan((uint32_t)n, 1, jn_bins::bits_for((uint32_t)n_rows));
  int32_t* w = (int32_t*)work;
  const int64_t n4 = ((int64_t)n + 3) / 4 * 4;
  uint32_t* kA = (uint32_t*)w;
  int32_t* start = w + lay[1];
  int32_t* counts =
      start + (n_rows + 1 + jn_bins::scan_blocks(n_rows) + 3) / 4 * 4;
  const uint32_t* keys;
  const uint32_t* order;
  int err = jn_bins::run_radix(R, (uint32_t)n, 1, (const uint32_t*)idx,
                               (uint32_t)n_rows, kA, kA + n4, kA + 2 * n4,
                               kA + 3 * n4, counts, st, &keys, &order);
  if (err) return err;
  jn_bins::KeyGroups G;
  G.base[0] = 0;
  G.size[0] = (uint32_t)n_rows;
  jn_bins::key_starts(keys, (uint32_t)n, 1, G, n_rows, start, st);
  if (!plan_only) {
    const uint32_t total = (uint32_t)n_rows * chunks;
    row_sum_kernel<<<blocks_for(total), kThreads, 0, st>>>(
        start, order, (const float4*)vals, (float4*)out, total, chunks);
  }
  return (int)cudaGetLastError();
}


// K4's int32 work space for these sizes (env_packed_bins' work), or -1
// if K4 does not take them.
extern "C" long long env_packed_work(int n, int L, int n_rows, int n_acc,
                                     int mode, int tile_rows) {
  BinGeom G;
  if (!bin_geom(&G, n, L, n_rows, n_acc, mode, tile_rows)) return -1;
  int64_t m, nb;
  const int64_t ints = bin_work(G, &m, &nb);
  return ints < (1LL << 31) ? ints : -1;
}

// Samples a bin block walks: the work's counts are [tiles, ceil(n / this)].
extern "C" int env_packed_chunk() { return kChunk; }

// K4's bin pass (v2d, alt2 by n_acc 2; novals: mode 1).  work:
// env_packed_work int32s (counts, then scanned into each (tile, chunk)'s
// first position); recA [L * n] float4 (v2d only) and recB [L * n]
// uint2, allocated by the wrapper; scales: L host floats, passed by
// value.
extern "C" int env_packed_bins(const void* pos, const void* g,
                               const void* rows, const void* slots,
                               const float* scales, void* work, void* recA,
                               void* recB, int n, int L, int n_rows, int n_acc,
                               int mode, int tile_rows, void* stream) {
  BinGeom G;
  if (!bin_geom(&G, n, L, n_rows, n_acc, mode, tile_rows))
    return (int)cudaErrorInvalidValue;
  Scales sc;
  for (int l = 0; l < L; ++l) sc.s[l] = scales[l];
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* counts = (int32_t*)work;
  const jn_bins::BinShape S = bin_shape(G);
  const int64_t m = jn_bins::bin_counts(S);
  const K4Bins p{(const float*)pos, (const float*)g,   (const int32_t*)rows,
                 (const int32_t*)slots, sc,            G,
                 (float4*)recA,         (uint2*)recB};
  const size_t hist = G.tiles_per_level * sizeof(int32_t);
  const size_t scat = jn_bins::bin_scatter_smem<K4Bins>(S.n_bins);
  int err = allow_smem((const void*)jn_bins::bin_count_kernel<K4Bins>, hist);
  if (!err)
    err = allow_smem((const void*)jn_bins::bin_scatter_kernel<K4Bins>, scat);
  if (err) return err;
  const int blocks = (int)(G.n_chunks * G.L);
  jn_bins::bin_count_kernel<K4Bins><<<blocks, jn_bins::kBinThreads, hist, st>>>(
      p, S, counts);
  jn_bins::launch_scan(counts, m, counts + m + 1, st);
  jn_bins::bin_scatter_kernel<K4Bins>
      <<<blocks, jn_bins::kBinThreads, scat, st>>>(p, S, counts);
  return (int)cudaGetLastError();
}

// K4's accumulate pass over env_packed_bins' bins (work, recA, recB) into
// out [L * n_acc * n_rows, 128] f32, every row written once (no zeroing).
extern "C" int env_packed_accumulate(const void* work, const void* recA,
                                     const void* recB, void* out, int n, int L,
                                     int n_rows, int n_acc, int mode,
                                     int tile_rows, void* stream) {
  BinGeom G;
  if (!bin_geom(&G, n, L, n_rows, n_acc, mode, tile_rows))
    return (int)cudaErrorInvalidValue;
  const size_t smem = acc_smem(tile_rows, mode);
  const void* kernel = tile_rows == 64
                           ? (const void*)packed_accumulate_kernel<64>
                           : (const void*)packed_accumulate_kernel<128>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  const int blocks = (int)(G.L * G.tiles_per_level);
  cudaStream_t st = (cudaStream_t)stream;
  if (tile_rows == 64)
    packed_accumulate_kernel<64><<<blocks, kAccThreads, smem, st>>>(
        (const int32_t*)work, (const float4*)recA, (const uint2*)recB, G,
        (float4*)out);
  else
    packed_accumulate_kernel<128><<<blocks, kAccThreads, smem, st>>>(
        (const int32_t*)work, (const float4*)recA, (const uint2*)recB, G,
        (float4*)out);
  return (int)cudaGetLastError();
}

// K4 noscat.  out [L * n_rows, 128] f32 zeroed by the wrapper; scratch
// [L * n, 16] f32.
extern "C" int env_packed_noscat(const void* pos, const void* g,
                                 const void* slots, const float* scales,
                                 void* out, void* scratch, int n, int L,
                                 int n_rows, int blk, void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > kMaxLevels || n_rows < 1 || blk < 1 || !fits(n, 16 * L) ||
      !fits((int64_t)L * n_rows, 128))
    return (int)cudaErrorInvalidValue;
  Scales sc;
  for (int l = 0; l < L; ++l) sc.s[l] = scales[l];
  const uint32_t total = (uint32_t)n * L;
  packed_noscat_kernel<<<blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)g, (const int32_t*)slots, sc,
      (float*)out, (float4*)scratch, n, L, n_rows, blk);
  return (int)cudaGetLastError();
}
