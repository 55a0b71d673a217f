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
// K3 row scatter-add: out[idx[n]] += vals[n] into a zeroed [n_rows, W] f32.
//   Replaces probe_rmw.py:74 (make_kernel), probe_scatter.py:72
//   (mk_scatter), probe_scatter2.py:55 (mk_scatter_k), probe_loop.py:100
//   (mk_scatter), probe_final.py:77 (sec_pallas_scatter.k_fn),
//   probe_round2.py:212 (k_scat).  The TPU kernels carry a VMEM
//   accumulator across an ordered grid and zero it at program 0; their
//   slab, unroll and interleaved-accumulator variants cut the TPU's issued
//   vector ops and compute one function.  Blocks here run in no order, so
//   the wrapper zeroes the output and the kernel adds with one 16-byte
//   atomicAdd(float4*) (sm_90, global memory) a 4-float chunk.
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
// coalesced group.  K3 is paced by the L2's reduction units: one float4
// atomic per 16 bytes, no aggregation of equal rows (that is kernel B's
// design; here the raw atomic rate is the thing measured).  K4 moves its
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

// K3: one float4 atomic a thread; out is zeroed by the wrapper.
__global__ void __launch_bounds__(kThreads)
row_scatter_add_kernel(const int32_t* __restrict__ idx,
                       const float4* __restrict__ vals, float4* __restrict__ out,
                       uint32_t total, uint32_t chunks, uint32_t n_rows) {
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride()) {
    const uint32_t i = t / chunks, c = t - i * chunks;
    const int32_t r = __ldg(idx + i);
    if (r >= 0 && (uint32_t)r < n_rows)
      atomicAdd(out + (size_t)r * chunks + c, __ldg(vals + t));
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

constexpr int kBinThreads = 256;
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kChunk = 2048;  // samples a bin block, 8 a thread
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;  // a scan block covers 4096 counts
constexpr int kScanSpan = kScanThreads * kScanItems;
constexpr int kAccThreads = 256;
constexpr int kAccWarps = kAccThreads / 32;
constexpr int kAccBatch = 2048;  // records staged at a time, 8 a thread
constexpr int kSmemMax = 232448;  // 227 KB: a block's dynamic shared memory

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

// Exclusive scan of one value a thread over a block of NT threads;
// *total (if given) gets the block's sum.  Ends in a barrier, so ws (NT /
// 32 ints of shared memory) can be used again at once.
template <int NT>
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* ws,
                                                        int32_t* total) {
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= (uint32_t)o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < (uint32_t)(NT / 32) ? ws[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= (uint32_t)o) w += y;
    }
    if (lane < (uint32_t)(NT / 32)) ws[lane] = w;
  }
  __syncthreads();
  const int32_t ex = (warp ? ws[warp - 1] : 0) + x - v;
  if (total) *total = ws[NT / 32 - 1];
  __syncthreads();
  return ex;
}

// Bin pass 1: each (level, chunk) block's entries a tile, counted in
// shared memory; a thread loads its 8 entries' rows and slots before it
// counts.  Blocks are numbered chunk * L + level, so the L blocks of one
// chunk run together and share its pos and g rows in the L2.
__global__ void __launch_bounds__(kBinThreads)
packed_bin_count_kernel(const int32_t* __restrict__ rows,
                        const int32_t* __restrict__ slots, BinGeom G,
                        int32_t* __restrict__ counts) {
  constexpr int kItems = kChunk / kBinThreads;
  extern __shared__ int32_t hist[];  // [tiles_per_level]
  const uint32_t l = blockIdx.x % G.L, c = blockIdx.x / G.L;
  const uint32_t tpl = G.tiles_per_level;
  const uint32_t s1 = min(G.n, (c + 1) * kChunk);
  int32_t r[kItems], slot[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const uint32_t s = c * kChunk + it * kBinThreads + threadIdx.x;
    r[it] = -1;
    slot[it] = 0;
    if (s < s1) {
      const size_t t = (size_t)l * G.n + s;
      r[it] = __ldg(rows + t);
      if (G.mode == 0) slot[it] = __ldg(slots + t);
    }
  }
  for (uint32_t k = threadIdx.x; k < tpl; k += kBinThreads) hist[k] = 0;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (r[it] < 0) continue;
    const int key = bin_of(G, c * kChunk + it * kBinThreads + threadIdx.x,
                           r[it], slot[it]);
    if (key >= 0) atomicAdd(hist + key, 1);
  }
  __syncthreads();
  for (uint32_t k = threadIdx.x; k < tpl; k += kBinThreads)
    counts[((size_t)l * tpl + k) * G.n_chunks + c] = hist[k];
}

// Bin pass 2, an exclusive scan of counts[0, m) in place (counts[m] gets
// the total) in three kernels: each block's sum of kScanSpan counts, one
// block's scan of those sums, then each block's counts rescanned from its
// offset.
__global__ void __launch_bounds__(kScanThreads)
scan_reduce_kernel(const int32_t* __restrict__ counts, uint32_t m,
                   int32_t* __restrict__ block_sums) {
  __shared__ int32_t ws[kScanThreads / 32];
  const size_t base = (size_t)blockIdx.x * kScanSpan;
  int32_t v = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    const size_t i = base + j * kScanThreads + threadIdx.x;
    if (i < m) v += counts[i];
  }
  int32_t total;
  block_exclusive_scan<kScanThreads>(v, ws, &total);
  if (threadIdx.x == 0) block_sums[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kScanThreads)
scan_top_kernel(int32_t* __restrict__ block_sums, uint32_t nb,
                int32_t* __restrict__ total_out) {
  __shared__ int32_t ws[kScanThreads / 32];
  int32_t carry = 0;
  for (uint32_t i0 = 0; i0 < nb; i0 += kScanThreads) {  // block-uniform
    const uint32_t i = i0 + threadIdx.x;
    int32_t total;
    const int32_t ex = block_exclusive_scan<kScanThreads>(
        i < nb ? block_sums[i] : 0, ws, &total);
    if (i < nb) block_sums[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

__global__ void __launch_bounds__(kScanThreads)
scan_down_kernel(int32_t* __restrict__ counts, uint32_t m,
                 const int32_t* __restrict__ block_sums) {
  __shared__ int32_t ws[kScanThreads / 32];
  const size_t i0 = (size_t)blockIdx.x * kScanSpan +
                    (size_t)threadIdx.x * kScanItems;
  int32_t a[kScanItems], s = 0;
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    a[j] = i0 + j < m ? counts[i0 + j] : 0;
    s += a[j];
  }
  int32_t ex = block_exclusive_scan<kScanThreads>(s, ws, nullptr) +
               __ldg(block_sums + blockIdx.x);
#pragma unroll
  for (int j = 0; j < kScanItems; ++j) {
    if (i0 + j < m) counts[i0 + j] = ex;
    ex += a[j];
  }
}

// Bin pass 3: each entry's record written to its bin in sample order.  A
// block sorts its chunk by tile in shared memory first (stably: each warp
// walks its 8 groups of 32 consecutive samples in order, the rank within
// a group from __match_any_sync, the groups before it from the warp's
// running counts; then the warps before it, then the tiles before), and
// writes each tile's records as one run at the tile's position for the
// chunk, so that the stores coalesce.  A thread starts all its loads of a
// phase before it uses one.  A record: recA (f_x, f_y, f_z, g0), recB
// (g1's bits, row-in-tile * 8 + slot); in novals recB only, (0,
// row-in-tile * 8).
__global__ void __launch_bounds__(kBinThreads)
packed_bin_scatter_kernel(const float* __restrict__ pos,
                          const float* __restrict__ g,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ slots, Scales sc,
                          BinGeom G, const int32_t* __restrict__ offsets,
                          float4* __restrict__ recA, uint2* __restrict__ recB) {
  constexpr int kItems = kChunk / kBinThreads;  // groups of 32 a warp
  extern __shared__ float4 smem4[];
  __shared__ int32_t ws[kBinWarps];
  const uint32_t tpl = G.tiles_per_level;
  float4* stA = smem4;                                       // [kChunk]
  uint2* stB = reinterpret_cast<uint2*>(stA + kChunk);       // [kChunk]
  int32_t* wcnt = reinterpret_cast<int32_t*>(stB + kChunk);  // [warps][tpl]
  int32_t* lstart = wcnt + kBinWarps * tpl;                  // [tpl]
  int32_t* gbase = lstart + tpl;                             // [tpl]
  uint16_t* skey = reinterpret_cast<uint16_t*>(gbase + tpl);  // [kChunk]
  const uint32_t l = blockIdx.x % G.L, c = blockIdx.x / G.L;
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (uint32_t k = threadIdx.x; k < tpl; k += kBinThreads) {
    gbase[k] = __ldg(offsets + ((size_t)l * tpl + k) * G.n_chunks + c);
    for (int w = 0; w < kBinWarps; ++w) wcnt[w * tpl + k] = 0;
  }
  const uint32_t s_warp = c * kChunk + warp * kItems * 32 + lane;
  int32_t r[kItems], slot[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const uint32_t s = s_warp + it * 32;
    r[it] = -1;
    slot[it] = 0;
    if (s < G.n) {
      const size_t t = (size_t)l * G.n + s;
      r[it] = __ldg(rows + t);
      if (G.mode == 0) slot[it] = __ldg(slots + t);
    }
  }
  __syncthreads();
  int32_t* mine = wcnt + warp * tpl;
  int key[kItems], rank[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    key[it] = -1;
    rank[it] = 0;
    if (r[it] >= 0) key[it] = bin_of(G, s_warp + it * 32, r[it], slot[it]);
    const uint32_t peers = __match_any_sync(0xffffffffu, key[it]);
    const uint32_t before = peers & ((1u << lane) - 1);
    if (key[it] >= 0) rank[it] = mine[key[it]] + __popc(before);
    __syncwarp();
    if (key[it] >= 0 && before == 0) mine[key[it]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (uint32_t k = threadIdx.x; k < tpl; k += kBinThreads) {
    int32_t run = 0;
    for (int w = 0; w < kBinWarps; ++w) {
      const int32_t n_w = wcnt[w * tpl + k];
      wcnt[w * tpl + k] = run;
      run += n_w;
    }
    lstart[k] = run;  // the tile's total, scanned below
  }
  __syncthreads();
  int32_t kept = 0;
  for (uint32_t k0 = 0; k0 < tpl; k0 += kBinThreads) {  // block-uniform
    const uint32_t k = k0 + threadIdx.x;
    int32_t total;
    const int32_t ex = block_exclusive_scan<kBinThreads>(
        k < tpl ? lstart[k] : 0, ws, &total);
    if (k < tpl) lstart[k] = kept + ex;
    kept += total;
  }
  __syncthreads();
  if (G.mode == 0) {
    const float scale = sc.s[l];
    float p[kItems][3], g0[kItems], g1[kItems];
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (key[it] < 0) continue;
      const uint32_t s = s_warp + it * 32;
      const float* gs = g + (size_t)s * 2 * G.L + l;
#pragma unroll
      for (int d = 0; d < 3; ++d) p[it][d] = __ldg(pos + (size_t)s * 3 + d);
      g0[it] = __ldg(gs);
      g1[it] = __ldg(gs + G.L);
    }
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (key[it] < 0) continue;
      const int q = lstart[key[it]] + mine[key[it]] + rank[it];
      stA[q] = make_float4(fract_of(p[it][0], scale), fract_of(p[it][1], scale),
                           fract_of(p[it][2], scale), g0[it]);
      stB[q] = make_uint2(__float_as_uint(g1[it]),
                          ((uint32_t)r[it] & (G.tile_rows - 1)) * 8 +
                              (uint32_t)slot[it]);
      skey[q] = (uint16_t)key[it];
    }
  } else {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      if (key[it] < 0) continue;
      const int q = lstart[key[it]] + mine[key[it]] + rank[it];
      stB[q] = make_uint2(0u, ((uint32_t)r[it] & (G.tile_rows - 1)) * 8);
      skey[q] = (uint16_t)key[it];
    }
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < kept; i += kBinThreads) {
    const int k = skey[i];
    const int32_t q = gbase[k] + i - lstart[k];
    if (G.mode == 0) recA[q] = stA[i];
    recB[q] = stB[i];
  }
}

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
    int32_t ex = block_exclusive_scan<kAccThreads>(sum, ws, nullptr);
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

// K4's int32 work space: the counts (and the scan's total), then the scan
// blocks' sums.
int64_t bin_work(const BinGeom& G, int64_t* m, int64_t* nb) {
  *m = (int64_t)G.L * G.tiles_per_level * G.n_chunks;
  *nb = (*m + kScanSpan - 1) / kScanSpan;
  return *m + 1 + *nb;
}

// Dynamic shared memory above 48 KB needs the kernel's consent.
int allow_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

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

// K3.  vals [n, chunks * 4] f32 into out [n_rows, chunks * 4] f32, zeroed.
extern "C" int env_row_scatter_add(const void* idx, const void* vals,
                                   void* out, int n, int chunks, int n_rows,
                                   void* stream) {
  if (n <= 0) return 0;
  if (chunks < 1 || n_rows < 1 || !fits(n, chunks) || !fits(n_rows, chunks))
    return (int)cudaErrorInvalidValue;
  const uint32_t total = (uint32_t)n * chunks;
  row_scatter_add_kernel<<<blocks_for(total), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float4*)vals, (float4*)out, total, chunks,
      n_rows);
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
  int64_t m, nb;
  bin_work(G, &m, &nb);
  int32_t* counts = (int32_t*)work;
  const size_t hist = G.tiles_per_level * sizeof(int32_t);
  const size_t scat =
      (size_t)kChunk * (16 + 8 + 2) + (kBinWarps + 2) * hist;
  int err = allow_smem((const void*)packed_bin_count_kernel, hist);
  if (!err) err = allow_smem((const void*)packed_bin_scatter_kernel, scat);
  if (err) return err;
  const int blocks = (int)(G.n_chunks * G.L);
  packed_bin_count_kernel<<<blocks, kBinThreads, hist, st>>>(
      (const int32_t*)rows, (const int32_t*)slots, G, counts);
  scan_reduce_kernel<<<(int)nb, kScanThreads, 0, st>>>(counts, (uint32_t)m,
                                                       counts + m + 1);
  scan_top_kernel<<<1, kScanThreads, 0, st>>>(counts + m + 1, (uint32_t)nb,
                                              counts + m);
  scan_down_kernel<<<(int)nb, kScanThreads, 0, st>>>(counts, (uint32_t)m,
                                                     counts + m + 1);
  packed_bin_scatter_kernel<<<blocks, kBinThreads, scat, st>>>(
      (const float*)pos, (const float*)g, (const int32_t*)rows,
      (const int32_t*)slots, sc, G, counts, (float4*)recA, (uint2*)recB);
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
