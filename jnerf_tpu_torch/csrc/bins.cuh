// Stable binning on the card, shared by hash_encode.cu (kernel B) and
// envelope.cu (K3, K4): the machinery that lets a scatter-add sum each
// output element's contributions in one fixed order, with no float
// atomics, so that every launch gives the same bits.
//
// A binning sorts `groups` independent lists of n_items items each (kernel
// B and K4: one list a level) stably by a bin in [0, n_bins): items of one
// bin keep their list order.  It is K4's bin pass (PR 15), made generic
// over a policy P that says what an item's bin is and what record it
// leaves:
//   1. bin_count_kernel<P>: one block a (group, chunk of P::kItems * 256
//      items) counts its items a bin in shared memory; counts is
//      [groups * n_bins, n_chunks] (a bin's row, its chunks in order) and
//      one more entry;
//   2. a three-kernel exclusive scan turns it into each (bin, chunk)'s
//      first position, and its last entry into the number of items kept;
//   3. bin_scatter_kernel<P>: each block sorts its chunk by bin in shared
//      memory (stably: each warp walks its groups of 32 consecutive items
//      in order, the rank within a group from __match_any_sync, the groups
//      before it from the warp's running counts; then the warps before it,
//      then the bins before), and writes each bin's records as one run at
//      the bin's position for the chunk.
// A policy P has
//   kItems                items a thread in a chunk;
//   kStageBytes           shared memory a record takes while it is staged;
//   Item                  what a thread holds of an item;
//   fetch(l, s, item)     the loads that item s of list l's bin needs;
//   bin(l, s, item)       its bin from them, or -1 to drop the item (a
//                         thread starts all its fetches before its first
//                         bin, and all its loads before it stages);
//   load(l, s, item)      further loads of a kept item;
//   stage(st, q, l, item) its record into staging slot q (st: the
//                         staging area, kChunk * kStageBytes bytes);
//   write(st, i, dst)     staging slot i's record to position dst.
//
// RadixBins is the policy of one pass of a least-significant-digit radix
// sort of (key, payload) pairs; run_radix chains its passes, each stable,
// so the pairs end sorted by key with equal keys in list order.  Kernel B
// and K3 sort by output row this way and then walk each row's segment:
// key_starts turns the sorted keys into each row's first position (each
// run's length, then the same scan).
//
// A list's length may be on the device instead (kernel V: a list
// compacted on the card, whose length the host never reads, so that a
// CUDA graph can capture it): bin_count_live_kernel and
// bin_scatter_live_kernel take it as n_dev, counts and buffers are sized
// for n_items, the chunks past the device's count are empty (their counts
// 0), and a grid of at most kDeviceCountBlocks blocks walks the chunks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace jn_bins {

constexpr int kBinThreads = 256;
constexpr int kBinWarps = kBinThreads / 32;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 4;  // a scan block covers 4096 counts
constexpr int kScanSpan = kScanThreads * kScanItems;
constexpr int kSmemMax = 232448;  // 227 KB: a block's dynamic shared memory
constexpr int kMaxGroups = 32;
constexpr uint32_t kDeviceCountBlocks = 2048;

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

// An exclusive scan of counts[0, m) in place (counts[m] gets the total)
// in three kernels: each block's sum of kScanSpan counts, one block's scan
// of those sums, then each block's counts rescanned from its offset.
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

// Scan blocks for m counts.
inline int64_t scan_blocks(int64_t m) { return (m + kScanSpan - 1) / kScanSpan; }

// counts[0, m) scanned in place, counts[m] the total; block_sums holds
// scan_blocks(m) ints.  m >= 1.
inline void launch_scan(int32_t* counts, int64_t m, int32_t* block_sums,
                        cudaStream_t st) {
  const int nb = (int)scan_blocks(m);
  scan_reduce_kernel<<<nb, kScanThreads, 0, st>>>(counts, (uint32_t)m,
                                                  block_sums);
  scan_top_kernel<<<1, kScanThreads, 0, st>>>(block_sums, (uint32_t)nb,
                                              counts + m);
  scan_down_kernel<<<nb, kScanThreads, 0, st>>>(counts, (uint32_t)m,
                                                block_sums);
}

// Dynamic shared memory above 48 KB needs the kernel's consent.
inline int allow_smem(const void* kernel, size_t bytes) {
  if (bytes > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

struct BinShape {
  uint32_t n_items;   // items a list
  uint32_t groups;    // lists
  uint32_t n_bins;    // bins a list (< 65536)
  uint32_t n_chunks;  // chunks a list
};

// The counts a binning scans: groups * n_bins * n_chunks.
inline int64_t bin_counts(const BinShape& S) {
  return (int64_t)S.groups * S.n_bins * S.n_chunks;
}

// The scatter kernel's shared memory for a policy's chunk: the staged
// records, the warps' counts, each bin's start in the chunk and in the
// bins, and each staged record's bin.
template <class P>
inline size_t bin_scatter_smem(uint32_t n_bins) {
  constexpr size_t kChunk = (size_t)P::kItems * kBinThreads;
  return kChunk * (P::kStageBytes + 2) +
         (size_t)(kBinWarps + 2) * n_bins * sizeof(int32_t);
}

// Pass 1: each (list, chunk) block's items a bin, counted in shared
// memory; a thread loads its items before it counts.  Blocks are numbered
// chunk * groups + list, so the lists' blocks of one chunk run together.
template <class P>
__device__ __forceinline__ void count_chunk(const P& p, const BinShape& S,
                                            int32_t* __restrict__ counts,
                                            int32_t* hist, uint32_t l,
                                            uint32_t c, uint32_t n_items) {
  constexpr int kItems = P::kItems;
  constexpr uint32_t kChunk = kItems * kBinThreads;
  const uint32_t s1 = min(n_items, (c + 1) * kChunk);
  typename P::Item item[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const uint32_t s = c * kChunk + it * kBinThreads + threadIdx.x;
    if (s < s1) p.fetch(l, s, item[it]);
  }
  for (uint32_t k = threadIdx.x; k < S.n_bins; k += kBinThreads) hist[k] = 0;
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const uint32_t s = c * kChunk + it * kBinThreads + threadIdx.x;
    const int key = s < s1 ? p.bin(l, s, item[it]) : -1;
    if (key >= 0) atomicAdd(hist + key, 1);
  }
  __syncthreads();
  for (uint32_t k = threadIdx.x; k < S.n_bins; k += kBinThreads)
    counts[((size_t)l * S.n_bins + k) * S.n_chunks + c] = hist[k];
}

template <class P>
__global__ void __launch_bounds__(kBinThreads)
bin_count_kernel(P p, BinShape S, int32_t* __restrict__ counts) {
  extern __shared__ int32_t hist[];  // [n_bins]
  count_chunk(p, S, counts, hist, blockIdx.x % S.groups,
              blockIdx.x / S.groups, S.n_items);
}

// A list's items: n_items, or fewer, as the device's count says.
__device__ __forceinline__ uint32_t live_items(uint32_t n_items,
                                               const int32_t* n_dev) {
  return min(n_items, (uint32_t)max(__ldg(n_dev), 0));
}

// Pass 1 with each list's length on the device: the counts of the
// chunks past it are 0 (written in the counts' own order), and the blocks
// walk the chunks that hold items.
template <class P>
__global__ void __launch_bounds__(kBinThreads)
bin_count_live_kernel(P p, BinShape S, int32_t* __restrict__ counts,
                      const int32_t* __restrict__ n_dev) {
  constexpr uint32_t kChunk = P::kItems * kBinThreads;
  extern __shared__ int32_t hist[];  // [n_bins]
  const uint32_t n_items = live_items(S.n_items, n_dev);
  const uint32_t live = (n_items + kChunk - 1) / kChunk;
  const uint32_t empty = S.n_chunks - live;
  const uint64_t n_zero = (uint64_t)S.groups * S.n_bins * empty;
  for (uint64_t t = (uint64_t)blockIdx.x * kBinThreads + threadIdx.x;
       t < n_zero; t += (uint64_t)gridDim.x * kBinThreads)
    counts[t / empty * S.n_chunks + live + t % empty] = 0;
  for (uint32_t b = blockIdx.x; b < S.groups * live;
       b += gridDim.x) {  // block-uniform
    count_chunk(p, S, counts, hist, b % S.groups, b / S.groups, n_items);
    __syncthreads();  // hist is zeroed again for the next chunk
  }
}

// Pass 3: each item's record written to its bin in list order (see the
// head of this file).
template <class P>
__device__ __forceinline__ void scatter_chunk(
    const P& p, const BinShape& S, const int32_t* __restrict__ offsets,
    float4* smem4, int32_t* ws, uint32_t l, uint32_t c, uint32_t n_items) {
  constexpr int kItems = P::kItems;  // groups of 32 a warp
  constexpr uint32_t kChunk = kItems * kBinThreads;
  const uint32_t nbins = S.n_bins;
  float4* stage = smem4;  // [kChunk * kStageBytes / 16]
  int32_t* wcnt = reinterpret_cast<int32_t*>(
      smem4 + kChunk * P::kStageBytes / 16);        // [warps][nbins]
  int32_t* lstart = wcnt + kBinWarps * nbins;       // [nbins]
  int32_t* gbase = lstart + nbins;                  // [nbins]
  uint16_t* skey = reinterpret_cast<uint16_t*>(gbase + nbins);  // [kChunk]
  const uint32_t lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (uint32_t k = threadIdx.x; k < nbins; k += kBinThreads) {
    gbase[k] = __ldg(offsets + ((size_t)l * nbins + k) * S.n_chunks + c);
    for (int w = 0; w < kBinWarps; ++w) wcnt[w * nbins + k] = 0;
  }
  const uint32_t s_warp = c * kChunk + warp * kItems * 32 + lane;
  typename P::Item item[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const uint32_t s = s_warp + it * 32;
    if (s < n_items) p.fetch(l, s, item[it]);
  }
  __syncthreads();
  int32_t* mine = wcnt + warp * nbins;
  int key[kItems], rank[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const uint32_t s = s_warp + it * 32;
    key[it] = s < n_items ? p.bin(l, s, item[it]) : -1;
    rank[it] = 0;
    const uint32_t peers = __match_any_sync(0xffffffffu, key[it]);
    const uint32_t before = peers & ((1u << lane) - 1);
    if (key[it] >= 0) rank[it] = mine[key[it]] + __popc(before);
    __syncwarp();
    if (key[it] >= 0 && before == 0) mine[key[it]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (uint32_t k = threadIdx.x; k < nbins; k += kBinThreads) {
    int32_t run = 0;
    for (int w = 0; w < kBinWarps; ++w) {
      const int32_t n_w = wcnt[w * nbins + k];
      wcnt[w * nbins + k] = run;
      run += n_w;
    }
    lstart[k] = run;  // the bin's total, scanned below
  }
  __syncthreads();
  int32_t kept = 0;
  for (uint32_t k0 = 0; k0 < nbins; k0 += kBinThreads) {  // block-uniform
    const uint32_t k = k0 + threadIdx.x;
    int32_t total;
    const int32_t ex = block_exclusive_scan<kBinThreads>(
        k < nbins ? lstart[k] : 0, ws, &total);
    if (k < nbins) lstart[k] = kept + ex;
    kept += total;
  }
  __syncthreads();
#pragma unroll
  for (int it = 0; it < kItems; ++it)
    if (key[it] >= 0) p.load(l, s_warp + it * 32, item[it]);
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    if (key[it] < 0) continue;
    const int q = lstart[key[it]] + mine[key[it]] + rank[it];
    p.stage(stage, q, l, item[it]);
    skey[q] = (uint16_t)key[it];
  }
  __syncthreads();
  for (int32_t i = threadIdx.x; i < kept; i += kBinThreads) {
    const int k = skey[i];
    p.write(stage, i, gbase[k] + i - lstart[k]);
  }
}

template <class P>
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_kernel(P p, BinShape S, const int32_t* __restrict__ offsets) {
  extern __shared__ float4 smem4[];
  __shared__ int32_t ws[kBinWarps];
  scatter_chunk(p, S, offsets, smem4, ws, blockIdx.x % S.groups,
                blockIdx.x / S.groups, S.n_items);
}

// Pass 3 with each list's length on the device (bin_count_live_kernel's).
template <class P>
__global__ void __launch_bounds__(kBinThreads)
bin_scatter_live_kernel(P p, BinShape S, const int32_t* __restrict__ offsets,
                        const int32_t* __restrict__ n_dev) {
  constexpr uint32_t kChunk = P::kItems * kBinThreads;
  extern __shared__ float4 smem4[];
  __shared__ int32_t ws[kBinWarps];
  const uint32_t n_items = live_items(S.n_items, n_dev);
  const uint32_t live = (n_items + kChunk - 1) / kChunk;
  for (uint32_t b = blockIdx.x; b < S.groups * live;
       b += gridDim.x) {  // block-uniform
    scatter_chunk(p, S, offsets, smem4, ws, b % S.groups, b / S.groups,
                  n_items);
    __syncthreads();  // the shared arrays are filled again for the next one
  }
}

// One pass of a radix sort: the item's bin is its key's digit (key >>
// shift) & mask; its record is (key, payload).  key_in holds the first
// pass's keys capped at `limit` (K3 sorts an index outside the rows, as
// `limit`, after every row); pay_in == nullptr: item s's payload is s.
struct RadixBins {
  static constexpr int kItems = 8;  // 2048 items a chunk
  static constexpr int kStageBytes = 8;
  struct Item {
    uint32_t key, pay;
  };
  const uint32_t* key_in;
  const uint32_t* pay_in;
  uint32_t* key_out;
  uint32_t* pay_out;
  uint32_t n_items, shift, mask, limit;

  __device__ __forceinline__ void fetch(uint32_t l, uint32_t s,
                                        Item& it) const {
    const size_t t = (size_t)l * n_items + s;
    it.key = min(__ldg(key_in + t), limit);
    it.pay = pay_in ? __ldg(pay_in + t) : s;
  }
  __device__ __forceinline__ int bin(uint32_t, uint32_t, const Item& it) const {
    return (int)((it.key >> shift) & mask);
  }
  __device__ __forceinline__ void load(uint32_t, uint32_t, Item&) const {}
  __device__ __forceinline__ void stage(float4* st, int q, uint32_t,
                                        const Item& it) const {
    reinterpret_cast<uint2*>(st)[q] = make_uint2(it.key, it.pay);
  }
  __device__ __forceinline__ void write(const float4* st, int i,
                                        int32_t dst) const {
    const uint2 v = reinterpret_cast<const uint2*>(st)[i];
    key_out[dst] = v.x;
    pay_out[dst] = v.y;
  }
};

constexpr uint32_t kRadixChunk = RadixBins::kItems * kBinThreads;
constexpr int kMaxDigitBits = 10;
constexpr int64_t kMaxRadixCounts = 1LL << 22;

// The passes of a radix sort of `groups` lists of n_items keys below
// 2^key_bits: digits of at most kMaxDigitBits bits, narrower where the
// counts (groups * n_chunks * 2^bits) would pass kMaxRadixCounts, split
// as evenly as the passes allow.
struct RadixPlan {
  int passes;
  int bits[8];
  uint32_t n_chunks;
  int64_t counts_ints;  // the widest pass's counts, its total and its sums
};

inline RadixPlan radix_plan(uint32_t n_items, uint32_t groups, int key_bits) {
  RadixPlan R;
  if (key_bits < 1) key_bits = 1;
  R.n_chunks = (n_items + kRadixChunk - 1) / kRadixChunk;
  int d = kMaxDigitBits;
  while (d > 4 && ((int64_t)groups * R.n_chunks << d) > kMaxRadixCounts) --d;
  R.passes = (key_bits + d - 1) / d;  // <= 8: key_bits <= 32, d >= 4
  const int base = key_bits / R.passes, extra = key_bits % R.passes;
  int widest = 0;
  for (int i = 0; i < R.passes; ++i) {
    R.bits[i] = base + (i < extra ? 1 : 0);
    if (R.bits[i] > widest) widest = R.bits[i];
  }
  const int64_t m = (int64_t)groups * R.n_chunks << widest;
  R.counts_ints = m + 1 + scan_blocks(m);
  return R;
}

// Bits to hold every value in [0, v].
inline int bits_for(uint64_t v) {
  int b = 0;
  while (b < 64 && (v >> b)) ++b;
  return b;
}

// Sorts the pairs (min(keys[t], limit), t - l * n_items) of each list l
// stably by key, ping-ponging between (kA, pA) and (kB, pB); returns the
// buffers that hold the result in *keys_out / *pay_out.  counts holds
// plan.counts_ints ints.  n_items >= 1.  pay0: the pairs' payloads
// instead of t - l * n_items; n_dev: a list's items on the device (at
// most n_items).  (kB, pB) may be (keys, pay0).
inline int run_radix(const RadixPlan& R, uint32_t n_items, uint32_t groups,
                     const uint32_t* keys, uint32_t limit, uint32_t* kA,
                     uint32_t* pA, uint32_t* kB, uint32_t* pB,
                     int32_t* counts, cudaStream_t st,
                     const uint32_t** keys_out, const uint32_t** pay_out,
                     const uint32_t* pay0 = nullptr,
                     const int32_t* n_dev = nullptr) {
  const uint32_t* kin = keys;
  const uint32_t* pin = pay0;
  uint32_t shift = 0;
  for (int i = 0; i < R.passes; ++i) {
    uint32_t* kout = (i & 1) ? kB : kA;
    uint32_t* pout = (i & 1) ? pB : pA;
    const BinShape S{n_items, groups, 1u << R.bits[i], R.n_chunks};
    const RadixBins b{kin,    pin,   kout,
                      pout,   n_items, shift,
                      S.n_bins - 1, i == 0 ? limit : 0xffffffffu};
    const int64_t m = bin_counts(S);
    const size_t smem = bin_scatter_smem<RadixBins>(S.n_bins);
    const size_t hist = S.n_bins * sizeof(int32_t);
    int blocks = (int)(R.n_chunks * groups);
    if (n_dev) {
      int err = allow_smem((const void*)bin_scatter_live_kernel<RadixBins>,
                           smem);
      if (err) return err;
      if (blocks > (int)kDeviceCountBlocks) blocks = kDeviceCountBlocks;
      bin_count_live_kernel<RadixBins><<<blocks, kBinThreads, hist, st>>>(
          b, S, counts, n_dev);
      launch_scan(counts, m, counts + m + 1, st);
      bin_scatter_live_kernel<RadixBins><<<blocks, kBinThreads, smem, st>>>(
          b, S, counts, n_dev);
    } else {
      int err = allow_smem((const void*)bin_scatter_kernel<RadixBins>, smem);
      if (err) return err;
      bin_count_kernel<RadixBins><<<blocks, kBinThreads, hist, st>>>(b, S,
                                                                     counts);
      launch_scan(counts, m, counts + m + 1, st);
      bin_scatter_kernel<RadixBins><<<blocks, kBinThreads, smem, st>>>(
          b, S, counts);
    }
    kin = kout;
    pin = pout;
    shift += R.bits[i];
  }
  *keys_out = kin;
  *pay_out = pin;
  return 0;
}

// Where each list's keys land in a start table: list l's key k counts at
// base[l] + k when k < size[l] (kernel B: each level's rows of the table;
// K3: one list, its rows), and is left out otherwise.
struct KeyGroups {
  uint32_t base[kMaxGroups];
  uint32_t size[kMaxGroups];
};

// Each run of equal keys in the sorted lists adds its length to its row's
// count: -j at its first position j, +(j + 1) at its last (integer adds,
// two a run, whatever their order).  n_dev as in run_radix.
__global__ void __launch_bounds__(kBinThreads)
key_runs_kernel(const uint32_t* __restrict__ keys, uint32_t n_items,
                uint32_t groups, KeyGroups G, int32_t* __restrict__ hist,
                const int32_t* __restrict__ n_dev) {
  const uint32_t n_live = n_dev ? live_items(n_items, n_dev) : n_items;
  const uint64_t total = (uint64_t)n_live * groups;
  for (uint64_t u = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       u < total; u += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t l = (uint32_t)(u / n_live);
    const uint32_t j = (uint32_t)(u - (uint64_t)l * n_live);
    const uint64_t t = (uint64_t)l * n_items + j;
    const uint32_t k = __ldg(keys + t);
    if (k >= G.size[l]) continue;
    int32_t* h = hist + G.base[l] + k;
    if (j == 0 || __ldg(keys + t - 1) != k) atomicAdd(h, -(int32_t)j);
    if (j + 1 == n_live || __ldg(keys + t + 1) != k)
      atomicAdd(h, (int32_t)j + 1);
  }
}

// start [m + 1 + scan_blocks(m)] ints from the sorted keys: start[r] the
// first sorted position of row r (the rows' run lengths, then scanned),
// start[m] the number kept.  A list whose keys all land is laid out in
// the sorted order at l * n_items, so start[] indexes the sorted pairs
// directly.  n_dev as in run_radix.
inline void key_starts(const uint32_t* sorted_keys, uint32_t n_items,
                       uint32_t groups, const KeyGroups& G, int64_t m,
                       int32_t* start, cudaStream_t st,
                       const int32_t* n_dev = nullptr) {
  cudaMemsetAsync(start, 0, (size_t)m * sizeof(int32_t), st);
  uint64_t total = (uint64_t)n_items * groups;
  uint64_t blocks = (total + kBinThreads - 1) / kBinThreads;
  if (blocks > (1u << 20)) blocks = 1u << 20;
  if (n_dev && blocks > kDeviceCountBlocks) blocks = kDeviceCountBlocks;
  if (blocks < 1) blocks = 1;
  key_runs_kernel<<<(int)blocks, kBinThreads, 0, st>>>(sorted_keys, n_items,
                                                       groups, G, start,
                                                       n_dev);
  launch_scan(start, m, start + m + 1, st);
}

}  // namespace jn_bins
