// Kernel V for Hopper (sm_90a): the table gradient of the Plenoxels corner
// gather (ops/voxel_grid.py::corner_gather), summed in a fixed order.
//
// The gather reads out_t[n] = sum_c w[n, c] * table_t[idx[n, c]] for each
// table t (density, width 1; SH, width 27).  Its adjoint adds, for every
// item (sample n, corner c), w[n, c] * g_t[n] into row idx[n, c] of each
// table's gradient: the XLA scatter that autodiff makes of the JAX code's
// jnp.take (jnerf_tpu/ops/voxel_grid.py:100 dense, :255-256 sparse).
// Each (row, channel) is the sum from +0.0 of its kept items in item order
// (n * K + c), with no float atomics; an item is left out when its weight
// is 0 (the sparse grid's empty corners), its row lies outside [0,
// n_rows), or every table's g of its sample is 0 (the samples past a ray's
// exit, which the compositing masks).  A left-out item would add +0.0 or
// -0.0, which leaves an f32 sum from +0.0 as it is.  That is the order of
// the plain version, voxel_grid.corner_grad_plain: index_add_ on the CPU
// of the kept items in item order.
//
// The function is bound by bytes: the whole [n_rows, C] gradient is
// written (1.88 GB for the dense 256^3 grid's 28 channels), beside the
// samples' g (0.5-1 GB) and the items' index and weight.  So the design
// moves few bytes beyond those and keeps dependent loads off the long
// paths:
//   1. compaction: voxel_live_kernel reads each block of samples' g rows
//      once as one coalesced run a table and marks the live samples; only
//      for those it reads idx (and w), and leaves a mask of the sample's
//      kept entries and the block's count.  After a scan of the counts
//      (bins.cuh's launch_scan, whose total, the kept count, stays on the
//      device), voxel_compact_kernel writes the kept entries' (key,
//      payload) in entry order.
//   2. one stable radix sort of the kept entries by key (bins.cuh's
//      run_radix, reading the kept count on the device: the grids and the
//      work space are sized on the host from (n, K, n_rows) alone, so a
//      CUDA graph captures the launch), and key_starts's first sorted
//      position of each key.  On the sample path voxel_weights_kernel then
//      copies the sorted samples' weights, corner by corner, so that a
//      run's weights are read as one contiguous run.
//   3. voxel_tile_kernel: a warp owns kWarpRows consecutive rows and works
//      alone.  It loads its rows' sorted entries (sample and weight) into
//      shared memory, orders each row's items (a lane a row), sums each
//      (row, channel) from +0.0 in item order (a lane a channel) with
//      kBatch g loads issued before their adds, and writes its rows of
//      each table as one run of 16-byte stores.  A row with no item is
//      written +0.0 with no load.  Many small tiles in flight, with no
//      block barrier between their phases, hide the chain of dependent
//      loads (starts, entries, g) that a tile of the dense grid's rows
//      (about one item a row) is made of.
// Two ways to key an entry:
//   - the item path (any idx: the sparse grid's links): an entry is a kept
//     item, its key its row, its payload n * K + c; a row's items are one
//     run of the sort, already in item order;
//   - the sample path (the dense grid, where corners() gives every corner
//     row as a base row plus off[c]): idx holds the [n] base rows, corner
//     c's row is idx[n] + off[c], and an entry is a live sample whose base
//     row lies in [0, n_rows) (one whose base row does not adds nothing),
//     its key that base row, its payload n.
//     Row r's items are the K runs of base rows r - off[c]; a sample adds
//     at most one corner to a row (for distinct offsets), so merging the
//     runs by sample (then corner) gives item order.  An item of weight 0
//     is skipped in the sum.  It sorts the ~2.1M live samples of a dense
//     step instead of its ~17M kept items.
// A row whose entries do not fit in a warp's window is summed from the
// sorted arrays in device memory, merging its runs one item at a time.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bins.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTables = 4;
constexpr int kMaxCorners = 8;
constexpr int kCompactSamples = 1024;  // samples a compaction block
constexpr int kWarpRows = 32;      // output rows a warp of the sum owns
constexpr int kWarpEntries = 64;   // sorted entries a warp's window holds
constexpr int kSumWarps = 4;                     // warps a sum block
constexpr int kTileRows = kSumWarps * kWarpRows;  // output rows a sum block
constexpr int kEntriesPerLane = kWarpEntries / 32;
constexpr int kBatch = 8;      // g loads a lane issues before its adds
constexpr int kMaxChannels = 32;  // a lane a channel

struct Tables {
  const float* g[kMaxTables];  // [n, width] each
  float* out[kMaxTables];      // [n_rows, width] each
  int width[kMaxTables];
  float inv_width[kMaxTables];
  int first[kMaxTables + 1];  // each table's first channel
  int channels;               // C, first[n_tables]
  int n_tables;
};

// Where a row's items lie among the sorted entries: run c of row r holds
// the entries of key r - off[c].
struct Runs {
  int32_t off[kMaxCorners];
  int n_runs;   // K on the sample path, 1 on the item path
  int samples;  // 1: the sample path
};

int64_t up4(int64_t v) { return (v + 3) / 4 * 4; }

// A sum warp's shared memory (rows: the warp's own).
struct WarpSmem {
  alignas(16) float stage[kWarpRows * kMaxChannels];  // the warp's rows
  int32_t st[kMaxCorners][kWarpRows + 1];  // run c's start at row i
  int32_t rbeg[kWarpRows + 1];  // row i's first entry among the warp's
  int32_t run_base[kMaxCorners + 1];  // run c's first entry in e_*
  int32_t e_s[kWarpEntries];  // a window's entries' samples, run by run
  float e_w[kWarpEntries];    // their weights
  int32_t m_s[kWarpEntries];  // the same in row, then item order
  float m_w[kWarpEntries];
  uint8_t prow[kWarpEntries];  // the row of each position of that order
};

// Step 1a.  A block's kCompactSamples samples: live[i] = some g of sample
// s0 + i is not 0 (each table's rows of the block read as one run,
// float4 loads where it is 16-byte aligned); then each sample's kept
// entries as a bit mask: on the item path bit c when w[s, c] != 0 and
// idx[s, c] lies in [0, n_rows), on the sample path bit 0 when the base
// row idx[s] does; counts[block] = the block's kept entries.
__global__ void __launch_bounds__(kThreads)
voxel_live_kernel(const int64_t* __restrict__ idx,
                  const float* __restrict__ w, Tables T, int n, int K,
                  int n_rows, int samples, uint8_t* __restrict__ mask,
                  int32_t* __restrict__ counts) {
  __shared__ int32_t live[kCompactSamples];
  __shared__ int32_t ws[kWarps];
  const int64_t s0 = (int64_t)blockIdx.x * kCompactSamples;
  const int ns = (int)min((int64_t)kCompactSamples, n - s0);
  for (int i = threadIdx.x; i < kCompactSamples; i += kThreads) live[i] = 0;
  __syncthreads();
#pragma unroll
  for (int t = 0; t < kMaxTables; ++t) {  // constant indices: no local copy
    if (t >= T.n_tables) break;
    const int width = T.width[t];
    const float inv = T.inv_width[t];
    const float* g = T.g[t] + s0 * width;
    const int total = ns * width;
    // Element e of the run is channel e % width of sample e / width
    // (exact in f32 for e < 2^23 and width <= kMaxChannels).
    auto mark = [&](int e, float v) {
      if (v != 0.0f) live[(int)(((float)e + 0.5f) * inv)] = 1;
    };
    const int head =
        min(total, (int)(((16 - ((uintptr_t)g & 15)) & 15) >> 2));
    for (int e = threadIdx.x; e < head; e += kThreads) mark(e, __ldg(g + e));
    const float4* g4 = reinterpret_cast<const float4*>(g + head);
    const int nq = (total - head) >> 2;
#pragma unroll 4
    for (int q = threadIdx.x; q < nq; q += kThreads) {
      const float4 v = __ldg(g4 + q);
      const int e = head + 4 * q;
      mark(e, v.x);
      mark(e + 1, v.y);
      mark(e + 2, v.z);
      mark(e + 3, v.w);
    }
    for (int e = head + 4 * nq + threadIdx.x; e < total; e += kThreads)
      mark(e, __ldg(g + e));
  }
  __syncthreads();
  int32_t kept = 0;
  for (int i = threadIdx.x; i < kCompactSamples; i += kThreads) {
    if (i >= ns) break;
    uint32_t m = 0;
    if (live[i]) {
      const int64_t s = s0 + i;
      if (samples) {
        const int64_t b = __ldg(idx + s);
        m = (b >= 0 && b < n_rows) ? 1u : 0u;
      } else {
        int64_t row[kMaxCorners];
        float wc[kMaxCorners];
#pragma unroll
        for (int c = 0; c < kMaxCorners; ++c)
          if (c < K) {
            row[c] = __ldg(idx + s * K + c);
            wc[c] = __ldg(w + s * K + c);
          }
#pragma unroll
        for (int c = 0; c < kMaxCorners; ++c)
          if (c < K && wc[c] != 0.0f && row[c] >= 0 && row[c] < n_rows)
            m |= 1u << c;
      }
    }
    mask[s0 + i] = (uint8_t)m;
    kept += __popc(m);
  }
  int32_t total;
  jn_bins::block_exclusive_scan<kThreads>(kept, ws, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Step 1b.  offsets: each block's first kept position (counts scanned).
// Each round's samples take their positions in sample order by a block
// scan; a sample's entries follow in corner order.
__global__ void __launch_bounds__(kThreads)
voxel_compact_kernel(const int64_t* __restrict__ idx,
                     const uint8_t* __restrict__ mask,
                     const int32_t* __restrict__ offsets, int n, int K,
                     int samples, uint32_t* __restrict__ keys,
                     uint32_t* __restrict__ pay) {
  __shared__ int32_t ws[kWarps];
  const int64_t s0 = (int64_t)blockIdx.x * kCompactSamples;
  const int ns = (int)min((int64_t)kCompactSamples, n - s0);
  int32_t at = __ldg(offsets + blockIdx.x);
  for (int r = 0; r < kCompactSamples / kThreads; ++r) {  // block-uniform
    const int i = r * kThreads + threadIdx.x;
    const uint32_t m = i < ns ? __ldg(mask + s0 + i) : 0u;
    int32_t round_total;
    int32_t pos = at + jn_bins::block_exclusive_scan<kThreads>(
                           __popc(m), ws, &round_total);
    if (m) {
      const int64_t s = s0 + i;
      if (samples) {
        keys[pos] = (uint32_t)__ldg(idx + s);
        pay[pos] = (uint32_t)s;
      } else {
        for (int c = 0; c < K; ++c)
          if (m >> c & 1u) {
            keys[pos] = (uint32_t)__ldg(idx + s * K + c);
            pay[pos] = (uint32_t)(s * K + c);
            ++pos;
          }
      }
    }
    at += round_total;
  }
}

struct SumArgs {
  const int32_t* start;   // [n_rows + 1]: a key's first sorted entry
  const uint32_t* pay;    // the sorted payloads
  const float* w;         // [n, K]
  const float* wsorted;   // sample path: [K, wstride], the sorted
  int64_t wstride;        // samples' weights, corner by corner
  int n_rows, K;
};

// A lane's channel: its g, the channel in its table, the table's width
// and where the channel's column starts in a warp's staging area.
struct Channel {
  const float* g;
  int f, width, stage;
  bool on;
};

__device__ __forceinline__ Channel channel_of(const Tables& T, int ch) {
  Channel h{T.g[0], 0, 1, 0, false};
#pragma unroll
  for (int t = 0; t < kMaxTables; ++t)  // constant indices: no local copy
    if (t < T.n_tables && ch >= T.first[t] && ch < T.first[t + 1]) {
      h = Channel{T.g[t], ch - T.first[t], T.width[t],
                  T.first[t] * kWarpRows + ch - T.first[t], true};
    }
  return h;
}

// One warp's sum: its rows and its lane's channel.
struct Sum {
  const SumArgs& A;
  const Runs& R;
  const Tables& T;
  WarpSmem& S;
  int64_t r0;  // the warp's first row
  int rows, lane;
  Channel h;

  // Row i's sum into the staging area.
  __device__ __forceinline__ void close_row(int i, float v) {
    if (h.on) S.stage[h.stage + i * h.width] = v;
  }

  // The warp's rows of each table out as one run (zeros when stage is
  // null): 16-byte stores where the output is aligned (the staging area
  // is).
  __device__ __forceinline__ void write_rows(const float* stage) {
#pragma unroll
    for (int t = 0; t < kMaxTables; ++t) {
      if (t >= T.n_tables) break;
      const int width = T.width[t], total = rows * width;
      const float* src = stage ? stage + T.first[t] * kWarpRows : nullptr;
      float* dst = T.out[t] + r0 * width;
      int done = 0;
      if (((uintptr_t)dst & 15) == 0) {
        done = total & ~3;
        for (int q = lane; q < done / 4; q += 32)
          reinterpret_cast<float4*>(dst)[q] =
              src ? reinterpret_cast<const float4*>(src)[q]
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      for (int e = done + lane; e < total; e += 32)
        dst[e] = src ? src[e] : 0.0f;
    }
  }

  // Rows [i, i1) have no item: +0.0, no load.
  __device__ __forceinline__ void close_empty(int i, int i1) {
    for (; i < i1; ++i) close_row(i, 0.0f);
  }

  // The run of a window's entry q.
  __device__ __forceinline__ int run_of(int q) const {
    int c = 0;
#pragma unroll
    for (int step = kMaxCorners / 2; step >= 1; step >>= 1)
      if (c + step < R.n_runs && q >= S.run_base[c + step]) c += step;
    return c;
  }

  // A row whose entries alone pass the warp's window: its runs merged
  // from the sorted arrays in device memory, one item at a time.
  __device__ __forceinline__ void row_slowly(int i) {
    int32_t cur[kMaxCorners], last[kMaxCorners], head[kMaxCorners];
#pragma unroll
    for (int c = 0; c < kMaxCorners; ++c) {
      cur[c] = c < R.n_runs ? S.st[c][i] : 0;
      last[c] = c < R.n_runs ? S.st[c][i + 1] : 0;
      head[c] = cur[c] < last[c] ? (int32_t)__ldg(A.pay + cur[c]) : 0;
    }
    float acc = 0.0f;
    for (;;) {
      int best = -1;
      int32_t bs = 0;  // the best run's sample
#pragma unroll
      for (int c = 0; c < kMaxCorners; ++c) {
        if (cur[c] >= last[c]) continue;
        const int32_t s =
            R.samples ? head[c] : (int32_t)((uint32_t)head[c] / A.K);
        if (best < 0 || s < bs) {
          best = c;
          bs = s;
        }
      }
      if (best < 0) break;
      float wv = 0.0f;
#pragma unroll
      for (int c = 0; c < kMaxCorners; ++c)
        if (c == best) {
          wv = R.samples ? __ldg(A.wsorted + c * A.wstride + cur[c])
                         : __ldg(A.w + (uint32_t)head[c]);
          ++cur[c];
          head[c] = cur[c] < last[c] ? (int32_t)__ldg(A.pay + cur[c]) : 0;
        }
      if (h.on && wv != 0.0f)
        acc = __fadd_rn(
            acc, __fmul_rn(wv, __ldg(h.g + (int64_t)bs * h.width + h.f)));
    }
    close_row(i, acc);
  }

  // Rows [w0, w1), whose entries fit: load them (sample and weight), order
  // each row's entries by item (a lane a row merges its runs), then sum
  // them as one stream of positions, closing each row as it passes.
  __device__ __forceinline__ void window(int w0, int w1) {
    const int32_t base = S.rbeg[w0];
    const int ew = S.rbeg[w1] - base;
    {
      const int len = lane < R.n_runs ? S.st[lane][w1] - S.st[lane][w0] : 0;
      int32_t x = len;
#pragma unroll
      for (int o = 1; o < kMaxCorners; o <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (lane < R.n_runs) S.run_base[lane + 1] = x;
      if (lane == 0) S.run_base[0] = 0;
    }
    __syncwarp();
    // Every load of a lane's entries is issued before the first store.
    uint32_t pv[kEntriesPerLane];
    float wv[kEntriesPerLane];
#pragma unroll
    for (int k = 0; k < kEntriesPerLane; ++k) {
      const int q = lane + 32 * k;
      if (q < ew) {
        const int c = run_of(q);
        const int32_t p = S.st[c][w0] + (q - S.run_base[c]);
        pv[k] = __ldg(A.pay + p);
        if (R.samples) wv[k] = __ldg(A.wsorted + c * A.wstride + p);
      }
    }
#pragma unroll
    for (int k = 0; k < kEntriesPerLane; ++k) {
      const int q = lane + 32 * k;
      if (q < ew) {
        if (R.samples) {
          S.e_s[q] = (int32_t)pv[k];
        } else {
          S.e_s[q] = (int32_t)(pv[k] / (uint32_t)A.K);
          wv[k] = __ldg(A.w + pv[k]);
        }
        S.e_w[q] = wv[k];
      }
    }
    __syncwarp();
    // Lane i merges row w0 + i's runs (each sorted by sample): the
    // smallest sample first, the smaller corner first on a tie.  One run
    // (the item path) is in item order already.
    const int32_t* ms = R.n_runs > 1 ? S.m_s : S.e_s;
    const float* mw = R.n_runs > 1 ? S.m_w : S.e_w;
    {
      const int i = w0 + lane;
      if (i < w1 && R.n_runs == 1) {
        for (int p = S.rbeg[i] - base; p < S.rbeg[i + 1] - base; ++p)
          S.prow[p] = (uint8_t)i;
      } else if (i < w1) {
        int32_t cur[kMaxCorners], last[kMaxCorners];
#pragma unroll
        for (int c = 0; c < kMaxCorners; ++c) {
          cur[c] = last[c] = 0;
          if (c < R.n_runs) {
            cur[c] = S.run_base[c] + S.st[c][i] - S.st[c][w0];
            last[c] = S.run_base[c] + S.st[c][i + 1] - S.st[c][w0];
          }
        }
        int at = S.rbeg[i] - base;
        for (;;) {
          int best = -1;
          int32_t bs = 0;
#pragma unroll
          for (int c = 0; c < kMaxCorners; ++c)
            if (cur[c] < last[c]) {
              const int32_t sc = S.e_s[cur[c]];
              if (best < 0 || sc < bs) {
                best = c;
                bs = sc;
              }
            }
          if (best < 0) break;
          int q = 0;
#pragma unroll
          for (int c = 0; c < kMaxCorners; ++c)
            if (c == best) q = cur[c]++;
          S.prow[at] = (uint8_t)i;
          S.m_s[at] = bs;
          S.m_w[at++] = S.e_w[q];
        }
      }
      __syncwarp();
    }
    // The stream: a batch's entries (weight, row, g) read into registers,
    // then added in order, closing rows as the stream passes them.
    int i = w0;
    float acc = 0.0f;
    for (int p0 = 0; p0 < ew; p0 += kBatch) {
      float gv[kBatch], wv[kBatch];
      int rv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        gv[u] = wv[u] = 0.0f;
        rv[u] = w1;
        if (p0 + u < ew) {
          wv[u] = mw[p0 + u];
          rv[u] = S.prow[p0 + u];
          if (h.on && wv[u] != 0.0f)
            gv[u] = __ldg(h.g + (int64_t)ms[p0 + u] * h.width + h.f);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (rv[u] >= w1) break;
        for (; i < rv[u]; ++i) {  // row i is done
          close_row(i, acc);
          acc = 0.0f;
        }
        if (wv[u] != 0.0f) acc = __fadd_rn(acc, __fmul_rn(wv[u], gv[u]));
      }
    }
    close_row(i, acc);
    close_empty(i + 1, w1);
    __syncwarp();
  }
};

// Step 3.  Warp k of block b owns rows [(b * kSumWarps + k) * kWarpRows,
// ...) and works alone (a barrier only at the start): each run's start at
// each of its rows, each row's first entry among its rows (a warp scan),
// then windows of rows whose entries fit in its shared memory, summed into
// its staging area and written at the end.
__global__ void __launch_bounds__(kSumWarps * 32)
voxel_tile_kernel(SumArgs A, Runs R, Tables T) {
  __shared__ WarpSmem smem[kSumWarps];
  __shared__ int32_t off[kMaxCorners];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kMaxCorners) {
#pragma unroll
    for (int c = 0; c < kMaxCorners; ++c)  // constant indices
      if ((int)threadIdx.x == c) off[c] = R.off[c];
  }
  __syncthreads();
  const int64_t r0 = ((int64_t)blockIdx.x * kSumWarps + warp) * kWarpRows;
  if (r0 >= A.n_rows) return;
  WarpSmem& S = smem[warp];
  const int rows = (int)min((int64_t)kWarpRows, (int64_t)A.n_rows - r0);
  // Lane i: each run's start at row i and at row i + 1 (all loads
  // first); row i's entries are their differences.
  int32_t s0[kMaxCorners], s1[kMaxCorners];
#pragma unroll
  for (int c = 0; c < kMaxCorners; ++c)
    if (c < R.n_runs) {
      const int64_t b = r0 + lane - off[c];
      s0[c] = __ldg(A.start + min(max(b, (int64_t)0), (int64_t)A.n_rows));
      s1[c] = __ldg(A.start + min(max(b + 1, (int64_t)0), (int64_t)A.n_rows));
    }
  int32_t x = 0;  // lane i: row i's entries, then scanned
#pragma unroll
  for (int c = 0; c < kMaxCorners; ++c)
    if (c < R.n_runs && lane <= rows) {
      S.st[c][lane] = s0[c];
      if (lane == rows - 1) S.st[c][rows] = s1[c];
      if (lane < rows) x += s1[c] - s0[c];
    }
  __syncwarp();
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  S.rbeg[lane + 1] = x;
  if (lane == 0) S.rbeg[0] = 0;
  const int32_t total = __shfl_sync(0xffffffffu, x, 31);
  Sum sum{A, R, T, S, r0, rows, lane, channel_of(T, lane)};
  if (total == 0) {  // no item in the warp's rows: +0.0, no load
    sum.write_rows(nullptr);
    return;
  }
  __syncwarp();
  for (int w0 = 0; w0 < rows;) {  // warp-uniform
    // The most rows from w0 whose entries fit.
    int lo = w0, hi = rows;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (S.rbeg[mid] - S.rbeg[w0] <= kWarpEntries)
        lo = mid;
      else
        hi = mid - 1;
    }
    if (lo == w0) {  // row w0's entries alone do not fit
      sum.row_slowly(w0);
      ++w0;
    } else {
      sum.window(w0, lo);
      w0 = lo;
    }
  }
  __syncwarp();
  sum.write_rows(S.stage);
}

// The sample path's weights in sorted order, corner by corner:
// wsorted[c * stride + p] = w[order[p] * K + c] for the kept entries (their
// count on the device), so that the tile kernel reads a run's weights as
// one contiguous run.  32 positions a round: their w rows read whole,
// written out corner by corner through shared memory.
__global__ void __launch_bounds__(kThreads)
voxel_weights_kernel(const uint32_t* __restrict__ order,
                     const float* __restrict__ w, int K,
                     const int32_t* __restrict__ n_kept, int64_t stride,
                     float* __restrict__ wsorted) {
  static_assert(kThreads == 32 * kMaxCorners, "a thread a (position, corner)");
  __shared__ float tile[kMaxCorners][33];
  const int64_t kept = max(__ldg(n_kept), 0);
  const int j = threadIdx.x / kMaxCorners, c = threadIdx.x % kMaxCorners;
  const int c2 = threadIdx.x / 32, j2 = threadIdx.x % 32;
  for (int64_t p0 = (int64_t)blockIdx.x * 32; p0 < kept;
       p0 += (int64_t)gridDim.x * 32) {  // block-uniform
    if (c < K && p0 + j < kept)
      tile[c][j] = __ldg(w + (int64_t)__ldg(order + p0 + j) * K + c);
    __syncthreads();
    if (c2 < K && p0 + j2 < kept) wsorted[c2 * stride + p0 + j2] = tile[c2][j2];
    __syncthreads();
  }
}

struct Layout {
  int64_t M, n_blocks, key0, pay0, kA, pA, start, counts_c, counts_r, mask,
      wsort, total;
  jn_bins::RadixPlan R;
};

// The work space for n samples of K corners into n_rows rows: the sample
// path (samples != 0) keys n entries at most, the item path n * K.
bool layout(Layout* Lo, int n, int K, int n_rows, int samples) {
  if (n < 1 || K < 1 || K > kMaxCorners || n_rows < 1) return false;
  Lo->M = samples ? (int64_t)n : (int64_t)n * K;
  if (Lo->M >= (1LL << 31)) return false;
  Lo->n_blocks = (n + kCompactSamples - 1) / kCompactSamples;
  Lo->R = jn_bins::radix_plan((uint32_t)Lo->M, 1,
                              jn_bins::bits_for((uint32_t)(n_rows - 1)));
  int64_t at = 0;
  Lo->key0 = at, at += up4(Lo->M);
  Lo->pay0 = at, at += up4(Lo->M);
  Lo->kA = at, at += up4(Lo->M);
  Lo->pA = at, at += up4(Lo->M);
  Lo->start = at, at += up4(n_rows + 1 + jn_bins::scan_blocks(n_rows));
  Lo->counts_c = at,
  at += up4(Lo->n_blocks + 1 + jn_bins::scan_blocks(Lo->n_blocks));
  Lo->counts_r = at, at += up4(Lo->R.counts_ints);
  Lo->mask = at, at += up4((n + 3) / 4);
  Lo->wsort = at, at += samples ? up4((int64_t)n * K) : 0;
  Lo->total = at;
  return at < (1LL << 31);
}

}  // namespace

// Kernel V's int32 work space for n samples of K corners into n_rows rows
// on the sample path (samples != 0) or the item path: out[0] its size,
// out[1] and out[2] where the key starts [n_rows + 1] and the sorted
// payloads lie in it, out[3] and out[4] the rows a warp of the sum owns
// and the entries its window holds in shared memory, out[5] the most
// channels (the tables' widths summed) it takes; -1 if kernel V does not
// take the sizes.
extern "C" long long voxel_grad_layout(int n, int K, int n_rows, int samples,
                                       long long* out) {
  Layout Lo;
  if (!layout(&Lo, n, K, n_rows, samples)) return -1;
  out[0] = Lo.total;
  out[1] = Lo.start;
  out[2] = (Lo.R.passes & 1) ? Lo.pA : Lo.pay0;
  out[3] = kWarpRows;
  out[4] = kWarpEntries;
  out[5] = kMaxChannels;
  return Lo.total;
}

// Kernel V.  idx [n, K] int64 rows (the sample path: [n] base rows), w
// [n, K] f32; for each of n_tables tables, g [n, width] f32 in and out
// [n_rows, width] f32, every row written once; work as voxel_grad_layout
// gives it.  offsets: K corner offsets (offsets[0] = 0) for the sample
// path, whose rows are idx[n] + offsets[c]; null for the item path.  plan_only: the compaction, the sort
// and the key starts alone (out is not written).
extern "C" int voxel_grad(const void* idx, const void* w,
                          const void* const* g, void* const* out,
                          const int* widths, int n_tables,
                          const int* offsets, void* work, int n, int K,
                          int n_rows, int plan_only, void* stream) {
  const int samples = offsets != nullptr;
  Layout Lo;
  if (!layout(&Lo, n, K, n_rows, samples) || n_tables < 1 ||
      n_tables > kMaxTables)
    return (int)cudaErrorInvalidValue;
  Tables T;
  T.n_tables = n_tables;
  T.first[0] = 0;
  for (int t = 0; t < kMaxTables; ++t) {
    T.g[t] = nullptr;
    T.out[t] = nullptr;
    T.width[t] = 1;
    T.inv_width[t] = 1.0f;
  }
  for (int t = 0; t < n_tables; ++t) {
    if (widths[t] < 1) return (int)cudaErrorInvalidValue;
    T.g[t] = (const float*)g[t];
    T.out[t] = (float*)out[t];
    T.width[t] = widths[t];
    T.inv_width[t] = 1.0f / (float)widths[t];
    T.first[t + 1] = T.first[t] + widths[t];
  }
  const int C = T.channels = T.first[n_tables];
  if (C > kMaxChannels) return (int)cudaErrorInvalidValue;
  Runs R;
  R.samples = samples;
  R.n_runs = samples ? K : 1;
  for (int c = 0; c < kMaxCorners; ++c)
    R.off[c] = samples && c < K ? offsets[c] : 0;
  if (samples && R.off[0] != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* ws = (int32_t*)work;
  uint32_t* key0 = (uint32_t*)(ws + Lo.key0);
  uint32_t* pay0 = (uint32_t*)(ws + Lo.pay0);
  int32_t* counts_c = ws + Lo.counts_c;
  const int32_t* n_kept = counts_c + Lo.n_blocks;  // the scan's total
  uint8_t* mask = (uint8_t*)(ws + Lo.mask);
  const int blocks = (int)Lo.n_blocks;
  voxel_live_kernel<<<blocks, kThreads, 0, st>>>(
      (const int64_t*)idx, (const float*)w, T, n, K, n_rows, samples, mask,
      counts_c);
  jn_bins::launch_scan(counts_c, Lo.n_blocks, counts_c + Lo.n_blocks + 1,
                       st);
  voxel_compact_kernel<<<blocks, kThreads, 0, st>>>(
      (const int64_t*)idx, mask, counts_c, n, K, samples, key0, pay0);
  const uint32_t* keys;
  const uint32_t* order;
  int err = jn_bins::run_radix(
      Lo.R, (uint32_t)Lo.M, 1, key0, 0xffffffffu, (uint32_t*)(ws + Lo.kA),
      (uint32_t*)(ws + Lo.pA), key0, pay0, ws + Lo.counts_r, st, &keys,
      &order, pay0, n_kept);
  if (err) return err;
  jn_bins::KeyGroups G;
  G.base[0] = 0;
  G.size[0] = (uint32_t)n_rows;
  jn_bins::key_starts(keys, (uint32_t)Lo.M, 1, G, n_rows, ws + Lo.start, st,
                      n_kept);
  if (!plan_only) {
    float* wsorted = nullptr;
    if (samples) {
      wsorted = (float*)(ws + Lo.wsort);
      voxel_weights_kernel<<<(int)jn_bins::kDeviceCountBlocks, kThreads, 0,
                             st>>>(order, (const float*)w, K, n_kept, Lo.M,
                                   wsorted);
    }
    const SumArgs A{ws + Lo.start, order, (const float*)w, wsorted, Lo.M,
                    n_rows, K};
    const int tiles = (int)((n_rows + (int64_t)kTileRows - 1) / kTileRows);
    voxel_tile_kernel<<<tiles, kSumWarps * 32, 0, st>>>(A, R, T);
  }
  return (int)cudaGetLastError();
}
