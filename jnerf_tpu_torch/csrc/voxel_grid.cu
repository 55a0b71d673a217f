// Kernel V for Hopper (sm_90a): the table gradient of the Plenoxels corner
// gather (ops/voxel_grid.py::corner_gather), summed in a fixed order.
//
// The gather reads out_t[n] = sum_c w[n, c] * table_t[idx[n, c]] for each
// table t (density, width 1; SH, width 27).  Its adjoint adds, for every
// item (sample n, corner c), w[n, c] * g_t[n] into row idx[n, c] of each
// table's gradient: the XLA scatter that autodiff makes of the JAX code's
// jnp.take (jnerf_tpu/ops/voxel_grid.py:100 dense, :255-256 sparse).
// Here, with no float atomics:
//   1. voxel_keys_kernel gives each item its row as its key, or the drop
//      key n_rows when it adds only zeros: its weight is 0 (the sparse
//      grid's empty corners) or every table's g of its sample is 0 (the
//      samples past a ray's exit, which the compositing masks; clamped
//      onto the grid's faces, they would pile onto a few border rows).  A
//      left-out item would add +0.0 or -0.0, which leaves an f32 sum from
//      +0.0 as it is.
//   2. one stable radix sort of the items by key (bins.cuh's run_radix)
//      serves every table, and key_starts gives each row's first sorted
//      position;
//   3. voxel_sum_kernel (a warp a row, a lane a channel) sums each (row,
//      channel) from +0.0 over the row's items in sorted order, which is
//      item order, reading w by item and g by sample (the [items,
//      channels] products are never stored), and writes it once.
// That is the order of the plain version, voxel_grid.corner_grad_plain:
// index_add_ on the CPU of the kept items in item order.  Indices outside
// [0, n_rows) are left out (the callers' indices are in range).  The
// function is bound by bytes: the whole [n_rows, C] gradient is written
// (1.88 GB for the dense 256^3 grid's 28 channels), beside the items'
// index and weight and the samples' g.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bins.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTables = 4;
constexpr int kMaxCorners = 8;

struct Tables {
  const float* g[kMaxTables];  // [n, width] each
  float* out[kMaxTables];      // [n_rows, width] each
  int width[kMaxTables];
  int first[kMaxTables + 1];  // each table's first channel; first[T] = C
  int n_tables;
};

int grid_for(uint64_t threads) {
  uint64_t b = (threads + kThreads - 1) / kThreads;
  if (b > (1u << 20)) b = 1u << 20;
  return (int)(b < 1 ? 1 : b);
}

int64_t up4(int64_t v) { return (v + 3) / 4 * 4; }

// Step 1: a thread a sample; keys [n * K].
__global__ void __launch_bounds__(kThreads)
voxel_keys_kernel(const int64_t* __restrict__ idx, const float* __restrict__ w,
                  Tables T, uint32_t* __restrict__ keys, int n, int K,
                  uint32_t n_rows) {
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += (int64_t)gridDim.x * blockDim.x) {
    bool live = false;
    for (int t = 0; t < T.n_tables && !live; ++t) {
      const float* g = T.g[t] + s * T.width[t];
      for (int f = 0; f < T.width[t]; ++f) live |= __ldg(g + f) != 0.0f;
    }
    for (int c = 0; c < K; ++c) {
      const int64_t it = s * K + c;
      const int64_t row = __ldg(idx + it);
      const bool keep = live && __ldg(w + it) != 0.0f && row >= 0 &&
                        row < (int64_t)n_rows;
      keys[it] = keep ? (uint32_t)row : n_rows;
    }
  }
}

// Step 3: a warp a row, its lanes the channels (lane, lane + 32, ...):
// start[r] is row r's first sorted position, order the sorted items.  A
// row's lanes read its positions and items together and write its C
// channels as one run.
__global__ void __launch_bounds__(kThreads)
voxel_sum_kernel(const int32_t* __restrict__ start,
                 const uint32_t* __restrict__ order,
                 const float* __restrict__ w, Tables T, uint32_t n_rows,
                 uint32_t K) {
  const int C = T.first[T.n_tables];
  const int lane = threadIdx.x & 31;
  const uint32_t warps = gridDim.x * (kThreads / 32);
  for (uint32_t r = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
       r < n_rows; r += warps) {
    const int32_t a = __ldg(start + r), b = __ldg(start + r + 1);
    for (int ch = lane; ch < C; ch += 32) {
      int t = 0;
      while (ch >= T.first[t + 1]) ++t;
      const int f = ch - T.first[t], width = T.width[t];
      const float* g = T.g[t];
      float acc = 0.0f;
      for (int32_t j = a; j < b; ++j) {
        const uint32_t it = __ldg(order + j);
        acc = __fadd_rn(acc, __fmul_rn(__ldg(w + it),
                                       __ldg(g + (int64_t)(it / K) * width +
                                             f)));
      }
      T.out[t][(int64_t)r * width + f] = acc;
    }
  }
}

struct Layout {
  int64_t M, key0, kA, pA, kB, pB, start, counts, total;
  jn_bins::RadixPlan R;
};

bool layout(Layout* Lo, int n, int K, int n_rows) {
  if (n < 1 || K < 1 || K > kMaxCorners || n_rows < 1 || n_rows == INT32_MAX)
    return false;
  Lo->M = (int64_t)n * K;
  if (Lo->M >= (1LL << 31)) return false;
  // Keys up to n_rows, the drop key.
  Lo->R = jn_bins::radix_plan((uint32_t)Lo->M, 1,
                              jn_bins::bits_for((uint32_t)n_rows));
  int64_t at = 0;
  Lo->key0 = at, at += up4(Lo->M);
  Lo->kA = at, at += up4(Lo->M);
  Lo->pA = at, at += up4(Lo->M);
  Lo->kB = at, at += up4(Lo->M);
  Lo->pB = at, at += up4(Lo->M);
  Lo->start = at, at += up4(n_rows + 1 + jn_bins::scan_blocks(n_rows));
  Lo->counts = at, at += Lo->R.counts_ints;
  Lo->total = at;
  return at < (1LL << 31);
}

}  // namespace

// Kernel V's int32 work space for n samples of K corners into n_rows
// rows: out[0] its size, out[1] and out[2] where the row starts [n_rows +
// 1] and the sorted items [n * K] lie in it; -1 if kernel V does not take
// the sizes.
extern "C" long long voxel_grad_layout(int n, int K, int n_rows,
                                       long long* out) {
  Layout Lo;
  if (!layout(&Lo, n, K, n_rows)) return -1;
  out[0] = Lo.total;
  out[1] = Lo.start;
  out[2] = (Lo.R.passes & 1) ? Lo.pA : Lo.pB;
  return Lo.total;
}

// Kernel V.  idx [n, K] int64 rows, w [n, K] f32; for each of n_tables
// tables, g [n, width] f32 in and out [n_rows, width] f32, every row
// written once; work as voxel_grad_layout gives it.  plan_only: the keys,
// the sort and the row starts alone (out is not written).
extern "C" int voxel_grad(const void* idx, const void* w,
                          const void* const* g, void* const* out,
                          const int* widths, int n_tables, void* work, int n,
                          int K, int n_rows, int plan_only, void* stream) {
  Layout Lo;
  if (!layout(&Lo, n, K, n_rows) || n_tables < 1 || n_tables > kMaxTables)
    return (int)cudaErrorInvalidValue;
  Tables T;
  T.n_tables = n_tables;
  T.first[0] = 0;
  for (int t = 0; t < n_tables; ++t) {
    if (widths[t] < 1) return (int)cudaErrorInvalidValue;
    T.g[t] = (const float*)g[t];
    T.out[t] = (float*)out[t];
    T.width[t] = widths[t];
    T.first[t + 1] = T.first[t] + widths[t];
  }
  cudaStream_t st = (cudaStream_t)stream;
  int32_t* ws = (int32_t*)work;
  uint32_t* key0 = (uint32_t*)(ws + Lo.key0);
  voxel_keys_kernel<<<grid_for((uint64_t)n), kThreads, 0, st>>>(
      (const int64_t*)idx, (const float*)w, T, key0, n, K, (uint32_t)n_rows);
  const uint32_t* keys;
  const uint32_t* order;
  int err = jn_bins::run_radix(
      Lo.R, (uint32_t)Lo.M, 1, key0, 0xffffffffu, (uint32_t*)(ws + Lo.kA),
      (uint32_t*)(ws + Lo.pA), (uint32_t*)(ws + Lo.kB),
      (uint32_t*)(ws + Lo.pB), ws + Lo.counts, st, &keys, &order);
  if (err) return err;
  jn_bins::KeyGroups G;
  G.base[0] = 0;
  G.size[0] = (uint32_t)n_rows;  // the drop key is left out
  jn_bins::key_starts(keys, (uint32_t)Lo.M, 1, G, n_rows, ws + Lo.start, st);
  if (!plan_only)
    voxel_sum_kernel<<<grid_for((uint64_t)n_rows * 32), kThreads, 0, st>>>(
        ws + Lo.start, order, (const float*)w, T, (uint32_t)n_rows,
        (uint32_t)K);
  return (int)cudaGetLastError();
}
