// Hash-grid encode for Hopper (sm_90a): the forward gather ("kernel F")
// and the table-gradient scatter ("kernel B") of the per-level linear hash
// and of the reference's xor hash ("xor mode", at the end of this comment).
//
// Kernel F replaces the XLA gather + blend of
// jnerf_tpu/ops/hash_nbr.py::_encode_from_nbr (:261-304), the counterpart
// of the reference's kernel_grid.  Kernel B replaces the three Pallas
// backward kernels of jnerf_tpu/ops/hash_nbr.py, which all compute one
// function and differ only in how they fit a level's accumulator into
// TPU VMEM: _make_bwd_matmul_kernel (:381-427), _make_bwd_kernel
// (:430-509) and _make_bwd_kernel_sharded (:512-569), finished by
// unpack_slabs (:829-892).  On the card no accumulator has to fit
// anywhere: kernel B writes the master gradient [n_entries, F] row by
// row, so there is no layout to unpack.
//
// What bounds them: both are random-access bound.  Per (sample, level)
// kernel F reads 8 table rows of 4F bytes at hashed addresses and kernel B
// adds 8 rows of 4F bytes into the gradient; the arithmetic is a few
// dozen flops.  At the headline shapes (2^17 samples, f8l4, 2^19-entry
// levels) the table (50 MB f32) about fits the 50 MB L2, so the rows
// mostly hit L2.
//
// Kernel F's least traffic is pos (12 B a sample), its output (2F*L B a
// sample in bf16) and each table row it reads once: at a render chunk
// (2^20 samples, f8l4) 12 + 64 MB and 28 MB of rows, 31 us at 3.35 TB/s.  What sets its time is the gather: 8L row reads a sample (32 M of
// 32 B at a render chunk), from L2, or from L1 where a warp's samples
// share cells.  So:
// - a thread issues its 8 corners' row loads, 16 bytes each (float4;
//   float2 at F=2), before it blends them;
// - a power-of-two level takes a corner's entry with & (size - 1), not %;
// - it writes the encoder's compute dtype itself: bf16, each f32 sum
//   rounded once (the cast that followed the f32 output read 128 MB and
//   wrote 64 MB at a render chunk), or f32; a block stages its output
//   rows in shared memory and writes them as 16-byte stores;
// - a warp takes 32 consecutive samples at one level (level-major), as
//   kernel B did before PR 16: consecutive samples lie along one ray and
//   share cells.
//   Timed on an NVIDIA H100 80GB HBM3 (700 W), bf16 output, against one
//   thread per (sample, level) with consecutive threads on one sample's
//   levels: f2l16@2^18 on 2^20 samples in runs along 4096 rays 0.452 vs
//   1.123 ms, on 2^20 uniform samples 0.966 vs 1.124 ms; f8l4@2^19 within
//   1% either way.
//
// Kernel B sums each gradient row's contributions in one fixed order,
// that of its plain twin, so every launch gives the same bits (the JAX
// package's training is bitwise reproducible from a seed, and with float
// atomics the port's was not).  Its least traffic is pos + g + grad (68.8
// MB at the headline, 21 us at 3.35 TB/s).  It runs in five steps, with
// a work space from the wrapper (hash_encode_bwd_layout), and no float
// atomics:
// 1. prep (hash_prep_kernel): per (level, sample) the keys, the 8 corner
//    weights and g's F values of the level (gT); linear keys a sample by
//    its base entry e0, xor each (sample, corner) by its entry; a sample
//    whose g is all zero at the level is left out;
// 2. sort: each level's items stably by key, a radix sort on K4's bin
//    pass (bins.cuh: run_radix; digits of up to 10 bits, two passes at
//    the headline), then each row's first position (key_starts);
// 3. gather (hash_gather_kernel): each sorted item's record, so that the
//    sums read runs of the sorted order contiguously;
// 4. pieces (hash_piece_kernel) and 5. sum (hash_sum_kernel): each row
//    from +0.0 in pieces (see "Kernel B's order" below), written once,
//    with no zeroing pass.  Linear: a corner's contributions to entry e
//    come from the samples whose base entry is (e - corner_off) mod size
//    (corner c's entry is (e0 + corner_off) mod size, a shift of e0), so
//    one sort of the samples serves all 8 corners.  Xor has no such shift
//    on its hashed levels, so it sorts the 8n (sample, corner) items.  Two
//    corners of one cell on one entry (a level smaller than 8 cells) keep
//    the twin's order in both modes.
// The atomic kernel it replaces (PR 4: 16-byte reductions of warp-summed
// peers) took 0.0863 ms at the headline (PERF.md §6).
// Numerics follow the JAX package exactly:
// - the cell index is floor(fmul_rn(p, scale) + 0.5) with no FMA
//   contraction (a fused multiply-add moves samples at cell borders into
//   the neighbouring cell); all index and weight math uses the _rn
//   intrinsics;
// - the hash wraps mod 2^32 in uint32, as the JAX package's uint32 does;
// - corner c's entry is (e0 + corner_off[l][c]) % size, which is NOT the
//   hash of the corner's own coordinates when size is not a power of two;
// - kernel F rounds each table value to bf16 (the JAX forward casts the
//   master table first) and each weighted product to bf16 before the f32
//   sum over corners; output is feature-major, column f*L + l;
// - kernel B takes the upstream gradient in f32, as the Pallas kernels do.
//
// Xor mode (template parameter XOR / MODE) follows the JAX package's
// reference-exact path, jnerf_tpu/ops/hash_grid.py:152-213, which XLA
// computes as a gather and its autodiff scatter (no Pallas kernel):
// - corner c of level l sits at pg_d = u32(floor(fmul_rn(x_d, scale) +
//   0.5)) + c_d, the conversion saturating as XLA's (and PTX's) does; its
//   entry is off_l + h % size_l with h = pg0 + pg1 res + pg2 res^2 on a
//   dense level and h = JNERF_HASH(pg0, pg1, pg2) on a hashed one, all in
//   uint32; its weight is (wd0 * wd1) * wd2, wd = frac or 1 - frac;
// - JNERF_HASH is the config's hash_func, checked and rewritten as C by
//   jnerf_tpu_torch/ops/hash_grid.py::_compile_hash_func and defined before
//   this file is included (ops/cuda_lib.py builds one library per string),
//   as the reference injects its hash string into its CUDA source;
// - the forward in bf16: sum_c bf16(bf16(t) * bf16(w_c)) in f32, rounded
//   to bf16 once; in f32 nothing is rounded, the table neither;
// - kernel B forms each contribution as the JAX backward forms it
//   (bf16(bf16(w_c) * g) in bf16 mode, w_c * g in f32) and sums in f32
//   where the JAX backward sums in bf16: a deliberate deviation.
// Kernel F in xor mode shares the linear kernel's structure (warp per 32
// samples at one level, 16-byte row loads) and is not tuned beyond that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bins.cuh"

#define MAX_LEVELS 32

// The xor mode's hash; ops/cuda_lib.py defines it from the config.
#ifndef JNERF_HASH
#define JNERF_HASH(p0, p1, p2) ((p0 ^ (p1 * 19349663u)) ^ (p2 * 83492791u))
#endif

// uint32 shifts as XLA computes them: by 32 or more they give 0.
__device__ __forceinline__ uint32_t jn_shl(uint32_t a, uint32_t b) {
  return b < 32u ? a << b : 0u;
}
__device__ __forceinline__ uint32_t jn_shr(uint32_t a, uint32_t b) {
  return b < 32u ? a >> b : 0u;
}

__device__ __forceinline__ uint32_t xor_hash(uint32_t p0, uint32_t p1,
                                             uint32_t p2) {
  return (uint32_t)(JNERF_HASH(p0, p1, p2));
}

struct Levels {
  int n_levels;
  float scale[MAX_LEVELS];
  uint32_t mult[MAX_LEVELS][3];
  uint32_t size[MAX_LEVELS];
  uint32_t mask[MAX_LEVELS];   // of the cell's hash; 0 => a real modulo by size
  uint32_t cmask[MAX_LEVELS];  // of a corner's entry: size - 1 at a power-of-two
                               // size, else 0 => a real modulo
  uint32_t offset[MAX_LEVELS];
  uint32_t corner_off[MAX_LEVELS][8];
  uint32_t hashed[MAX_LEVELS];  // xor mode: 1 => JNERF_HASH, 0 => dense
};

// Base entry e0 (level-local) and the per-axis corner factors
// X[b] = (1 - f) + b * (2f - 1) for b in {0, 1}.
__device__ __forceinline__ uint32_t cell(const Levels& lv, int l,
                                         const float* __restrict__ p,
                                         float X[3][2]) {
  const float s = lv.scale[l];
  uint32_t g[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float q = __fadd_rn(__fmul_rn(p[d], s), 0.5f);
    const float gq = floorf(q);
    const float fr = __fsub_rn(q, gq);
    g[d] = (uint32_t)(int32_t)gq;
    X[d][0] = __fsub_rn(1.0f, fr);
    X[d][1] = __fadd_rn(X[d][0], __fsub_rn(__fmul_rn(2.0f, fr), 1.0f));
  }
  const uint32_t raw =
      g[0] * lv.mult[l][0] + g[1] * lv.mult[l][1] + g[2] * lv.mult[l][2];
  const uint32_t m = lv.mask[l];
  return m ? (raw & m) : (raw % lv.size[l]);
}

__device__ __forceinline__ float corner_weight(const float X[3][2], int c) {
  return __fmul_rn(__fmul_rn(X[0][c & 1], X[1][(c >> 1) & 1]),
                   X[2][(c >> 2) & 1]);
}

__device__ __forceinline__ int64_t corner_entry(const Levels& lv, int l,
                                                uint32_t e0, int c) {
  const uint32_t v = e0 + lv.corner_off[l][c], m = lv.cmask[l];
  return (int64_t)lv.offset[l] + (int64_t)(m ? (v & m) : (v % lv.size[l]));
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Xor mode: corner 0's coordinates g and the fractions of the cell.
__device__ __forceinline__ void xor_cell(const Levels& lv, int l,
                                         const float* __restrict__ p,
                                         uint32_t g[3], float fr[3]) {
  const float s = lv.scale[l];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float q = __fadd_rn(__fmul_rn(p[d], s), 0.5f);
    const float gq = floorf(q);
    fr[d] = __fsub_rn(q, gq);
    g[d] = __float2uint_rz(gq);  // saturates: < 0 -> 0, as XLA's convert
  }
}

__device__ __forceinline__ float xor_weight(const float fr[3], int c) {
  float wd[3];
#pragma unroll
  for (int d = 0; d < 3; ++d)
    wd[d] = ((c >> d) & 1) ? fr[d] : __fsub_rn(1.0f, fr[d]);
  return __fmul_rn(__fmul_rn(wd[0], wd[1]), wd[2]);
}

__device__ __forceinline__ int64_t xor_entry(const Levels& lv, int l,
                                             const uint32_t g[3], int c) {
  const uint32_t p0 = g[0] + (c & 1), p1 = g[1] + ((c >> 1) & 1),
                 p2 = g[2] + ((c >> 2) & 1);
  const uint32_t h = lv.hashed[l] ? xor_hash(p0, p1, p2)
                                  : p0 * lv.mult[l][0] + p1 * lv.mult[l][1] +
                                        p2 * lv.mult[l][2];
  const uint32_t m = lv.cmask[l];
  return (int64_t)lv.offset[l] + (int64_t)(m ? (h & m) : (h % lv.size[l]));
}

// Kernel F runs blocks of 8 warps over 32 * chunks consecutive samples;
// warp task t covers the 32 samples of chunk t / L at level t % L.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Enough 32-sample chunks that every warp of a block has a level.
static int chunks_for(int L) { return L >= kWarps ? 1 : kWarps / L; }

// One table row of F f32 in 16-byte (F >= 4) or 8-byte (F = 2) loads.
// Rows are 4F-byte aligned: the table is a 16-byte aligned allocation.
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ row,
                                         float (&v)[F]) {
  if constexpr (F >= 4) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row) + q);
      v[4 * q] = t.x;
      v[4 * q + 1] = t.y;
      v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (F == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(row));
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = __ldg(row);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&h);
}

// V = 8 (bf16) or 4 (f32) values to out[e..e+V), one 16-byte store.
template <bool BF16, int V>
__device__ __forceinline__ void store16(void* out, int64_t e,
                                        const float (&v)[V]) {
  if constexpr (BF16) {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + e) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(out) + e) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Kernel F.  A thread takes one (sample, level): it issues the 8 corners'
// row loads before the blend and writes its F sums to the block's output
// rows in shared memory (row stride F*L + 1 words, odd: a warp's lanes, one
// sample each, write distinct banks).  The block then writes its rows, one
// contiguous span of the feature-major output, as 16-byte stores of bf16
// (each f32 sum rounded once) or f32.
template <int F, bool BF16, bool XOR>
__global__ void __launch_bounds__(kThreads)
    hash_fwd_kernel(const float* __restrict__ pos,
                    const float* __restrict__ table, void* __restrict__ out,
                    int32_t* __restrict__ e0_out, int n, int chunks,
                    Levels lv) {
  extern __shared__ float so[];
  const int L = lv.n_levels, FL = F * L, ld = FL + 1;
  const int64_t s0 = (int64_t)blockIdx.x * 32 * chunks;
  const int rows = (int)min((int64_t)32 * chunks, (int64_t)n - s0);
  const int lane = threadIdx.x & 31;
  for (int task = threadIdx.x >> 5; task < chunks * L; task += kWarps) {
    const int chunk = task / L, l = task - chunk * L;
    const int r = chunk * 32 + lane;
    if (r >= rows) continue;
    float v[8][F], w[8];
    if constexpr (XOR) {
      uint32_t g[3];
      float fr[3];
      xor_cell(lv, l, pos + (s0 + r) * 3, g, fr);
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        load_row<F>(table + xor_entry(lv, l, g, c) * F, v[c]);
        w[c] = BF16 ? to_bf16(xor_weight(fr, c)) : xor_weight(fr, c);
      }
    } else {
      float X[3][2];
      const uint32_t e0 = cell(lv, l, pos + (s0 + r) * 3, X);
      if (e0_out) e0_out[(s0 + r) * L + l] = (int32_t)e0;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        load_row<F>(table + corner_entry(lv, l, e0, c) * F, v[c]);
        w[c] = corner_weight(X, c);
      }
    }
    float acc[F];
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int f = 0; f < F; ++f) {
        if constexpr (XOR && !BF16)
          acc[f] = __fadd_rn(acc[f], __fmul_rn(v[c][f], w[c]));
        else
          acc[f] = __fadd_rn(acc[f],
                             to_bf16(__fmul_rn(to_bf16(v[c][f]), w[c])));
      }
    }
#pragma unroll
    for (int f = 0; f < F; ++f) so[r * ld + f * L + l] = acc[f];
  }
  __syncthreads();
  // The block's rows * FL values start at element s0 * FL, a multiple of
  // 32 * FL: every V-th element is 16-byte aligned.
  constexpr int V = BF16 ? 8 : 4;
  const int total = rows * FL;
  for (int e = threadIdx.x * V; e < total; e += kThreads * V) {
    int r = e / FL, c = e - r * FL;
    float v[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      v[k] = e + k < total ? so[r * ld + c] : 0.0f;
      if (++c == FL) c = 0, ++r;
    }
    if (e + V <= total) {
      store16<BF16, V>(out, s0 * FL + e, v);
    } else {
      for (int k = 0; e + k < total; ++k) {
        if constexpr (BF16)
          static_cast<__nv_bfloat16*>(out)[s0 * FL + e + k] =
              __float2bfloat16_rn(v[k]);
        else
          static_cast<float*>(out)[s0 * FL + e + k] = v[k];
      }
    }
  }
}

// Kernel B, step 1: each sample's keys, weights and upstream gradient,
// level by level, in the layouts the sort and the gather read.  Linear
// (MODE 0): key [L, n] the level-local base entry e0, W [L, n, 8] the
// corner weights.  Xor (MODE 1, 2): key and W [L, n, 8], corner c's
// level-local entry and weight (bf16-rounded in MODE 2).  gT [L, n, F]:
// g's F values of the level, contiguous.  A (sample, level) whose F
// values of g are all zero (the compaction's empty slots) adds exact
// zeros, so it is left out: its keys are the level's size, sorted after
// every entry.
template <int F, int MODE>
__global__ void __launch_bounds__(kThreads)
    hash_prep_kernel(const float* __restrict__ pos, const float* __restrict__ g,
                     uint32_t* __restrict__ key, float* __restrict__ W,
                     float* __restrict__ gT, int n, Levels lv) {
  const int L = lv.n_levels, FL = F * L;
  for (int64_t s = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; s < n;
       s += (int64_t)gridDim.x * blockDim.x) {
    const float* p = pos + s * 3;
    for (int l = 0; l < L; ++l) {
      const int64_t ls = (int64_t)l * n + s;
      float gv[F], w[8];
      bool live = false;
#pragma unroll
      for (int f = 0; f < F; ++f) {
        gv[f] = __ldg(g + s * FL + f * L + l);
        live |= gv[f] != 0.0f;
      }
      if constexpr (F >= 4) {
#pragma unroll
        for (int q = 0; q < F / 4; ++q)
          reinterpret_cast<float4*>(gT + ls * F)[q] =
              make_float4(gv[4 * q], gv[4 * q + 1], gv[4 * q + 2],
                          gv[4 * q + 3]);
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) gT[ls * F + f] = gv[f];
      }
      if constexpr (MODE == 0) {
        float X[3][2];
        const uint32_t e0 = cell(lv, l, p, X);
        key[ls] = live ? e0 : lv.size[l];
#pragma unroll
        for (int c = 0; c < 8; ++c) w[c] = corner_weight(X, c);
      } else {
        uint32_t gc[3];
        float fr[3];
        xor_cell(lv, l, p, gc, fr);
        uint32_t k[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          k[c] = live ? (uint32_t)(xor_entry(lv, l, gc, c) - lv.offset[l])
                      : lv.size[l];
          w[c] = MODE == 2 ? to_bf16(xor_weight(fr, c)) : xor_weight(fr, c);
        }
        uint4* kq = reinterpret_cast<uint4*>(key + ls * 8);
        kq[0] = make_uint4(k[0], k[1], k[2], k[3]);
        kq[1] = make_uint4(k[4], k[5], k[6], k[7]);
      }
      float4* wq = reinterpret_cast<float4*>(W + ls * 8);
      wq[0] = make_float4(w[0], w[1], w[2], w[3]);
      wq[1] = make_float4(w[4], w[5], w[6], w[7]);
    }
  }
}

// Kernel B's order.  Each level's items are sorted stably by key (step
// 2), and a row's contributions come as runs of that sorted order:
// linear, for corners 0..7 in turn, the run of the samples whose base
// entry is (e - corner_off[l][c]) mod size (corner c's entry is (e0 +
// corner_off) mod size, a shift of e0, so one sort of the samples serves
// all 8 corners); xor, the one run of its (sample, corner) items.  Each
// run is cut where the level's sorted positions cross a multiple of
// kPiece (into "chunks"); each piece is summed from +0.0 in sorted order,
// and the row is the sum from +0.0 of its pieces, corner by corner, in
// sorted order: the order of grad_table_plain and grad_table_xor_plain.
// Step 4 sums each chunk's first and last piece in parallel (on the
// coarse levels every chunk's, elsewhere only chunks of one key), so a
// row's longest chain of dependent adds is about kPiece plus its count
// of pieces, whatever its number of contributions.
constexpr int kPiece = 32;

// A sorted item's record (step 3): linear, the sample's 8 corner weights
// and its F values of g (padded to 16 bytes); xor, the item's F
// contributions.
template <int F, int MODE>
struct Rec {
  static constexpr int kFloats = MODE == 0 ? (8 + F + 3) / 4 * 4 : F;
};

// N floats from p, as 16- or 8-byte loads where N allows (p is aligned
// to 4N bytes, up to 16).
template <int N>
__device__ __forceinline__ void load_vals(const float* __restrict__ p,
                                          float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = t.x, v[4 * q + 1] = t.y, v[4 * q + 2] = t.z,
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (N == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = __ldg(p + q);
  }
}

template <int N>
__device__ __forceinline__ void store_vals(float* p, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int q = 0; q < N; ++q) p[q] = v[q];
  }
}

// Kernel B, step 3: each kept item's record in sorted order, rec [L, M,
// Rec::kFloats], so that steps 4 and 5 read runs contiguously (the items'
// weights and g are read here, once each).
template <int F, int MODE>
__global__ void __launch_bounds__(kThreads)
    hash_gather_kernel(const uint32_t* __restrict__ keys,
                       const uint32_t* __restrict__ order,
                       const float* __restrict__ W,
                       const float* __restrict__ gT, float* __restrict__ rec,
                       int n, uint32_t M, Levels lv) {
  constexpr int R = Rec<F, MODE>::kFloats;
  const uint64_t total = (uint64_t)M * lv.n_levels;
  for (uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (uint64_t)gridDim.x * blockDim.x) {
    const int l = (int)(t / M);
    if (__ldg(keys + t) >= lv.size[l]) continue;  // left out
    const uint32_t it = __ldg(order + t);
    const int64_t s = (int64_t)l * n + (MODE == 0 ? it : it >> 3);
    float gv[F], r[R];
    load_vals<F>(gT + s * F, gv);
    if constexpr (MODE == 0) {
      float w[8];
      load_vals<8>(W + s * 8, w);
#pragma unroll
      for (int q = 0; q < R; ++q) r[q] = q < 8 ? w[q] : q < 8 + F ? gv[q - 8] : 0.0f;
    } else {
      const float w = __ldg(W + (int64_t)l * n * 8 + it);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float v = __fmul_rn(w, gv[f]);
        r[f] = MODE == 2 ? to_bf16(v) : v;
      }
    }
    store_vals<R>(rec + t * R, r);
  }
}

// One contribution, from the record at sorted position t: features f0..
// of corner c (linear: weight times g; xor: the stored contribution),
// added to acc.
template <int F, int MODE, int FT>
__device__ __forceinline__ void add_rec(float (&acc)[FT],
                                        const float* __restrict__ rec,
                                        int64_t t, int c, int f0) {
  constexpr int R = Rec<F, MODE>::kFloats;
  const float* r = rec + t * R;
  float v[FT];
  if constexpr (MODE == 0) {
    const float w = __ldg(r + c);
    load_vals<FT>(r + 8 + f0, v);
#pragma unroll
    for (int k = 0; k < FT; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(w, v[k]));
  } else {
    load_vals<FT>(r + f0, v);
#pragma unroll
    for (int k = 0; k < FT; ++k) acc[k] = __fadd_rn(acc[k], v[k]);
  }
}

// The sum from +0.0 of sorted positions [j, end) of level l (lM its first
// position).
template <int F, int MODE, int FT>
__device__ __forceinline__ void add_run(float (&piece)[FT],
                                        const float* __restrict__ rec,
                                        int64_t lM, int32_t j, int32_t end,
                                        int c, int f0) {
#pragma unroll
  for (int q = 0; q < FT; ++q) piece[q] = 0.0f;
#pragma unroll 4
  for (; j < end; ++j) add_rec<F, MODE, FT>(piece, rec, lM + j, c, f0);
}

// Kernel B, step 4: per (level, chunk, corner in MODE 0) the sums of the
// chunk's first and last piece, ends [L, n_chunks, 8 or 1, 2, F] (a chunk
// of one key: both its sum).  On levels from `wide` on only chunks of
// kPiece positions of one kept key are summed.
template <int F, int MODE>
__global__ void __launch_bounds__(kThreads)
    hash_piece_kernel(const uint32_t* __restrict__ keys,
                      const float* __restrict__ rec, float* __restrict__ ends,
                      uint32_t M, uint32_t n_chunks, int wide, Levels lv) {
  constexpr int NC = MODE == 0 ? 8 : 1;
  const int L = lv.n_levels;
  const uint64_t total = (uint64_t)L * n_chunks * NC;
  for (uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (uint64_t)gridDim.x * blockDim.x) {
    const int c = (int)(t % NC);
    const uint64_t r = t / NC;
    const uint32_t k = (uint32_t)(r % n_chunks);
    const int l = (int)(r / n_chunks);
    const uint32_t p0 = k * kPiece, p1 = min(p0 + kPiece, M);
    const int64_t lM = (int64_t)l * M;
    const uint32_t* kl = keys + lM;
    const uint32_t first = __ldg(kl + p0), size = lv.size[l];
    if (first >= size) continue;  // left-out items only
    const bool one = first == __ldg(kl + p1 - 1);
    if (l >= wide && !(one && p1 - p0 == kPiece)) continue;
    float head[F], run[F];
#pragma unroll
    for (int q = 0; q < F; ++q) run[q] = head[q] = 0.0f;
    bool in_first = true;
    uint32_t prev = first;
    for (uint32_t j = p0; j < p1; ++j) {
      const uint32_t key = __ldg(kl + j);
      if (key >= size) break;
      if (key != prev) {
        if (in_first) {
#pragma unroll
          for (int q = 0; q < F; ++q) head[q] = run[q];
          in_first = false;
        }
#pragma unroll
        for (int q = 0; q < F; ++q) run[q] = 0.0f;
        prev = key;
      }
      add_rec<F, MODE, F>(run, rec, lM + j, c, 0);
    }
    if (in_first) {
#pragma unroll
      for (int q = 0; q < F; ++q) head[q] = run[q];
    }
    float* o = ends + (r * NC + c) * 2 * F;
#pragma unroll
    for (int q = 0; q < F; ++q) o[q] = head[q], o[F + q] = run[q];
  }
}

// Kernel B, step 5: each gradient row, in the order above, from +0.0,
// written once.  Thread t takes entry e_begin + t / LANES and its F /
// LANES features from (t % LANES) * F / LANES: LANES = F on the coarse
// levels (before `wide`), whose rows take hundreds of contributions, 1 on
// the others.  start[off_l + l + key] is the first sorted position (l * M
// + local) of level l's key (its kept keys and, last, the left-out key
// size_l).
template <int F, int MODE, int LANES>
__global__ void __launch_bounds__(kThreads)
    hash_sum_kernel(const int32_t* __restrict__ start,
                    const float* __restrict__ rec,
                    const float* __restrict__ ends, float* __restrict__ grad,
                    uint32_t e_begin, uint32_t e_end, uint32_t M,
                    uint32_t n_chunks, int wide, Levels lv) {
  constexpr int FT = F / LANES, NC = MODE == 0 ? 8 : 1;
  const uint64_t total = (uint64_t)(e_end - e_begin) * LANES;
  for (uint64_t t = (uint64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (uint64_t)gridDim.x * blockDim.x) {
    const uint32_t e = e_begin + (uint32_t)(t / LANES);
    const int f0 = (int)(t % LANES) * FT;
    int l = 0;
    while (l + 1 < lv.n_levels && lv.offset[l + 1] <= e) ++l;
    const uint32_t size = lv.size[l], local = e - lv.offset[l];
    const int32_t* sl = start + lv.offset[l] + l;
    const int64_t lM = (int64_t)l * M;
    const bool coarse = l < wide;
    int32_t a[NC], b[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      uint32_t key = local;
      if (MODE == 0) {
        const uint32_t co = lv.corner_off[l][c];  // < size
        key = local >= co ? local - co : local + size - co;
      }
      a[c] = __ldg(sl + key) - (int32_t)lM;
      b[c] = __ldg(sl + key + 1) - (int32_t)lM;
    }
    float acc[FT];
#pragma unroll
    for (int q = 0; q < FT; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      for (int32_t j = a[c]; j < b[c];) {
        const int32_t p0 = j / kPiece * kPiece;
        const int32_t p1 = min(p0 + kPiece, (int32_t)M);
        const int32_t end = min(b[c], p1);
        const bool first = j == p0, last = end == p1;
        const float* ep =
            ends + (((int64_t)l * n_chunks + p0 / kPiece) * NC + c) * 2 * F +
            f0;
        float piece[FT];
        if (first && last && p1 - p0 == kPiece) {
          // Whole chunks: their sums, U loads started at a time.
          constexpr int U = FT >= 8 ? 2 : FT >= 4 ? 4 : 8;
          const int32_t k1 = (b[c] - p0) / kPiece;  // whole chunks from p0
          int32_t k = 0;
          for (; k + U <= k1; k += U) {
            float v[U][FT];
#pragma unroll
            for (int u = 0; u < U; ++u)
              load_vals<FT>(ep + (int64_t)(k + u) * NC * 2 * F, v[u]);
#pragma unroll
            for (int u = 0; u < U; ++u)
#pragma unroll
              for (int q = 0; q < FT; ++q) acc[q] = __fadd_rn(acc[q], v[u][q]);
          }
          for (; k < k1; ++k) {
            float v[FT];
            load_vals<FT>(ep + (int64_t)k * NC * 2 * F, v);
#pragma unroll
            for (int q = 0; q < FT; ++q) acc[q] = __fadd_rn(acc[q], v[q]);
          }
          j = p0 + k1 * kPiece;
          continue;
        }
        if (coarse && (first || last)) {
          load_vals<FT>(ep + (first ? 0 : F), piece);
        } else {
          add_run<F, MODE, FT>(piece, rec, lM, j, end, c, f0);
        }
#pragma unroll
        for (int q = 0; q < FT; ++q) acc[q] = __fadd_rn(acc[q], piece[q]);
        j = end;
      }
    }
    store_vals<FT>(grad + (int64_t)e * F + f0, acc);
  }
}

static bool fill_levels(Levels* lv, int L, const float* scales,
                        const uint32_t* mults, const uint32_t* sizes,
                        const uint32_t* masks, const uint32_t* offsets,
                        const uint32_t* corner_offs, const uint32_t* hashed) {
  if (L < 1 || L > MAX_LEVELS) return false;
  lv->n_levels = L;
  for (int l = 0; l < L; ++l) {
    lv->scale[l] = scales[l];
    for (int d = 0; d < 3; ++d) lv->mult[l][d] = mults[l * 3 + d];
    lv->size[l] = sizes[l];
    lv->mask[l] = masks ? masks[l] : 0u;
    lv->cmask[l] = (sizes[l] & (sizes[l] - 1)) == 0 ? sizes[l] - 1 : 0;
    lv->offset[l] = offsets[l];
    for (int c = 0; c < 8; ++c)
      lv->corner_off[l][c] = corner_offs ? corner_offs[l * 8 + c] : 0u;
    lv->hashed[l] = hashed ? hashed[l] : 0u;
  }
  return true;
}

template <int F, bool XOR>
static void launch_fwd(bool bf16, int blocks, size_t smem, cudaStream_t st,
                       const float* p, const float* t, void* o, int32_t* e,
                       int n, int chunks, const Levels& lv) {
  if (bf16)
    hash_fwd_kernel<F, true, XOR><<<blocks, kThreads, smem, st>>>(
        p, t, o, e, n, chunks, lv);
  else
    hash_fwd_kernel<F, false, XOR><<<blocks, kThreads, smem, st>>>(
        p, t, o, e, n, chunks, lv);
}

// Kernel F in either mode; out is [n, F*L], bf16 when bf16, else f32.
static int run_fwd(bool xor_mode, bool bf16, const void* pos,
                   const void* table, void* out, void* e0_out, int n, int F,
                   const Levels& lv, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* t = (const float*)table;
  int32_t* e = (int32_t*)e0_out;
  const int L = lv.n_levels, chunks = chunks_for(L);
  const int blocks = (int)(((int64_t)n + 32 * chunks - 1) / (32 * chunks));
  const size_t smem = sizeof(float) * 32 * chunks * (F * L + 1);  // <= 33 KB
#define JN_FWD(FF)                                                         \
  (xor_mode ? launch_fwd<FF, true>(bf16, blocks, smem, st, p, t, out, e, n, \
                                   chunks, lv)                             \
            : launch_fwd<FF, false>(bf16, blocks, smem, st, p, t, out, e, n, \
                                    chunks, lv))
  switch (F) {
    case 1: JN_FWD(1); break;
    case 2: JN_FWD(2); break;
    case 4: JN_FWD(4); break;
    case 8: JN_FWD(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef JN_FWD
  return (int)cudaGetLastError();
}

// Kernel B's int32 work space, region by region (16-byte aligned): key0
// [L, M], W [L, n, 8], gT [L, n, F], the sort's two (key, payload) buffers
// [L, M] each, the row starts [n_entries + L + 1 + scan sums], the sorted
// records [L, M, Rec::kFloats], the chunks' first and last pieces' sums [L,
// n_chunks, 8 or 1, 2, F] and the sort's counts; M = n (linear) or 8n
// (xor).
struct BwdLayout {
  int64_t key0, W, gT, kA, pA, kB, pB, start, rec, ends, counts, total,
      order, keys;
  int64_t n_starts, M, n_chunks;
  uint32_t max_size;
  jn_bins::RadixPlan R;
};

static int64_t up4(int64_t v) { return (v + 3) / 4 * 4; }

static bool bwd_layout(BwdLayout* B, int n, int L, int F, bool xor_mode,
                       const uint32_t* sizes) {
  if (n < 1 || L < 1 || L > MAX_LEVELS) return false;
  int64_t n_entries = 0;
  B->max_size = 1;
  for (int l = 0; l < L; ++l) {
    if (sizes[l] < 1) return false;
    n_entries += sizes[l];
    if (sizes[l] > B->max_size) B->max_size = sizes[l];
  }
  B->n_starts = n_entries + L;  // each level's keys and its left-out key
  B->M = (int64_t)n * (xor_mode ? 8 : 1);
  const int64_t LM = L * B->M, R = xor_mode ? F : (8 + F + 3) / 4 * 4;
  if (LM * R >= (1LL << 31) || B->n_starts >= (1LL << 31) ||
      (int64_t)L * n * 8 >= (1LL << 31))
    return false;
  // Keys up to the largest size (a left-out item's key).
  B->R = jn_bins::radix_plan((uint32_t)B->M, (uint32_t)L,
                             jn_bins::bits_for(B->max_size));
  B->n_chunks = (B->M + kPiece - 1) / kPiece;
  int64_t at = 0;
  B->key0 = at, at += up4(LM);
  B->W = at, at += up4((int64_t)L * n * 8);
  B->gT = at, at += up4((int64_t)L * n * F);
  B->kA = at, at += up4(LM);
  B->pA = at, at += up4(LM);
  B->kB = at, at += up4(LM);
  B->pB = at, at += up4(LM);
  B->start = at,
  at += up4(B->n_starts + 1 + jn_bins::scan_blocks(B->n_starts));
  B->rec = at, at += up4(LM * R);
  B->ends = at, at += up4(L * B->n_chunks * (xor_mode ? 1 : 8) * 2 * F);
  B->counts = at, at += B->R.counts_ints;
  B->total = at;
  B->order = (B->R.passes & 1) ? B->pA : B->pB;
  B->keys = (B->R.passes & 1) ? B->kA : B->kB;
  return at < (1LL << 31);
}

// Levels [0, k) are the coarse ones, whose rows take 16 or more
// contributions each on average: there every chunk's first and last
// pieces are summed in step 4, and step 5 runs a lane a feature.
static int wide_levels(const Levels& lv, int n) {
  int k = 0;
  while (k < lv.n_levels && 8 * (int64_t)n >= 16 * (int64_t)lv.size[k]) ++k;
  return k;
}

static int grid_for(uint64_t threads) {
  uint64_t b = (threads + kThreads - 1) / kThreads;
  if (b > (1u << 20)) b = 1u << 20;
  return (int)(b < 1 ? 1 : b);
}

// Kernel B's buffers in the work space, and its sizes.
struct BwdArgs {
  const float* pos;
  const float* g;
  uint32_t* key0;
  float* W;
  float* gT;
  const int32_t* start;
  const uint32_t* keys;   // sorted
  const uint32_t* order;  // sorted
  float* rec;
  float* ends;
  float* grad;
  int n;
  uint32_t M, n_chunks;
};

template <int F, int MODE>
static void launch_sum(const BwdArgs& A, const Levels& lv, cudaStream_t st) {
  const int L = lv.n_levels, NC = MODE == 0 ? 8 : 1;
  const int k = wide_levels(lv, A.n);
  hash_gather_kernel<F, MODE>
      <<<grid_for((uint64_t)L * A.M), kThreads, 0, st>>>(
          A.keys, A.order, A.W, A.gT, A.rec, A.n, A.M, lv);
  hash_piece_kernel<F, MODE>
      <<<grid_for((uint64_t)L * A.n_chunks * NC), kThreads, 0, st>>>(
          A.keys, A.rec, A.ends, A.M, A.n_chunks, k, lv);
  const uint32_t end = lv.offset[L - 1] + lv.size[L - 1];
  const uint32_t split = k < L ? lv.offset[k] : end;
  if (split > 0)
    hash_sum_kernel<F, MODE, F>
        <<<grid_for((uint64_t)split * F), kThreads, 0, st>>>(
            A.start, A.rec, A.ends, A.grad, 0, split, A.M, A.n_chunks, k, lv);
  if (end > split)
    hash_sum_kernel<F, MODE, 1><<<grid_for(end - split), kThreads, 0, st>>>(
        A.start, A.rec, A.ends, A.grad, split, end, A.M, A.n_chunks, k, lv);
}

// step 0: the prep; step 1: the gather, the pieces and the sum.
template <int F>
static void launch_bwd_step(int mode, int step, const BwdArgs& A,
                            const Levels& lv, cudaStream_t st) {
  if (step == 0) {
    const int blocks = grid_for((uint64_t)A.n);
    if (mode == 0)
      hash_prep_kernel<F, 0><<<blocks, kThreads, 0, st>>>(A.pos, A.g, A.key0,
                                                          A.W, A.gT, A.n, lv);
    else if (mode == 1)
      hash_prep_kernel<F, 1><<<blocks, kThreads, 0, st>>>(A.pos, A.g, A.key0,
                                                          A.W, A.gT, A.n, lv);
    else
      hash_prep_kernel<F, 2><<<blocks, kThreads, 0, st>>>(A.pos, A.g, A.key0,
                                                          A.W, A.gT, A.n, lv);
  } else if (mode == 0) {
    launch_sum<F, 0>(A, lv, st);
  } else if (mode == 1) {
    launch_sum<F, 1>(A, lv, st);
  } else {
    launch_sum<F, 2>(A, lv, st);
  }
}

// Kernel B in mode 0 (linear), 1 (xor, f32) or 2 (xor, bf16 products):
// the prep, the sort of each level's items by entry (run_radix), the row
// starts (key_starts), the records, the chunks' end pieces, then each row
// of grad [n_entries, F], written once.  plan_only: the prep, the sort and
// the starts.
static int run_bwd(int mode, const void* pos, const void* g, void* grad,
                   void* work, int n, int F, const Levels& lv, bool plan_only,
                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int L = lv.n_levels;
  BwdLayout B;
  if (!bwd_layout(&B, n, L, F, mode != 0, lv.size))
    return (int)cudaErrorInvalidValue;
  int32_t* w = (int32_t*)work;
  BwdArgs A{(const float*)pos,
            (const float*)g,
            (uint32_t*)(w + B.key0),
            (float*)(w + B.W),
            (float*)(w + B.gT),
            w + B.start,
            nullptr,
            nullptr,
            (float*)(w + B.rec),
            (float*)(w + B.ends),
            (float*)grad,
            n,
            (uint32_t)B.M,
            (uint32_t)B.n_chunks};
#define JN_BWD_STEP(STEP)                                      \
  switch (F) {                                                 \
    case 1: launch_bwd_step<1>(mode, STEP, A, lv, st); break;  \
    case 2: launch_bwd_step<2>(mode, STEP, A, lv, st); break;  \
    case 4: launch_bwd_step<4>(mode, STEP, A, lv, st); break;  \
    case 8: launch_bwd_step<8>(mode, STEP, A, lv, st); break;  \
    default: return (int)cudaErrorInvalidValue;                \
  }
  JN_BWD_STEP(0);
  const int err = jn_bins::run_radix(
      B.R, (uint32_t)B.M, (uint32_t)L, A.key0, 0xffffffffu,
      (uint32_t*)(w + B.kA), (uint32_t*)(w + B.pA), (uint32_t*)(w + B.kB),
      (uint32_t*)(w + B.pB), w + B.counts, st, &A.keys, &A.order);
  if (err) return err;
  jn_bins::KeyGroups G;
  for (int l = 0; l < L; ++l) {
    G.base[l] = lv.offset[l] + l;
    G.size[l] = lv.size[l] + 1;  // the left-out key too
  }
  jn_bins::key_starts(A.keys, (uint32_t)B.M, (uint32_t)L, G, B.n_starts,
                      w + B.start, st);
  if (!plan_only) JN_BWD_STEP(1);
#undef JN_BWD_STEP
  return (int)cudaGetLastError();
}

// The level constants arrive as host arrays and travel to the kernel by
// value in `Levels`; pointers to device memory are the tensors' data_ptr().
// out is [n, F*L], bf16 when out_bf16 is nonzero, else f32.
extern "C" int hash_encode_fwd(const void* pos, const void* table, void* out,
                               void* e0_out, int n, int L, int F, int out_bf16,
                               const float* scales, const uint32_t* mults,
                               const uint32_t* sizes, const uint32_t* masks,
                               const uint32_t* offsets,
                               const uint32_t* corner_offs, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, masks, offsets, corner_offs,
                   nullptr))
    return (int)cudaErrorInvalidValue;
  return run_fwd(false, out_bf16 != 0, pos, table, out, e0_out, n, F, lv,
                 stream);
}

// Kernel B's int32 work space for n samples, L levels of these sizes and
// F features, linear or xor: out[0] its size, out[1] and out[2] where the
// row starts [n_entries + L + 1] (level l's keys at offset_l + l, its
// left-out key after them) and the sorted items [L, M] lie in it (an item
// is a sample, or in xor sample * 8 + corner); -1 if kernel B does not
// take the sizes.
extern "C" long long hash_encode_bwd_layout(int n, int L, int F, int xor_mode,
                                            const uint32_t* sizes,
                                            long long* out) {
  BwdLayout B;
  if (!bwd_layout(&B, n, L, F, xor_mode != 0, sizes)) return -1;
  out[0] = B.total;
  out[1] = B.start;
  out[2] = B.order;
  return B.total;
}

// work: hash_encode_bwd_layout's int32s.  plan_only: the sort and the row
// starts alone (grad is not written).
extern "C" int hash_encode_bwd(const void* pos, const void* g, void* grad,
                               void* work, int n, int L, int F,
                               const float* scales, const uint32_t* mults,
                               const uint32_t* sizes, const uint32_t* masks,
                               const uint32_t* offsets,
                               const uint32_t* corner_offs, int plan_only,
                               void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, masks, offsets, corner_offs,
                   nullptr))
    return (int)cudaErrorInvalidValue;
  return run_bwd(0, pos, g, grad, work, n, F, lv, plan_only != 0, stream);
}

// Xor mode.  mults[l] = (1, res, res^2 mod 2^32) on a dense level (unused on
// a hashed one), hashed[l] = 1 on a hashed level.  out_bf16 / round_bf16:
// the encoder's compute dtype is bf16.
extern "C" int hash_encode_xor_fwd(const void* pos, const void* table,
                                   void* out, int n, int L, int F,
                                   int out_bf16, const float* scales,
                                   const uint32_t* mults,
                                   const uint32_t* sizes,
                                   const uint32_t* offsets,
                                   const uint32_t* hashed, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, nullptr, offsets, nullptr,
                   hashed))
    return (int)cudaErrorInvalidValue;
  return run_fwd(true, out_bf16 != 0, pos, table, out, nullptr, n, F, lv,
                 stream);
}

extern "C" int hash_encode_xor_bwd(const void* pos, const void* g, void* grad,
                                   void* work, int n, int L, int F,
                                   int round_bf16, const float* scales,
                                   const uint32_t* mults,
                                   const uint32_t* sizes,
                                   const uint32_t* offsets,
                                   const uint32_t* hashed, int plan_only,
                                   void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, nullptr, offsets, nullptr,
                   hashed))
    return (int)cudaErrorInvalidValue;
  return run_bwd(round_bf16 ? 2 : 1, pos, g, grad, work, n, F, lv,
                 plan_only != 0, stream);
}
