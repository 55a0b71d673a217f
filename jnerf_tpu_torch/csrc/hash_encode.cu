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
// anywhere: kernel B adds straight into the master gradient
// [n_entries, F] with f32 atomics, so there is no layout to unpack.
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
//   kernel B does: consecutive samples lie along one ray and share cells.
//   Timed on an NVIDIA H100 80GB HBM3 (700 W), bf16 output, against one
//   thread per (sample, level) with consecutive threads on one sample's
//   levels: f2l16@2^18 on 2^20 samples in runs along 4096 rays 0.452 vs
//   1.123 ms, on 2^20 uniform samples 0.966 vs 1.124 ms; f8l4@2^19 within
//   1% either way.
//
// Kernel B is paced by the L2's reduction units, not by bytes: its
// least traffic is pos + g + grad (68.8 MB at the headline, 21 us at
// 3.35 TB/s), but one thread per (sample, level) issuing 8F scalar f32
// atomics made 33.5 M L2 reductions a launch, and on a step's samples,
// which lie in runs along rays, the coarse levels' rows took most of them
// at the same addresses, where same-address reductions serialize.  So:
// - one 16-byte reduction (atomicAdd on float4, global memory on sm_90)
//   per 4 features, float2 at F=2: 2 instead of 8 per corner at F=8;
// - a warp takes 32 consecutive samples at one level, the lanes that hit
//   the same entry are found with __match_any_sync and summed in
//   registers, so one reduction per distinct entry reaches L2.
//   Consecutive samples of a step lie along one ray and share cells.
//   Chosen over a per-block shared-memory accumulator: level 0 of f8l4
//   alone (128 KB) would leave one block per SM and flush 128 KB per
//   block, and shared f32 atomics at one address serialize as L2 ones
//   do.  It runs on every level: timed on an NVIDIA H100 80GB HBM3
//   (700 W) on one headline step's own samples, kernel B took 0.091 ms
//   so, 0.242 ms with only the levels of <= 512 cells an axis aggregated
//   and 0.472 ms with none; on uniform samples the three were within 3%.
//   Compaction's empty slots repeat the last ray's last sample, so even
//   the finest level's entries repeat within a warp;
// - the block reads its samples' g rows (F*L f32, feature-major) once,
//   coalesced, into shared memory.
// The atomics' order still varies, so the last bits of the gradient vary
// from run to run; a deterministic backward is queued work (ROADMAP).
//
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
// - kernel B adds each contribution as the JAX backward forms it
//   (bf16(bf16(w_c) * g) in bf16 mode, w_c * g in f32) and sums in f32
//   where the JAX backward sums in bf16: a deliberate deviation.
// It shares the kernels' structure (warp per 32 samples at one level,
// 16-byte row loads and reductions, peers summed in registers) and is not
// tuned beyond that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// Both kernels run blocks of 8 warps over 32 * chunks consecutive samples;
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

// Adds v into one gradient row of F f32 with 16-byte (F >= 4) or 8-byte
// (F = 2) vector reductions.  Rows are 4F-byte aligned: the gradient is
// a fresh, 256-byte aligned allocation.
template <int F>
__device__ __forceinline__ void red_row(float* row, const float (&v)[F]) {
  if constexpr (F >= 4) {
#pragma unroll
    for (int q = 0; q < F / 4; ++q)
      atomicAdd(reinterpret_cast<float4*>(row) + q,
                make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(row), make_float2(v[0], v[1]));
  } else {
    atomicAdd(row, v[0]);
  }
}

// Sums v over the lanes of `peers` (the lanes that hold the same entry)
// in log2(|peers|) shuffle rounds; returns true on the lowest peer, which
// then holds the sum.  All 32 lanes take part.
template <int F>
__device__ __forceinline__ bool reduce_peers(unsigned peers, float (&v)[F]) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  const bool lowest = rank == 0;
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above)) {
    const int next = __ffs(above);  // 1-based; 0 when none is left
#pragma unroll
    for (int f = 0; f < F; ++f) {
      const float t = __shfl_sync(0xffffffffu, v[f], next > 0 ? next - 1 : lane);
      if (next) v[f] += t;
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
  return lowest;
}

// Kernel B.  g's rows for the block sit in shared memory with a row stride
// of F*L + 1 words (odd: a warp's lanes, one sample each, read distinct
// banks).  MODE: 0 linear, 1 xor in f32, 2 xor in bf16.
template <int F, int MODE>
__global__ void __launch_bounds__(kThreads)
    hash_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ g,
                    float* __restrict__ grad, int n, int chunks, Levels lv) {
  extern __shared__ float sg[];
  const int L = lv.n_levels, FL = F * L, ld = FL + 1;
  const int64_t s0 = (int64_t)blockIdx.x * 32 * chunks;
  const int rows = (int)min((int64_t)32 * chunks, (int64_t)n - s0);
  const float* gb = g + s0 * FL;
  for (int i = threadIdx.x; i < rows * FL; i += kThreads) {
    const int r = i / FL;
    sg[r * ld + (i - r * FL)] = gb[i];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int task = threadIdx.x >> 5; task < chunks * L; task += kWarps) {
    const int chunk = task / L, l = task - chunk * L;
    const int r = chunk * 32 + lane;
    const bool live = r < rows;
    float X[3][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
    float gv[F], fr[3] = {0.0f, 0.0f, 0.0f};
    uint32_t e0 = 0, gc[3] = {0u, 0u, 0u};
    if (live) {
      if constexpr (MODE == 0)
        e0 = cell(lv, l, pos + (s0 + r) * 3, X);
      else
        xor_cell(lv, l, pos + (s0 + r) * 3, gc, fr);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) gv[f] = live ? sg[r * ld + f * L + l] : 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float w;
      uint32_t entry;
      if constexpr (MODE == 0) {
        w = corner_weight(X, c);
        entry = (uint32_t)corner_entry(lv, l, e0, c);
      } else {
        w = MODE == 2 ? to_bf16(xor_weight(fr, c)) : xor_weight(fr, c);
        entry = (uint32_t)xor_entry(lv, l, gc, c);
      }
      float v[F];
#pragma unroll
      for (int f = 0; f < F; ++f)
        v[f] = MODE == 2 ? to_bf16(__fmul_rn(w, gv[f])) : __fmul_rn(w, gv[f]);
      const unsigned peers =
          __match_any_sync(0xffffffffu, live ? entry : 0xffffffffu);
      if (reduce_peers<F>(peers, v) && live)
        red_row<F>(grad + (size_t)entry * F, v);
    }
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

template <int F>
static void launch_bwd(int mode, int blocks, size_t smem, cudaStream_t st,
                       const float* p, const float* g, float* o, int n,
                       int chunks, const Levels& lv) {
  if (mode == 0)
    hash_bwd_kernel<F, 0><<<blocks, kThreads, smem, st>>>(p, g, o, n, chunks, lv);
  else if (mode == 1)
    hash_bwd_kernel<F, 1><<<blocks, kThreads, smem, st>>>(p, g, o, n, chunks, lv);
  else
    hash_bwd_kernel<F, 2><<<blocks, kThreads, smem, st>>>(p, g, o, n, chunks, lv);
}

// Kernel B in mode 0 (linear), 1 (xor, f32) or 2 (xor, bf16 products).
static int run_bwd(int mode, const void* pos, const void* g, void* grad,
                   int n, int F, const Levels& lv, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* gg = (const float*)g;
  float* o = (float*)grad;
  const int L = lv.n_levels, chunks = chunks_for(L);
  const int blocks = (int)(((int64_t)n + 32 * chunks - 1) / (32 * chunks));
  const size_t smem = sizeof(float) * 32 * chunks * (F * L + 1);  // <= 33 KB
  switch (F) {
    case 1: launch_bwd<1>(mode, blocks, smem, st, p, gg, o, n, chunks, lv); break;
    case 2: launch_bwd<2>(mode, blocks, smem, st, p, gg, o, n, chunks, lv); break;
    case 4: launch_bwd<4>(mode, blocks, smem, st, p, gg, o, n, chunks, lv); break;
    case 8: launch_bwd<8>(mode, blocks, smem, st, p, gg, o, n, chunks, lv); break;
    default: return (int)cudaErrorInvalidValue;
  }
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

extern "C" int hash_encode_bwd(const void* pos, const void* g, void* grad,
                               int n, int L, int F, const float* scales,
                               const uint32_t* mults, const uint32_t* sizes,
                               const uint32_t* masks, const uint32_t* offsets,
                               const uint32_t* corner_offs, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, masks, offsets, corner_offs,
                   nullptr))
    return (int)cudaErrorInvalidValue;
  return run_bwd(0, pos, g, grad, n, F, lv, stream);
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
                                   int n, int L, int F, int round_bf16,
                                   const float* scales, const uint32_t* mults,
                                   const uint32_t* sizes,
                                   const uint32_t* offsets,
                                   const uint32_t* hashed, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, nullptr, offsets, nullptr,
                   hashed))
    return (int)cudaErrorInvalidValue;
  return run_bwd(round_bf16 ? 2 : 1, pos, g, grad, n, F, lv, stream);
}
