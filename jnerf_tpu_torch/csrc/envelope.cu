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
//   (lane = slot*16 + corner*2 + feature) are X*Y*Z*G, computed in
//   registers, added into row (l*n_acc + n % n_acc)*n_rows + rows[l, n]:
//   four float4 atomics.  Modes: 0 (v2d / alt2 by n_acc), 1 (novals: ones
//   into all 128 lanes), 2 (noscat: the TPU variant's own output, each
//   level's row 0 gets the first sample of each blk-sample block, and every
//   contribution is stored to a scratch buffer, as the TPU kernel stores
//   its vals slab to VMEM scratch, so that the contribution pass runs).
//
// What bounds them: bytes, at random addresses.  K1 and K2 read each
// index and write each output once; the rows they read are random, and a
// DRAM or L2 sector is 32 bytes, so a 16-byte row read costs a whole
// sector.  So the design keeps each access as wide as the row allows:
// K1 moves 16 bytes a thread (int4), neighbouring threads on one row's
// neighbouring chunks, so a row of 32 bytes or more is read by one
// coalesced group.  K3 and K4 are paced by the L2's reduction units: one
// float4 atomic per 16 bytes, no aggregation of equal rows (that is kernel
// B's design; here the raw atomic rate is the thing measured).  The
// arithmetic is a few operations a byte at most.
//
// Indices are int32.  An index outside its table is the caller's fault:
// gathers write 0 for it and scatters drop it, so no launch reads or
// writes outside its buffers.  All sizes a launch walks are below 2^31.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// K4: one (level, sample) a thread, level-major (t = l * n + s), so a
// warp's samples are consecutive at one level.  pos [n, 3], g [n, 2L]
// feature-major (column f*L + l), rows / slots [L, n]; out [L * n_acc *
// n_rows, 128]; scratch [L * n, 16] (mode 2 only).
__global__ void __launch_bounds__(kThreads)
packed_hash_scatter_kernel(const float* __restrict__ pos,
                           const float* __restrict__ g,
                           const int32_t* __restrict__ rows,
                           const int32_t* __restrict__ slots, Scales sc,
                           float* __restrict__ out, float4* __restrict__ scratch,
                           uint32_t n, uint32_t L, uint32_t n_rows,
                           uint32_t n_acc, int mode, uint32_t blk) {
  const uint32_t total = n * L;
  for (uint32_t t = blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride()) {
    const uint32_t l = t / n, s = t - l * n;
    const int32_t r = __ldg(rows + t), slot = __ldg(slots + t);
    const bool row_ok = r >= 0 && (uint32_t)r < n_rows;
    const bool slot_ok = slot >= 0 && slot < 8;
    const size_t row = ((size_t)(l * n_acc + s % n_acc) * n_rows + r) * 128;
    if (mode == 1) {  // novals: ones into every lane of the row
      if (!row_ok) continue;
      float4* o = reinterpret_cast<float4*>(out + row);
      for (int k = 0; k < 32; ++k)
        atomicAdd(o + k, make_float4(1.f, 1.f, 1.f, 1.f));
      continue;
    }
    const float scale = sc.s[l];
    float X[3][2];
    for (int d = 0; d < 3; ++d) {
      const float f = fract_of(__ldg(pos + (size_t)s * 3 + d), scale);
      const float x0 = __fsub_rn(1.f, f);
      X[d][0] = x0;
      X[d][1] = __fadd_rn(x0, __fsub_rn(__fmul_rn(2.f, f), 1.f));
    }
    const float g0 = __ldg(g + (size_t)s * 2 * L + l);
    const float g1 = __ldg(g + (size_t)s * 2 * L + L + l);
    const float G[2] = {g0, __fadd_rn(g0, __fsub_rn(g1, g0))};
    float v[16];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float xyz = __fmul_rn(__fmul_rn(X[0][c & 1], X[1][(c >> 1) & 1]),
                                  X[2][(c >> 2) & 1]);
      v[2 * c] = __fmul_rn(xyz, G[0]);
      v[2 * c + 1] = __fmul_rn(xyz, G[1]);
    }
    if (mode == 2) {  // noscat
      float4* sp = scratch + (size_t)t * 4;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        sp[k] = make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
      if (!slot_ok || s % blk != 0) continue;
      float4* o = reinterpret_cast<float4*>(out + (size_t)l * n_rows * 128 +
                                            slot * 16);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        atomicAdd(o + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                     v[4 * k + 3]));
      continue;
    }
    if (!row_ok || !slot_ok) continue;
    float4* o = reinterpret_cast<float4*>(out + row + slot * 16);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      atomicAdd(o + k, make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2],
                                   v[4 * k + 3]));
  }
}

bool fits(int64_t a, int64_t b) { return a >= 0 && b >= 0 && a * b < (1LL << 31); }

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

// K4.  scales: L host floats, passed by value; out zeroed by the wrapper;
// scratch [L * n, 16] f32 for mode 2, else unused.
extern "C" int env_packed_hash_scatter(const void* pos, const void* g,
                                       const void* rows, const void* slots,
                                       const float* scales, void* out,
                                       void* scratch, int n, int L,
                                       int n_rows, int n_acc, int mode,
                                       int blk, void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > kMaxLevels || n_rows < 1 || n_acc < 1 || n_acc > 2 ||
      mode < 0 || mode > 2 || blk < 1 || !fits(n, L) ||
      !fits((int64_t)L * n_acc * n_rows, 128) || (mode == 2 && !fits(n, 16 * L)))
    return (int)cudaErrorInvalidValue;
  Scales sc;
  for (int l = 0; l < L; ++l) sc.s[l] = scales[l];
  const uint32_t total = (uint32_t)n * L;
  packed_hash_scatter_kernel<<<blocks_for(total), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const float*)pos, (const float*)g, (const int32_t*)rows,
      (const int32_t*)slots, sc, (float*)out, (float4*)scratch, n, L, n_rows,
      n_acc, mode, blk);
  return (int)cudaGetLastError();
}
