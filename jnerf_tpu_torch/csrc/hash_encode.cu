// Hash-grid encode for Hopper (sm_90a): the forward gather ("kernel F")
// and the table-gradient scatter ("kernel B") of the per-level linear hash.
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
// issues 8F f32 atomics to them; the arithmetic is a few dozen flops.
// At the headline shapes (2^17 samples, f8l4, 2^19-entry levels) the
// table (50 MB f32) about fits the 50 MB L2, so the rows mostly hit L2.
// This first version keeps one thread per (sample, level) and plain
// scalar loads and atomics; wider loads, float4 atomics and a
// deterministic sort + segmented-sum backward are later work.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32

struct Levels {
  int n_levels;
  float scale[MAX_LEVELS];
  uint32_t mult[MAX_LEVELS][3];
  uint32_t size[MAX_LEVELS];
  uint32_t mask[MAX_LEVELS];  // 0 => a real modulo by size
  uint32_t offset[MAX_LEVELS];
  uint32_t corner_off[MAX_LEVELS][8];
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
  return (int64_t)lv.offset[l] +
         (int64_t)((e0 + lv.corner_off[l][c]) % lv.size[l]);
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One thread per (sample, level); consecutive threads walk the levels of
// one sample, so the feature-major output row of a sample is written by
// neighbouring threads.
template <int F>
__global__ void hash_fwd_kernel(const float* __restrict__ pos,
                                const float* __restrict__ table,
                                float* __restrict__ out,
                                int32_t* __restrict__ e0_out, int n,
                                Levels lv) {
  const int L = lv.n_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n * L) return;
  const int64_t s = i / L;
  const int l = (int)(i - s * L);
  float X[3][2];
  const uint32_t e0 = cell(lv, l, pos + s * 3, X);
  if (e0_out) e0_out[i] = (int32_t)e0;
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(X, c);
    const float* row = table + corner_entry(lv, l, e0, c) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) {
      acc[f] = __fadd_rn(acc[f], to_bf16(__fmul_rn(to_bf16(row[f]), w)));
    }
  }
  float* o = out + s * (int64_t)(F * L) + l;
#pragma unroll
  for (int f = 0; f < F; ++f) o[f * L] = acc[f];
}

template <int F>
__global__ void hash_bwd_kernel(const float* __restrict__ pos,
                                const float* __restrict__ g,
                                float* __restrict__ grad, int n, Levels lv) {
  const int L = lv.n_levels;
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n * L) return;
  const int64_t s = i / L;
  const int l = (int)(i - s * L);
  float X[3][2];
  const uint32_t e0 = cell(lv, l, pos + s * 3, X);
  float gv[F];
  const float* gs = g + s * (int64_t)(F * L) + l;
#pragma unroll
  for (int f = 0; f < F; ++f) gv[f] = gs[f * L];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float w = corner_weight(X, c);
    float* row = grad + corner_entry(lv, l, e0, c) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) atomicAdd(row + f, __fmul_rn(w, gv[f]));
  }
}

static bool fill_levels(Levels* lv, int L, const float* scales,
                        const uint32_t* mults, const uint32_t* sizes,
                        const uint32_t* masks, const uint32_t* offsets,
                        const uint32_t* corner_offs) {
  if (L < 1 || L > MAX_LEVELS) return false;
  lv->n_levels = L;
  for (int l = 0; l < L; ++l) {
    lv->scale[l] = scales[l];
    for (int d = 0; d < 3; ++d) lv->mult[l][d] = mults[l * 3 + d];
    lv->size[l] = sizes[l];
    lv->mask[l] = masks[l];
    lv->offset[l] = offsets[l];
    for (int c = 0; c < 8; ++c) lv->corner_off[l][c] = corner_offs[l * 8 + c];
  }
  return true;
}

static const int kThreads = 256;

static int grid_for(int n, int L) {
  return (int)(((int64_t)n * L + kThreads - 1) / kThreads);
}

// The level constants arrive as host arrays and travel to the kernel by
// value in `Levels`; pointers to device memory are the tensors' data_ptr().
extern "C" int hash_encode_fwd(const void* pos, const void* table, void* out,
                               void* e0_out, int n, int L, int F,
                               const float* scales, const uint32_t* mults,
                               const uint32_t* sizes, const uint32_t* masks,
                               const uint32_t* offsets,
                               const uint32_t* corner_offs, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, masks, offsets, corner_offs))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* t = (const float*)table;
  float* o = (float*)out;
  int32_t* e = (int32_t*)e0_out;
  const int blocks = grid_for(n, L);
  switch (F) {
    case 1: hash_fwd_kernel<1><<<blocks, kThreads, 0, st>>>(p, t, o, e, n, lv); break;
    case 2: hash_fwd_kernel<2><<<blocks, kThreads, 0, st>>>(p, t, o, e, n, lv); break;
    case 4: hash_fwd_kernel<4><<<blocks, kThreads, 0, st>>>(p, t, o, e, n, lv); break;
    case 8: hash_fwd_kernel<8><<<blocks, kThreads, 0, st>>>(p, t, o, e, n, lv); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int hash_encode_bwd(const void* pos, const void* g, void* grad,
                               int n, int L, int F, const float* scales,
                               const uint32_t* mults, const uint32_t* sizes,
                               const uint32_t* masks, const uint32_t* offsets,
                               const uint32_t* corner_offs, void* stream) {
  Levels lv;
  if (!fill_levels(&lv, L, scales, mults, sizes, masks, offsets, corner_offs))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* p = (const float*)pos;
  const float* gg = (const float*)g;
  float* o = (float*)grad;
  const int blocks = grid_for(n, L);
  switch (F) {
    case 1: hash_bwd_kernel<1><<<blocks, kThreads, 0, st>>>(p, gg, o, n, lv); break;
    case 2: hash_bwd_kernel<2><<<blocks, kThreads, 0, st>>>(p, gg, o, n, lv); break;
    case 4: hash_bwd_kernel<4><<<blocks, kThreads, 0, st>>>(p, gg, o, n, lv); break;
    case 8: hash_bwd_kernel<8><<<blocks, kThreads, 0, st>>>(p, gg, o, n, lv); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
