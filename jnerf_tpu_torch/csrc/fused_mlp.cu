// Fused Instant-NGP MLP for Hopper (sm_90a): forward ("F-MLP"), backward
// ("B-MLP") and density-only forward ("D-MLP").
//
// They replace the three Pallas kernels of jnerf_tpu/ops/fused_mlp.py:
// _fwd_kernel (:113-120, launched by _fwd :190-204), _bwd_kernel
// (:123-159, launched by _fused_bwd :212-235) and _density_kernel
// (:242-245, launched by fused_density_mlp :248-263).  The network is
//
//   x[32] -> relu(x W0[32,64]) -> W1[64,16] = dout (geo features, dout[0] =
//   raw sigma);  [bf16(dout), d[16]] -> relu(. V0[32,64]) -> relu(. V1[64,64])
//   -> V2[64,3] = rgb logits;   output row = [rgb, dout[0]]
//
// all bias-free, at the TPU kernels' quantization points: operands bf16,
// products accumulated in f32, ReLU in f32, each hidden activation rounded
// to bf16 before the next product; dout stays f32 and is rounded to bf16
// only as the rgb input.  The rgb input "concat" is two partial sums,
// bf16(dout) . V0[:16] + d . V0[16:], each accumulated on its own and then
// added.  Products of two bf16 values are exact in f32, so fmaf() rounds
// exactly where a separate multiply and add would; the rounding that
// matters is __float2bfloat16_rn at the re-quantization points.
//
// What bounds them: arithmetic.  A row costs ~19 kFLOP forward and ~57
// kFLOP backward (recomputed forward, cotangents, weight gradients) against
// 112 B (forward) or 240 B (backward) of row traffic, far above the card's
// FLOP/byte balance.  This first version runs on the CUDA cores: one thread
// per row, f32 accumulators in registers, the bf16 feature rows read as
// 16-byte vectors, the bf16-rounded weights (37 KB as f32) in shared
// memory, read as warp-wide broadcasts.  Tensor-core tiles (mma.sync /
// wgmma) are later work.
//
// The backward's weight gradients are sums over all rows.  They are reduced
// without atomics, in a fixed order: each block walks a fixed sequence of
// 128-row tiles, keeps each tile's bf16 per-row vectors in shared memory,
// and adds the tile's outer products into its own partial row of a
// [n_blocks, 9408] buffer; a second kernel sums the partials over blocks
// in block order.  The result is the same from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D_IN = 32;
constexpr int D_HID = 64;
constexpr int D_GEO = 16;
constexpr int SH_DIM = 16;
constexpr int RGB_IN = D_GEO + SH_DIM;
constexpr int kThreads = 128;  // one row per thread; a tile is kThreads rows

// Weights in shared memory, f32 holding bf16-rounded values; V2 is padded
// to [64, 4] with a zero column, as the TPU kernel pads it.
constexpr int OFF_W0 = 0;
constexpr int OFF_W1 = OFF_W0 + D_IN * D_HID;
constexpr int OFF_V0 = OFF_W1 + D_HID * D_GEO;
constexpr int OFF_V1 = OFF_V0 + RGB_IN * D_HID;
constexpr int OFF_V2 = OFF_V1 + D_HID * D_HID;
constexpr int N_WSMEM = OFF_V2 + D_HID * 4;

// Weight gradients, flattened in the order dW0, dW1, dV0, dV1, dV2[64,3].
constexpr int G_W0 = 0;
constexpr int G_W1 = G_W0 + D_IN * D_HID;
constexpr int G_V0 = G_W1 + D_HID * D_GEO;
constexpr int G_V1 = G_V0 + RGB_IN * D_HID;
constexpr int G_V2 = G_V1 + D_HID * D_HID;
constexpr int N_GRAD = G_V2 + D_HID * 3;  // 9408

// Per-row bf16 vectors of a tile, row-major with strides = width + 2 (an
// odd number of 32-bit words), so that the threads of a warp, one row
// each, write to distinct banks.
constexpr int S_X = D_IN + 2;     // x
constexpr int S_IN = RGB_IN + 2;  // [bf16(dout), d]
constexpr int S_H = D_HID + 2;    // hb, r1b, r2b, dr2, dr1, dh
constexpr int S_DD = D_GEO + 2;   // d_dout
constexpr int S_G = 6;            // g4 (3 used)
constexpr int T_X = 0;
constexpr int T_IN = T_X + kThreads * S_X;
constexpr int T_HB = T_IN + kThreads * S_IN;
constexpr int T_R1 = T_HB + kThreads * S_H;
constexpr int T_R2 = T_R1 + kThreads * S_H;
constexpr int T_DR2 = T_R2 + kThreads * S_H;
constexpr int T_DR1 = T_DR2 + kThreads * S_H;
constexpr int T_DH = T_DR1 + kThreads * S_H;
constexpr int T_DD = T_DH + kThreads * S_H;
constexpr int T_G = T_DD + kThreads * S_DD;
constexpr int N_TILE = T_G + kThreads * S_G;

constexpr size_t BWD_SMEM =
    N_WSMEM * sizeof(float) + N_TILE * sizeof(__nv_bfloat16);

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load_weights(
    float* sw, const float* __restrict__ w0, const float* __restrict__ w1,
    const float* __restrict__ v0, const float* __restrict__ v1,
    const float* __restrict__ v2) {
  for (int i = threadIdx.x; i < D_IN * D_HID; i += blockDim.x)
    sw[OFF_W0 + i] = bf(w0[i]);
  for (int i = threadIdx.x; i < D_HID * D_GEO; i += blockDim.x)
    sw[OFF_W1 + i] = bf(w1[i]);
  for (int i = threadIdx.x; i < RGB_IN * D_HID; i += blockDim.x)
    sw[OFF_V0 + i] = bf(v0[i]);
  for (int i = threadIdx.x; i < D_HID * D_HID; i += blockDim.x)
    sw[OFF_V1 + i] = bf(v1[i]);
  for (int i = threadIdx.x; i < D_HID * 4; i += blockDim.x) {
    const int j = i >> 2, c = i & 3;
    sw[OFF_V2 + i] = c < 3 ? bf(v2[j * 3 + c]) : 0.0f;
  }
}

// n bf16 values at p (16-byte aligned, n a multiple of 8) as f32; zeros
// when the row is not live.
template <int N>
__device__ __forceinline__ void load_bf16(const __nv_bfloat16* __restrict__ p,
                                          bool live, float out[N]) {
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int q = 0; q < N / 8; ++q) {
    const uint4 v = live ? p4[q] : make_uint4(0u, 0u, 0u, 0u);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      out[8 * q + 2 * u] = f.x;
      out[8 * q + 2 * u + 1] = f.y;
    }
  }
}

// Row r of x [n, 32] and d [n, 16] (bf16); zeros past n.
__device__ __forceinline__ void load_row(const __nv_bfloat16* __restrict__ x,
                                         const __nv_bfloat16* __restrict__ d,
                                         int64_t r, bool live, float xin[D_IN],
                                         float din[SH_DIM]) {
  load_bf16<D_IN>(x + r * D_IN, live, xin);
  if (din != nullptr) load_bf16<SH_DIM>(d + r * SH_DIM, live, din);
}

// a0 = x . W0 (f32), summed over k in order.
__device__ __forceinline__ void layer0(const float* sw, const float xin[D_IN],
                                       float a0[D_HID]) {
#pragma unroll
  for (int j = 0; j < D_HID; ++j) a0[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < D_IN; ++k) {
#pragma unroll
    for (int j = 0; j < D_HID; ++j)
      a0[j] = fmaf(xin[k], sw[OFF_W0 + k * D_HID + j], a0[j]);
  }
}

// dout = hb . W1 (f32).
__device__ __forceinline__ void layer1(const float* sw, const float hb[D_HID],
                                       float dout[D_GEO]) {
#pragma unroll
  for (int i = 0; i < D_GEO; ++i) dout[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < D_HID; ++k) {
#pragma unroll
    for (int i = 0; i < D_GEO; ++i)
      dout[i] = fmaf(hb[k], sw[OFF_W1 + k * D_GEO + i], dout[i]);
  }
}

// a1 = db . V0[:16] + d . V0[16:], each partial summed on its own.
__device__ __forceinline__ void layer2(const float* sw, const float db[D_GEO],
                                       const float din[SH_DIM],
                                       float a1[D_HID]) {
#pragma unroll
  for (int j = 0; j < D_HID; ++j) a1[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < D_GEO; ++i) {
#pragma unroll
    for (int j = 0; j < D_HID; ++j)
      a1[j] = fmaf(db[i], sw[OFF_V0 + i * D_HID + j], a1[j]);
  }
#pragma unroll
  for (int j = 0; j < D_HID; ++j) {
    float q = 0.0f;
#pragma unroll
    for (int i = 0; i < SH_DIM; ++i)
      q = fmaf(din[i], sw[OFF_V0 + (D_GEO + i) * D_HID + j], q);
    a1[j] = a1[j] + q;
  }
}

// a2 = r1b . V1.
__device__ __forceinline__ void layer3(const float* sw, const float r1b[D_HID],
                                       float a2[D_HID]) {
#pragma unroll
  for (int j = 0; j < D_HID; ++j) a2[j] = 0.0f;
#pragma unroll
  for (int k = 0; k < D_HID; ++k) {
#pragma unroll
    for (int j = 0; j < D_HID; ++j)
      a2[j] = fmaf(r1b[k], sw[OFF_V1 + k * D_HID + j], a2[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
    mlp_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ d,
                   const float* __restrict__ w0, const float* __restrict__ w1,
                   const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2, float* __restrict__ out,
                   int n) {
  __shared__ float sw[N_WSMEM];
  load_weights(sw, w0, w1, v0, v1, v2);
  __syncthreads();
  // One row per thread and no row loop: in a loop the compiler hoists the
  // loop-invariant weight reads out of shared memory into (spilled)
  // registers.
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  {
    float xin[D_IN], din[SH_DIM], a[D_HID], h[D_HID], dout[D_GEO];
    load_row(x, d, r, true, xin, din);
    layer0(sw, xin, a);
#pragma unroll
    for (int j = 0; j < D_HID; ++j) a[j] = bf(fmaxf(a[j], 0.0f));
    layer1(sw, a, dout);
    float db[D_GEO];
#pragma unroll
    for (int i = 0; i < D_GEO; ++i) db[i] = bf(dout[i]);
    layer2(sw, db, din, a);
#pragma unroll
    for (int j = 0; j < D_HID; ++j) a[j] = bf(fmaxf(a[j], 0.0f));
    layer3(sw, a, h);
    float rgb[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < D_HID; ++j) {
      const float r2b = bf(fmaxf(h[j], 0.0f));
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rgb[c] = fmaf(r2b, sw[OFF_V2 + j * 4 + c], rgb[c]);
    }
    reinterpret_cast<float4*>(out)[r] =
        make_float4(rgb[0], rgb[1], rgb[2], dout[0]);
  }
}

__global__ void __launch_bounds__(kThreads)
    density_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w0,
                       const float* __restrict__ w1, float* __restrict__ out,
                       int n) {
  __shared__ float sw0[D_IN * D_HID];
  __shared__ float sw1[D_HID];  // W1[:, 0]
  for (int i = threadIdx.x; i < D_IN * D_HID; i += blockDim.x)
    sw0[i] = bf(w0[i]);
  for (int i = threadIdx.x; i < D_HID; i += blockDim.x)
    sw1[i] = bf(w1[i * D_GEO]);
  __syncthreads();
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  {
    float xin[D_IN], a0[D_HID];
    load_row(x, nullptr, r, true, xin, nullptr);
#pragma unroll
    for (int j = 0; j < D_HID; ++j) a0[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < D_IN; ++k) {
#pragma unroll
      for (int j = 0; j < D_HID; ++j)
        a0[j] = fmaf(xin[k], sw0[k * D_HID + j], a0[j]);
    }
    float s = 0.0f;
#pragma unroll
    for (int k = 0; k < D_HID; ++k) s = fmaf(bf(fmaxf(a0[k], 0.0f)), sw1[k], s);
    out[r] = s;
  }
}

__device__ __forceinline__ void put(__nv_bfloat16* t, int i, float v) {
  t[i] = __float2bfloat16_rn(v);  // v is bf16-exact: the cast is exact
}

__device__ __forceinline__ float get(const __nv_bfloat16* t, int i) {
  return __bfloat162float(t[i]);
}

// The tile's contribution to one weight-gradient entry: sum over the
// tile's rows r, in order, of A[r][a] * B[r][b].
__device__ __forceinline__ float tile_outer(const __nv_bfloat16* A, int sa,
                                            int a, const __nv_bfloat16* B,
                                            int sb, int b, float acc) {
#pragma unroll 8
  for (int r = 0; r < kThreads; ++r)
    acc = fmaf(get(A, r * sa + a), get(B, r * sb + b), acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    mlp_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ d,
                   const float* __restrict__ w0, const float* __restrict__ w1,
                   const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2, const float* __restrict__ g,
                   float* __restrict__ dx, float* __restrict__ partial,
                   int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sw = reinterpret_cast<float*>(smem);
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(sw + N_WSMEM);
  load_weights(sw, w0, w1, v0, v1, v2);
  float* part = partial + (int64_t)blockIdx.x * N_GRAD;
  const int t = threadIdx.x;
  const int64_t n_tiles = ((int64_t)n + kThreads - 1) / kThreads;

  for (int64_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    __syncthreads();  // weights loaded / the last tile's sums are done
    const int64_t r = ti * kThreads + t;
    const bool live = r < n;
    // ---- forward, recomputed; the bf16 row vectors go to the tile.
    float xin[D_IN], din[SH_DIM], a[D_HID], h[D_HID], dout[D_GEO];
    load_row(x, d, r, live, xin, din);
#pragma unroll
    for (int k = 0; k < D_IN; ++k) put(tile + T_X, t * S_X + k, xin[k]);
    layer0(sw, xin, a);
    uint64_t m0 = 0, m1 = 0, m2 = 0;
#pragma unroll
    for (int j = 0; j < D_HID; ++j) {
      if (a[j] > 0.0f) m0 |= 1ull << j;
      a[j] = bf(fmaxf(a[j], 0.0f));
      put(tile + T_HB, t * S_H + j, a[j]);
    }
    layer1(sw, a, dout);
    float db[D_GEO];
#pragma unroll
    for (int i = 0; i < D_GEO; ++i) {
      db[i] = bf(dout[i]);
      put(tile + T_IN, t * S_IN + i, db[i]);
      put(tile + T_IN, t * S_IN + D_GEO + i, din[i]);
    }
    layer2(sw, db, din, a);
#pragma unroll
    for (int j = 0; j < D_HID; ++j) {
      if (a[j] > 0.0f) m1 |= 1ull << j;
      a[j] = bf(fmaxf(a[j], 0.0f));
      put(tile + T_R1, t * S_H + j, a[j]);
    }
    layer3(sw, a, h);
#pragma unroll
    for (int j = 0; j < D_HID; ++j) {
      if (h[j] > 0.0f) m2 |= 1ull << j;
      put(tile + T_R2, t * S_H + j, bf(fmaxf(h[j], 0.0f)));
    }
    // ---- backward.  g4 = bf16(g[:3]); lane 3 is out of the V2 path.
    const float4 gv = live ? reinterpret_cast<const float4*>(g)[r]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float g4[3] = {bf(gv.x), bf(gv.y), bf(gv.z)};
#pragma unroll
    for (int c = 0; c < 3; ++c) put(tile + T_G, t * S_G + c, g4[c]);
    // dr2 = bf16((g4 . V2p^T) * (a2 > 0))  -> a
#pragma unroll
    for (int j = 0; j < D_HID; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) s = fmaf(g4[c], sw[OFF_V2 + j * 4 + c], s);
      a[j] = bf(((m2 >> j) & 1) ? s : 0.0f);
      put(tile + T_DR2, t * S_H + j, a[j]);
    }
    // dr1 = bf16((dr2 . V1^T) * (a1 > 0))  -> h
#pragma unroll
    for (int k = 0; k < D_HID; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < D_HID; ++j)
        s = fmaf(a[j], sw[OFF_V1 + k * D_HID + j], s);
      h[k] = bf(((m1 >> k) & 1) ? s : 0.0f);
      put(tile + T_DR1, t * S_H + k, h[k]);
    }
    // d_dout = bf16(dr1 . V0[:16]^T + g[3] on lane 0)  -> dout
#pragma unroll
    for (int i = 0; i < D_GEO; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int k = 0; k < D_HID; ++k)
        s = fmaf(h[k], sw[OFF_V0 + i * D_HID + k], s);
      dout[i] = bf(i == 0 ? s + gv.w : s);
      put(tile + T_DD, t * S_DD + i, dout[i]);
    }
    // dh = bf16((d_dout . W1^T) * (a0 > 0))  -> a
#pragma unroll
    for (int k = 0; k < D_HID; ++k) {
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < D_GEO; ++i)
        s = fmaf(dout[i], sw[OFF_W1 + k * D_GEO + i], s);
      a[k] = bf(((m0 >> k) & 1) ? s : 0.0f);
      put(tile + T_DH, t * S_H + k, a[k]);
    }
    // dx = dh . W0^T (f32)
    if (live) {
      float4* o = reinterpret_cast<float4*>(dx + r * D_IN);
#pragma unroll
      for (int q = 0; q < D_IN / 4; ++q) {
        float s[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[u] = 0.0f;
#pragma unroll
          for (int k = 0; k < D_HID; ++k)
            s[u] = fmaf(a[k], sw[OFF_W0 + (4 * q + u) * D_HID + k], s[u]);
        }
        o[q] = make_float4(s[0], s[1], s[2], s[3]);
      }
    }
    __syncthreads();
    // ---- the tile's weight gradients into this block's partial row.
    // Every segment is a multiple of 32 entries long, so a warp never
    // straddles two of them.
    const bool first = ti == blockIdx.x;
    for (int e = t; e < N_GRAD; e += kThreads) {
      float acc = first ? 0.0f : part[e];
      if (e < G_W1) {  // dW0 = x^T dh
        const int l = e - G_W0;
        acc = tile_outer(tile + T_X, S_X, l / D_HID, tile + T_DH, S_H,
                         l % D_HID, acc);
      } else if (e < G_V0) {  // dW1 = hb^T d_dout
        const int l = e - G_W1;
        acc = tile_outer(tile + T_HB, S_H, l / D_GEO, tile + T_DD, S_DD,
                         l % D_GEO, acc);
      } else if (e < G_V1) {  // dV0 = [db, d]^T dr1
        const int l = e - G_V0;
        acc = tile_outer(tile + T_IN, S_IN, l / D_HID, tile + T_DR1, S_H,
                         l % D_HID, acc);
      } else if (e < G_V2) {  // dV1 = r1b^T dr2
        const int l = e - G_V1;
        acc = tile_outer(tile + T_R1, S_H, l / D_HID, tile + T_DR2, S_H,
                         l % D_HID, acc);
      } else {  // dV2 = r2b^T g4
        const int l = e - G_V2;
        acc = tile_outer(tile + T_R2, S_H, l / 3, tile + T_G, S_G, l % 3, acc);
      }
      part[e] = acc;
    }
  }
}

// dw[e] = sum over blocks b, in order, of partial[b][e].
__global__ void sum_partials_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dw, int n_blocks) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= N_GRAD) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(int64_t)b * N_GRAD + e];
  dw[e] = s;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return sms;
}

int row_tiles(int n) { return (int)(((int64_t)n + kThreads - 1) / kThreads); }

}  // namespace

// All pointers are device pointers of contiguous tensors, 16-byte aligned:
// x [n, 32] and d [n, 16] bf16; the weights f32 in their own [in, out]
// shapes (v2 [64, 3]), rounded to bf16 on load; g, out, dx and dw f32.

// out [n, 4] = [rgb logits, raw sigma].
extern "C" int fused_mlp_fwd(const void* x, const void* d, const void* w0,
                             const void* w1, const void* v0, const void* v1,
                             const void* v2, void* out, int n, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  mlp_fwd_kernel<<<row_tiles(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)d, (const float*)w0,
      (const float*)w1, (const float*)v0, (const float*)v1, (const float*)v2,
      (float*)out, n);
  return (int)cudaGetLastError();
}

// The number of blocks fused_mlp_bwd runs for n rows, and so the rows of
// the partial buffer the caller allocates: one block per SM at most.
extern "C" int fused_mlp_bwd_blocks(int n) {
  if (n <= 0) return 0;
  const int tiles = row_tiles(n), sms = sm_count();
  return tiles < sms ? tiles : (sms > 0 ? sms : 1);
}

// dx [n, 32] and dw [9408] = dW0, dW1, dV0, dV1, dV2 flattened, from the
// upstream gradient g [n, 4]; partial is scratch of
// fused_mlp_bwd_blocks(n) * 9408 floats.
extern "C" int fused_mlp_bwd(const void* x, const void* d, const void* w0,
                             const void* w1, const void* v0, const void* v1,
                             const void* v2, const void* g, void* dx,
                             void* partial, void* dw, int n, int n_blocks,
                             void* stream) {
  if (n <= 0 || n_blocks != fused_mlp_bwd_blocks(n))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)BWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  mlp_bwd_kernel<<<n_blocks, kThreads, BWD_SMEM, st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)d, (const float*)w0,
      (const float*)w1, (const float*)v0, (const float*)v1, (const float*)v2,
      (const float*)g, (float*)dx, (float*)partial, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<(N_GRAD + 255) / 256, 256, 0, st>>>(
      (const float*)partial, (float*)dw, n_blocks);
  return (int)cudaGetLastError();
}

// out [n] = relu(bf16(x) . W0) -> bf16 . W1[:, 0]  (raw sigma).
extern "C" int fused_density_mlp_fwd(const void* x, const void* w0,
                                     const void* w1, void* out, int n,
                                     void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  density_fwd_kernel<<<row_tiles(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)w0, (const float*)w1,
      (float*)out, n);
  return (int)cudaGetLastError();
}
