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
// What bounds them: arithmetic.  A row costs 18.8 kFLOP forward and 54.4
// kFLOP backward (recomputed forward, cotangents, weight gradients) against
// 112 B (forward) or 240 B (backward) of row traffic, far above the card's
// FLOP/byte balance.  F-MLP and D-MLP run on the CUDA cores: one thread
// per row, f32 accumulators in registers, the bf16 feature rows read as
// 16-byte vectors, the bf16-rounded weights (37 KB as f32) in shared
// memory, read as warp-wide broadcasts.
//
// B-MLP runs on the tensor cores (mma.sync m16n8k16, bf16 operands, f32
// accumulators; at the headline's 2^17 rows its 7.1 GFLOP would take the
// card's bf16 peak 7 us, its 31 MB of rows 9 us).  Every operand is
// bf16-exact already (weights rounded on load, activations and
// cotangents re-quantized), so only the f32 sums differ from the CUDA-core
// chain: the tensor core adds each k16 group in its own order.  Where that
// could change a bf16 rounding or a ReLU mask, the sum is taken again in
// the twin's order (fixup below), so B-MLP rounds as its twin does.  Each warp
// takes 16 rows; the forward is recomputed layer by layer, each layer's
// accumulators, masked and rounded, become the next product's operand
// fragments in registers, and the cotangent products read the same bf16
// weights through ldmatrix without .trans (W^T).  The rgb input stays two
// partial products of one k16 step each, added after.
//
// The backward's weight gradients are sums over all rows.  They are reduced
// without atomics, in a fixed order: each block walks a fixed sequence of
// 128-row tiles, keeps each tile's bf16 per-row vectors in shared memory,
// and adds dW = A^T . B over the tile's rows as mma products (K = rows,
// A^T by ldmatrix.trans) into accumulators that its 8 warps hold in
// registers, 76 output tiles of 16 x 8 between them; at the end it writes
// its own partial row of a [n_blocks, 9408] buffer, and a second kernel
// sums the partials over blocks in block order.  The result is the same
// from run to run.

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

// ---- B-MLP (tensor cores).  A block of 8 warps walks 128-row tiles, 16
// rows a warp.  Its shared memory holds the bf16 weights, [in][out]
// row-major, and the tile's bf16 row vectors, [row][width]; every row
// stride is padded to an odd multiple of 16 bytes (or 16, 48 bytes), so
// the 8 row addresses of an ldmatrix, and a warp's 32-bit stores from an
// accumulator fragment, fall in distinct banks.
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 16 * kBwdWarps;
constexpr int LW0 = 72, LW1 = 24, LV0 = 72, LV1 = 72, LV2 = 8;  // weights
constexpr int B_W0 = 0;
constexpr int B_W1 = B_W0 + D_IN * LW0;
constexpr int B_V0 = B_W1 + D_HID * LW1;
constexpr int B_V1 = B_V0 + RGB_IN * LV0;
constexpr int B_V2 = B_V1 + D_HID * LV1;  // V2 padded to [64, 8]
constexpr int N_BW = B_V2 + D_HID * LV2;
// x; [bf16(dout), d]; hb, r1b, r2b, dr2, dr1, dh; g4 (3 used); d_dout.
constexpr int LX = 40, LIN = 40, LH = 72, LG = 8, LDD = 24;
constexpr int R_X = N_BW;
constexpr int R_IN = R_X + kBwdRows * LX;
constexpr int R_HB = R_IN + kBwdRows * LIN;
constexpr int R_R1 = R_HB + kBwdRows * LH;
constexpr int R_R2 = R_R1 + kBwdRows * LH;
constexpr int R_G = R_R2 + kBwdRows * LH;
constexpr int R_DR2 = R_G + kBwdRows * LG;
constexpr int R_DR1 = R_DR2 + kBwdRows * LH;
constexpr int R_DD = R_DR1 + kBwdRows * LH;
constexpr int R_DH = R_DD + kBwdRows * LDD;
constexpr int N_BWD = R_DH + kBwdRows * LH;
constexpr size_t BWD_SMEM = N_BWD * sizeof(__nv_bfloat16);  // 161,792 B
// Weight-gradient output tiles of 16 x 8: dW0 2x8, dW1 4x2, dV0 2x8,
// dV1 4x8, dV2 4x1 (3 of 8 columns kept); warp w owns tiles w, w+8, ...
constexpr int kNWTiles = 76;
constexpr int kWTilesPerWarp = (kNWTiles + kBwdWarps - 1) / kBwdWarps;

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

// ---- B-MLP building blocks: ldmatrix and mma.sync.m16n8k16 (bf16 in,
// f32 accumulate).  Fragment layouts (PTX ISA, m16n8k16): lane = 4 gr + t;
// A[16 x 16]: a0 = (gr, 2t..2t+1), a1 = (gr+8, 2t..), a2 = (gr, 8+2t..),
// a3 = (gr+8, 8+2t..); B[16 x 8]: b0 = (k 2t..2t+1, n gr), b1 = (k 8+2t..,
// n gr); C[16 x 8]: c0,c1 = (gr, 2t..2t+1), c2,c3 = (gr+8, 2t..2t+1).  So
// the C tiles 2kk and 2kk+1 of one layer are, packed to bf16, exactly the
// A fragment of k-chunk kk of the next: activations stay in registers.

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm2(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm2t(uint32_t (&r)[2], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a)
      : "memory");
}

// c += a . b over one k16 step.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in bits 0-15
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
}

// ReLU in place; returns the mask of positive pre-activations (bit 4j+e).
__device__ __forceinline__ uint32_t relu_mask(float (&c)[8][4]) {
  uint32_t m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (c[j][e] > 0.0f) m |= 1u << (4 * j + e);
      c[j][e] = fmaxf(c[j][e], 0.0f);
    }
  return m;
}

__device__ __forceinline__ void apply_mask(float (&c)[8][4], uint32_t m) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[j][e] = ((m >> (4 * j + e)) & 1u) ? c[j][e] : 0.0f;
}

// The tensor core adds each k16 group in its own order and rounding, the
// plain twin (and the CUDA-core chain) k by k with f32 FMAs; products of
// bf16 values are exact, so the two sums are equal but for rare last
// bits.  Those bits matter only where a value is about to be rounded to
// bf16 or masked by its sign: a sum within kBandUlps f32 ulps of a bf16
// rounding midpoint, or within kNearZero of zero, is summed again k by k
// from the bf16 rows in shared memory, so B-MLP rounds and masks as its
// twin does.  On an H100 about 1 sum in 10^6 disagreed before this.
constexpr uint32_t kBandUlps = 16;
constexpr float kBandAbs = 4.76837158e-7f;  // 2^-21
constexpr float kNearZero = 1e-6f;

__device__ __forceinline__ bool ambiguous(float v) {
  const float a = fabsf(v);
  const uint32_t u = __float_as_uint(a);
  const float mid = __uint_as_float((u & 0xFFFF0000u) | 0x8000u);
  return a < kNearZero || (u & 0xFFFFu) - (0x8000u - kBandUlps) <= 2u * kBandUlps ||
         fabsf(a - mid) < kBandAbs;
}

// sum over k < K, in k order, of a[k] * w[k * ws], f32 FMAs.
template <int K>
__device__ __forceinline__ float seq_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* w, int ws) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    s = fmaf(__bfloat162float(a[k]), __bfloat162float(w[k * ws]), s);
  return s;
}

// Bit 4j+e set = entry c[j][e] is ambiguous (and live).
template <int NT>
__device__ __forceinline__ uint32_t ambiguous_bits(const float (&c)[NT][4],
                                                   uint32_t live) {
  uint32_t f = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ambiguous(c[j][e])) f |= 1u << (4 * j + e);
  return f & live;
}

template <int NT>
__device__ __forceinline__ void set_entry(float (&c)[NT][4], int i, float v) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (4 * j + e == i) c[j][e] = v;
}

// Re-sums the ambiguous entries of c, the C fragments of the warp's 16 rows
// of act[16 x K] (row stride lda) times the weights, column col being
// sum_k act[k] * w[col * cs + k * ks]; entries whose bit in `live` is clear
// are masked to 0 after and are skipped.  With ADD0, add0_lo / add0_hi
// (rows gr and gr + 8) join column 0 after the sum, as g[:, 3] joins
// d_dout[:, 0].  A lane loops over its own flagged entries only.
template <int NT, int K, bool ADD0 = false>
__device__ __forceinline__ void fixup(float (&c)[NT][4],
                                      const __nv_bfloat16* act, int lda,
                                      const __nv_bfloat16* w, int cs, int ks,
                                      int lane, uint32_t live = 0xffffffffu,
                                      float add0_lo = 0.0f,
                                      float add0_hi = 0.0f) {
  const int gr = lane >> 2, t = lane & 3;
  uint32_t flags = ambiguous_bits(c, live);
  while (flags) {
    const int i = __ffs(flags) - 1;
    flags &= flags - 1;
    const int row = gr + ((i >> 1) & 1) * 8, col = (i >> 2) * 8 + 2 * t + (i & 1);
    float v = seq_dot<K>(act + row * lda, w + col * cs, ks);
    if (ADD0 && col == 0) v += row < 8 ? add0_lo : add0_hi;
    set_entry(c, i, v);
  }
}

// The C fragments of a 16 x 16KT product, rounded to bf16, as the A
// fragments of the next product; the same bf16 values go to the warp's 16
// tile rows at s (row stride ld) for the weight gradients.
template <int KT>
__device__ __forceinline__ void to_a(uint32_t (&a)[KT][4],
                                     const float (&c)[2 * KT][4],
                                     __nv_bfloat16* s, int ld, int lane) {
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 2 * kk + h;
      a[kk][2 * h] = pack_bf16(c[j][0], c[j][1]);
      a[kk][2 * h + 1] = pack_bf16(c[j][2], c[j][3]);
      *reinterpret_cast<uint32_t*>(s + gr * ld + j * 8 + 2 * t) = a[kk][2 * h];
      *reinterpret_cast<uint32_t*>(s + (gr + 8) * ld + j * 8 + 2 * t) =
          a[kk][2 * h + 1];
    }
}

// A fragment of 16 rows x 16 columns of a row-major bf16 block at
// shared address base (row stride ld).
__device__ __forceinline__ void load_a(uint32_t (&a)[4], uint32_t base,
                                       int ld, int lane) {
  const int q = lane >> 3, r = lane & 7;
  ldsm4(a, base + 2 * (((q & 1) * 8 + r) * ld + (q >> 1) * 8));
}

// acc[16 x 8NT] += a[16 x 16KT] . W, W [16KT x 8NT] row-major at shared
// address w (row stride ldw); ldmatrix.trans gives two n-tiles a load.
template <int KT, int NT>
__device__ __forceinline__ void mm_w(float (&acc)[NT][4],
                                     const uint32_t (&a)[KT][4], uint32_t w,
                                     int ldw, int lane) {
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4t(b, w + 2 * ((kk * 16 + (q & 1) * 8 + r) * ldw + (j + (q >> 1)) * 8));
      mma(acc[j], a[kk], b[0], b[1]);
      mma(acc[j + 1], a[kk], b[2], b[3]);
    }
}

// acc[16 x 8NT] += a[16 x 16KT] . W^T, W [8NT x 16KT] row-major at shared
// address w (row stride ldw): the cotangent products.
template <int KT, int NT>
__device__ __forceinline__ void mm_wt(float (&acc)[NT][4],
                                      const uint32_t (&a)[KT][4], uint32_t w,
                                      int ldw, int lane) {
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm4(b, w + 2 * (((j + (q >> 1)) * 8 + r) * ldw + kk * 16 + (q & 1) * 8));
      mma(acc[j], a[kk], b[0], b[1]);
      mma(acc[j + 1], a[kk], b[2], b[3]);
    }
}

__device__ __forceinline__ void load_weights_bf16(
    __nv_bfloat16* s, const float* __restrict__ w0,
    const float* __restrict__ w1, const float* __restrict__ v0,
    const float* __restrict__ v1, const float* __restrict__ v2) {
  for (int i = threadIdx.x; i < D_IN * D_HID; i += blockDim.x)
    s[B_W0 + (i / D_HID) * LW0 + i % D_HID] = __float2bfloat16_rn(w0[i]);
  for (int i = threadIdx.x; i < D_HID * D_GEO; i += blockDim.x)
    s[B_W1 + (i / D_GEO) * LW1 + i % D_GEO] = __float2bfloat16_rn(w1[i]);
  for (int i = threadIdx.x; i < RGB_IN * D_HID; i += blockDim.x)
    s[B_V0 + (i / D_HID) * LV0 + i % D_HID] = __float2bfloat16_rn(v0[i]);
  for (int i = threadIdx.x; i < D_HID * D_HID; i += blockDim.x)
    s[B_V1 + (i / D_HID) * LV1 + i % D_HID] = __float2bfloat16_rn(v1[i]);
  for (int i = threadIdx.x; i < D_HID * LV2; i += blockDim.x) {
    const int j = i / LV2, c = i % LV2;
    s[B_V2 + i] = __float2bfloat16_rn(c < 3 ? v2[j * 3 + c] : 0.0f);
  }
}

// One weight-gradient output tile: dW[mi*16.., ni*8..] += A^T . B over
// the tile's rows, A and B the tile's row vectors at a_off and b_off.
struct WTile {
  int a_off, lda, b_off, ldb, mi, ni, goff, ncols;
};

__device__ __forceinline__ WTile wtile(int id) {
  if (id < 16) return {R_X, LX, R_DH, LH, id / 8, id % 8, G_W0, D_HID};
  id -= 16;
  if (id < 8) return {R_HB, LH, R_DD, LDD, id / 2, id % 2, G_W1, D_GEO};
  id -= 8;
  if (id < 16) return {R_IN, LIN, R_DR1, LH, id / 8, id % 8, G_V0, D_HID};
  id -= 16;
  if (id < 32) return {R_R1, LH, R_DR2, LH, id / 8, id % 8, G_V1, D_HID};
  id -= 32;
  return {R_R2, LH, R_G, LG, id, 0, G_V2, 3};
}

__global__ void __launch_bounds__(kBwdThreads, 1)
    mlp_bwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ d,
                   const float* __restrict__ w0, const float* __restrict__ w1,
                   const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2, const float* __restrict__ g,
                   float* __restrict__ dx, float* __restrict__ partial,
                   int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  const uint32_t s0 = saddr(sm);
  load_weights_bf16(sm, w0, w1, v0, v1, v2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3, q = lane >> 3, r8 = lane & 7;
  const int wr = warp * 16;  // the warp's first row in the tile
  float wacc[kWTilesPerWarp][4];
#pragma unroll
  for (int i = 0; i < kWTilesPerWarp; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) wacc[i][e] = 0.0f;
  const int64_t n_tiles = ((int64_t)n + kBwdRows - 1) / kBwdRows;

  for (int64_t ti = blockIdx.x; ti < n_tiles; ti += gridDim.x) {
    __syncthreads();  // weights loaded / the last tile's sums are done
    const int64_t r0 = ti * kBwdRows + wr;
    // ---- the warp's 16 rows of x, d and g4 = bf16(g[:3]); zeros past n.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = lane + 32 * h, row = c >> 2, part = c & 3;
      const uint4 v = r0 + row < n
                          ? reinterpret_cast<const uint4*>(x + (r0 + row) * D_IN)[part]
                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sm + R_X + (wr + row) * LX + part * 8) = v;
    }
    {
      const int row = lane >> 1, part = lane & 1;
      const uint4 v = r0 + row < n
                          ? reinterpret_cast<const uint4*>(d + (r0 + row) * SH_DIM)[part]
                          : make_uint4(0u, 0u, 0u, 0u);
      *reinterpret_cast<uint4*>(sm + R_IN + (wr + row) * LIN + D_GEO + part * 8) = v;
    }
    float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lane < 16) {
      if (r0 + lane < n) gv = reinterpret_cast<const float4*>(g)[r0 + lane];
      *reinterpret_cast<uint4*>(sm + R_G + (wr + lane) * LG) =
          make_uint4(pack_bf16(gv.x, gv.y), pack_bf16(gv.z, 0.0f), 0u, 0u);
    }
    const float g3lo = __shfl_sync(0xffffffffu, gv.w, gr);      // row gr
    const float g3hi = __shfl_sync(0xffffffffu, gv.w, gr + 8);  // row gr+8
    __syncwarp();

    // ---- forward, recomputed.  a0 = x . W0; hb = bf16(relu(a0)).
    float acc[8][4];
    uint32_t ax[2][4];
    load_a(ax[0], s0 + 2 * (R_X + wr * LX), LX, lane);
    load_a(ax[1], s0 + 2 * (R_X + wr * LX + 16), LX, lane);
    zero(acc);
    mm_w<2, 8>(acc, ax, s0 + 2 * B_W0, LW0, lane);
    fixup<8, D_IN>(acc, sm + R_X + wr * LX, LX, sm + B_W0, 1, LW0, lane);
    const uint32_t m0 = relu_mask(acc);
    uint32_t ah[4][4];
    to_a<4>(ah, acc, sm + R_HB + wr * LH, LH, lane);
    __syncwarp();
    // dout = hb . W1 (f32); db = bf16(dout).
    float dout[2][4];
    zero(dout);
    mm_w<4, 2>(dout, ah, s0 + 2 * B_W1, LW1, lane);
    fixup<2, D_HID>(dout, sm + R_HB + wr * LH, LH, sm + B_W1, 1, LW1, lane);
    uint32_t adb[1][4], ad[4];
    to_a<1>(adb, dout, sm + R_IN + wr * LIN, LIN, lane);
    __syncwarp();
    load_a(ad, s0 + 2 * (R_IN + wr * LIN + D_GEO), LIN, lane);
    // a1 = db . V0[:16] + d . V0[16:], each partial on its own, then added.
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      uint32_t b[4], bd[4];
      ldsm4t(b, s0 + 2 * (B_V0 + ((q & 1) * 8 + r8) * LV0 + (j + (q >> 1)) * 8));
      ldsm4t(bd, s0 + 2 * (B_V0 + (D_GEO + (q & 1) * 8 + r8) * LV0 +
                           (j + (q >> 1)) * 8));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float p[4] = {0.f, 0.f, 0.f, 0.f}, pd[4] = {0.f, 0.f, 0.f, 0.f};
        mma(p, adb[0], b[2 * h], b[2 * h + 1]);
        mma(pd, ad, bd[2 * h], bd[2 * h + 1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j + h][e] = p[e] + pd[e];
      }
    }
    for (uint32_t f = ambiguous_bits(acc, 0xffffffffu); f; f &= f - 1) {
      const int i = __ffs(f) - 1;
      const __nv_bfloat16* in = sm + R_IN + (wr + gr + ((i >> 1) & 1) * 8) * LIN;
      const __nv_bfloat16* v0c = sm + B_V0 + (i >> 2) * 8 + 2 * t + (i & 1);
      set_entry(acc, i, seq_dot<D_GEO>(in, v0c, LV0) +
                            seq_dot<SH_DIM>(in + D_GEO, v0c + D_GEO * LV0, LV0));
    }
    const uint32_t m1 = relu_mask(acc);
    uint32_t ar[4][4];
    to_a<4>(ar, acc, sm + R_R1 + wr * LH, LH, lane);
    __syncwarp();
    // a2 = r1b . V1; r2b = bf16(relu(a2)) (to the tile only).
    zero(acc);
    mm_w<4, 8>(acc, ar, s0 + 2 * B_V1, LV1, lane);
    fixup<8, D_HID>(acc, sm + R_R1 + wr * LH, LH, sm + B_V1, 1, LV1, lane);
    const uint32_t m2 = relu_mask(acc);
    to_a<4>(ar, acc, sm + R_R2 + wr * LH, LH, lane);

    // ---- backward.  dr2 = bf16((g4 . V2^T) * (a2 > 0)), k = 3 of 16.
    uint32_t ag[4];
    {
      uint32_t rg[2];
      ldsm2(rg, s0 + 2 * (R_G + (wr + (lane & 15)) * LG));
      ag[0] = rg[0];
      ag[1] = rg[1];
      ag[2] = ag[3] = 0u;
    }
    zero(acc);
#pragma unroll
    for (int j = 0; j < 8; j += 4) {
      uint32_t b[4];
      ldsm4(b, s0 + 2 * (B_V2 + (j * 8 + lane) * LV2));
#pragma unroll
      for (int h = 0; h < 4; ++h) mma(acc[j + h], ag, b[h], 0u);
    }
    fixup<8, 3>(acc, sm + R_G + wr * LG, LG, sm + B_V2, LV2, 1, lane, m2);
    apply_mask(acc, m2);
    to_a<4>(ar, acc, sm + R_DR2 + wr * LH, LH, lane);
    __syncwarp();
    // dr1 = bf16((dr2 . V1^T) * (a1 > 0)).
    zero(acc);
    mm_wt<4, 8>(acc, ar, s0 + 2 * B_V1, LV1, lane);
    fixup<8, D_HID>(acc, sm + R_DR2 + wr * LH, LH, sm + B_V1, LV1, 1, lane, m1);
    apply_mask(acc, m1);
    to_a<4>(ar, acc, sm + R_DR1 + wr * LH, LH, lane);
    __syncwarp();
    // d_dout = bf16(dr1 . V0[:16]^T, with g[:, 3] added to column 0).
    float dd[2][4];
    zero(dd);
    mm_wt<4, 2>(dd, ar, s0 + 2 * B_V0, LV0, lane);
    if (t == 0) {
      dd[0][0] += g3lo;
      dd[0][2] += g3hi;
    }
    fixup<2, D_HID, true>(dd, sm + R_DR1 + wr * LH, LH, sm + B_V0, LV0, 1,
                          lane, 0xffffffffu, g3lo, g3hi);
    to_a<1>(adb, dd, sm + R_DD + wr * LDD, LDD, lane);
    __syncwarp();
    // dh = bf16((d_dout . W1^T) * (a0 > 0)).
    zero(acc);
    mm_wt<1, 8>(acc, adb, s0 + 2 * B_W1, LW1, lane);
    fixup<8, D_GEO>(acc, sm + R_DD + wr * LDD, LDD, sm + B_W1, LW1, 1, lane, m0);
    apply_mask(acc, m0);
    to_a<4>(ah, acc, sm + R_DH + wr * LH, LH, lane);
    // dx = dh . W0^T (f32).
    float dxa[4][4];
    zero(dxa);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // fresh accumulators a k16 step, added
      float part[4][4];               // in f32: no long truncating chain
      zero(part);
      const uint32_t (&a1)[1][4] = *reinterpret_cast<const uint32_t(*)[1][4]>(ah[kk]);
      mm_wt<1, 4>(part, a1, s0 + 2 * (B_W0 + kk * 16), LW0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dxa[j][e] += part[j][e];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (r0 + gr < n)
        *reinterpret_cast<float2*>(dx + (r0 + gr) * D_IN + j * 8 + 2 * t) =
            make_float2(dxa[j][0], dxa[j][1]);
      if (r0 + gr + 8 < n)
        *reinterpret_cast<float2*>(dx + (r0 + gr + 8) * D_IN + j * 8 + 2 * t) =
            make_float2(dxa[j][2], dxa[j][3]);
    }
    __syncthreads();

    // ---- the tile's weight gradients, K = the tile's 128 rows, into this
    // warp's accumulators: A^T from ldmatrix.trans of the row vectors.
#pragma unroll
    for (int i = 0; i < kWTilesPerWarp; ++i) {
      const int id = warp + kBwdWarps * i;
      if (id < kNWTiles) {
        const WTile w = wtile(id);
        // The tile's sum in fresh accumulators, then one f32 add: the
        // tensor core truncates as it accumulates, and a chain over all
        // of the block's tiles drifted by ~1e-5 of the largest entry.
        float tacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < kBwdRows / 16; ++kk) {
          uint32_t a[4], b[2];
          ldsm4t(a, s0 + 2 * (w.a_off + (kk * 16 + (q >> 1) * 8 + r8) * w.lda +
                              w.mi * 16 + (q & 1) * 8));
          ldsm2t(b, s0 + 2 * (w.b_off + (kk * 16 + (q & 1) * 8 + r8) * w.ldb +
                              w.ni * 8));
          mma(tacc, a, b[0], b[1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) wacc[i][e] += tacc[e];
      }
    }
  }
  // ---- this block's partial sums, in the flattened dW0..dV2 order.
  float* part = partial + (int64_t)blockIdx.x * N_GRAD;
#pragma unroll
  for (int i = 0; i < kWTilesPerWarp; ++i) {
    const int id = warp + kBwdWarps * i;
    if (id < kNWTiles) {
      const WTile w = wtile(id);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = w.mi * 16 + gr + (e >> 1) * 8, c = w.ni * 8 + 2 * t + (e & 1);
        if (c < w.ncols) part[w.goff + m * w.ncols + c] = wacc[i][e];
      }
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
  const int tiles = (int)(((int64_t)n + kBwdRows - 1) / kBwdRows);
  const int sms = sm_count();
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
  mlp_bwd_kernel<<<n_blocks, kBwdThreads, BWD_SMEM, st>>>(
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
