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
// What bounds them.  A row costs 18.8 kFLOP forward and 54.4 kFLOP
// backward (recomputed forward, cotangents, weight gradients) against 112 B
// (forward) or 240 B (backward) of row traffic.  On the tensor cores the
// FLOPs are cheap (2^20 forward rows: 19.7 GFLOP, 20 us at the bf16 peak)
// and the least time is the rows' bytes (117 MB, 35 us); what a kernel
// spends beyond that goes to the ALU work around each mma: packing,
// masking, and above all the test of every sum for an ambiguous rounding
// and the re-sums it calls for (below).  F-MLP at 2^20 random rows took
// 0.089 ms with neither (and then disagreed with its twin by 1.7e-2), 0.29
// ms with both: about 3 re-sums a warp's 16-row tile, each a chain of up
// to 64 dependent FMAs that one lane runs while the warp waits.
//
// F-MLP and B-MLP run on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators) and share one forward, mlp_forward.  Every
// operand is bf16-exact already (weights rounded on load, activations
// re-quantized), so only the f32 sums differ from the twin's k-by-k chain:
// the tensor core adds each k16 group in its own order.  Where that could
// change a bf16 rounding or a ReLU mask, the sum is taken again in the
// twin's order (fixup below), so both kernels round as their twin does.
// A warp takes 16 rows; each layer's accumulators, masked and rounded,
// become the next product's operand fragments in registers.  The rgb
// input stays two partial products of one k16 step each, added after.
//
// F-MLP keeps in shared memory only the rows its re-sums read (x, [db, d],
// hb, r1b: 9.5 KB a warp, x and d twice) and the bf16 weights (22.5 KB a
// block), so two blocks of 8 warps fit on an SM (one for B-MLP).  A
// persistent grid of those blocks walks 16-row tiles, each warp on its
// own: it loads its next tile's x and d rows (96 B a row) with cp.async
// into a second buffer while it computes the current one, ends the
// forward with rgb = r2b . V2 (V2 padded to [64, 8]: four k16 steps into
// one n8 tile), and writes each row's [rgb, dout[0]] as one 16-byte
// store.  Those two outputs stay f32 and nothing rounds them, so they need
// no re-sum.
//
// D-MLP is the density half of that forward on the same persistent grid
// and cp.async double buffer, over the x rows alone: a0 = x . W0 with its
// re-sums (density_hidden, which mlp_forward calls too), then sigma = hb .
// W1[:, 0] as one n8 tile of four k16 steps, f32 and not re-summed.  A
// warp's 16 sigmas are shuffled to lanes 0-15 and written as one 64-byte
// store.  Its row costs 68 B and 4.2 kFLOP: bound by bytes (2^20 rows: 71
// MB, 21 us).  It takes 75 us there (device time; NVIDIA H100 80GB HBM3,
// 700 W), 2.3x the CUDA-core design it replaced, spent as F-MLP's is: the
// test of each of a row's 64 first-layer sums and ~1.8 re-sums a tile.
//
// In B-MLP the cotangent products read the same bf16 weights through
// ldmatrix without .trans (W^T).
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

// ---- F-MLP (tensor cores).  The same bf16 weights at the same offsets,
// then each warp's own rows: x and [db, d] twice (the tile being computed
// and the next one, in flight), hb and r1b once.
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int F_X = 0;
constexpr int F_IN = F_X + 2 * 16 * LX;
constexpr int F_HB = F_IN + 2 * 16 * LIN;
constexpr int F_R1 = F_HB + 16 * LH;
constexpr int F_WARP = F_R1 + 16 * LH;  // 4864 bf16 = 9,728 B
// After the rows, f32: kBandMag * max_k |W[k, col]| of W0, W1, V0, V1.
constexpr int CM_W0 = 0;
constexpr int CM_W1 = CM_W0 + D_HID;
constexpr int CM_V0 = CM_W1 + D_GEO;
constexpr int CM_V1 = CM_V0 + D_HID;
constexpr int N_CM = CM_V1 + D_HID;
constexpr size_t FWD_SMEM = (N_BW + kFwdWarps * F_WARP) * sizeof(__nv_bfloat16) +
                            N_CM * sizeof(float);  // 101,184 B

// ---- D-MLP (tensor cores).  W0 and W1 at the same offsets (B_V0 ends
// them), then each warp's x rows twice, then the column maxima of W0.
constexpr int D_WARP = 2 * 16 * LX;
constexpr size_t DEN_SMEM = (B_V0 + kFwdWarps * D_WARP) * sizeof(__nv_bfloat16) +
                            D_HID * sizeof(float);  // 28,416 B

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---- Tensor-core building blocks of F-MLP and B-MLP: ldmatrix and
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Fragment layouts (PTX ISA, m16n8k16): lane = 4 gr + t;
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
// plain twin k by k with f32 FMAs; products of bf16 values are exact, so
// the two sums are equal but for rare last bits.  Those bits matter only
// where a value is about to be rounded to bf16 or masked by its sign: a
// sum v within kBandRel * |v| + floor of the bf16 rounding midpoint of its
// interval is summed again k by k from the bf16 rows in shared memory, so
// F-MLP and B-MLP round and mask as their twin does.  The relative band
// covers 16 to 32 f32 ulps of v; the floor covers sums that cancel, and
// the sums near zero, where a sign could flip.  Before a ReLU only v >
// -floor / kBandRel can matter (below, the mask and the value, 0, are
// certain), and the test there takes v's sign.  On an H100 about 1 sum in
// 10^6 disagreed without the re-sum.
//
// The floor: B-MLP keeps kBandAbs for every sum.  F-MLP lowers it where
// the sum's own terms are small, as their rounding errors scale with
// them: to kBandMag times the row's L1 norm times the column's largest
// |w| (a bound on the sum of the row's |a_k w_k|) where that is below
// kBandAbs.  On random O(1) rows it seldom is; a render chunk's rows carry
// small hash features, and there F-MLP took 0.667 ms with kBandAbs for
// every sum and 0.310 ms with this floor (2^20 rows, NVIDIA H100 80GB HBM3,
// 700 W).  The test is 5 instructions a sum plus 2 for F-MLP's floor; an
// earlier form with separate ulp, midpoint and zero tests (a subset of
// this band) took F-MLP from 0.290 to 0.465 ms on 2^20 random rows.
constexpr float kBandRel = 1.9073486e-6f;   // 2^-19
constexpr float kBandAbs = 4.76837158e-7f;  // 2^-21
constexpr float kBandMag = 2.38418579e-7f;  // 2^-22

template <bool RELU>
__device__ __forceinline__ bool ambiguous(float v, float floor) {
  const float a = RELU ? v : fabsf(v);
  const float mid = __uint_as_float((__float_as_uint(a) & 0xFFFF0000u) | 0x8000u);
  return fabsf(a - mid) < fmaf(a, kBandRel, floor);
}

// B-MLP's floor.
struct AbsFloor {
  __device__ float operator()(int, int) const { return kBandAbs; }
};

// F-MLP's floor for entry e of C tile j: row[h] for row gr + 8h times
// col[j][b] for column 8j + 2t + b (kBandMag folded into col), at most
// kBandAbs.
template <int NT>
struct MagFloor {
  float row[2], col[NT][2];
  __device__ float operator()(int j, int e) const {
    return fminf(kBandAbs, row[e >> 1] * col[j][e & 1]);
  }
};

// sum over k < K, in k order, of a[k] * w[k * ws], f32 FMAs; a (a row in
// shared memory, 16-byte aligned when K is a multiple of 8) is read 8
// values a load.
template <int K>
__device__ __forceinline__ float seq_dot(const __nv_bfloat16* a,
                                         const __nv_bfloat16* w, int ws) {
  float s = 0.0f;
  if constexpr (K % 8 == 0) {
#pragma unroll
    for (int k8 = 0; k8 < K; k8 += 8) {
      const uint4 av = *reinterpret_cast<const uint4*>(a + k8);
      const __nv_bfloat162* ah = reinterpret_cast<const __nv_bfloat162*>(&av);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 af = __bfloat1622float2(ah[u]);
        s = fmaf(af.x, __bfloat162float(w[(k8 + 2 * u) * ws]), s);
        s = fmaf(af.y, __bfloat162float(w[(k8 + 2 * u + 1) * ws]), s);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      s = fmaf(__bfloat162float(a[k]), __bfloat162float(w[k * ws]), s);
  }
  return s;
}

// Bit 4j+e set = entry c[j][e] is ambiguous (and live); RELU before a ReLU.
template <int NT, bool RELU = false, class Floor = AbsFloor>
__device__ __forceinline__ uint32_t ambiguous_bits(const float (&c)[NT][4],
                                                   uint32_t live,
                                                   const Floor& fl = Floor()) {
  uint32_t f = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ambiguous<RELU>(c[j][e], fl(j, e))) f |= 1u << (4 * j + e);
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
// d_dout[:, 0].  RELU and fl choose the test (ambiguous_bits).  A lane
// loops over its own flagged entries only.
template <int NT, int K, bool ADD0 = false, bool RELU = false,
          class Floor = AbsFloor>
__device__ __forceinline__ void fixup(float (&c)[NT][4],
                                      const __nv_bfloat16* act, int lda,
                                      const __nv_bfloat16* w, int cs, int ks,
                                      int lane, uint32_t live = 0xffffffffu,
                                      float add0_lo = 0.0f,
                                      float add0_hi = 0.0f,
                                      const Floor& fl = Floor()) {
  const int gr = lane >> 2, t = lane & 3;
  uint32_t flags = ambiguous_bits<NT, RELU>(c, live, fl);
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
// fragments of the next product; with STORE the same bf16 values go to the
// warp's 16 tile rows at s (row stride ld), for the re-sums of the next
// product and for the weight gradients.
template <int KT, bool STORE = true>
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
      if (STORE) {
        *reinterpret_cast<uint32_t*>(s + gr * ld + j * 8 + 2 * t) = a[kk][2 * h];
        *reinterpret_cast<uint32_t*>(s + (gr + 8) * ld + j * 8 + 2 * t) =
            a[kk][2 * h + 1];
      }
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
// address w (row stride ldw); ldmatrix.trans gives two n-tiles a load (the
// last of an odd NT alone).
template <int KT, int NT>
__device__ __forceinline__ void mm_w(float (&acc)[NT][4],
                                     const uint32_t (&a)[KT][4], uint32_t w,
                                     int ldw, int lane) {
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      uint32_t b[4];
      ldsm4t(b, w + 2 * ((kk * 16 + (q & 1) * 8 + r) * ldw + (j + (q >> 1)) * 8));
      mma(acc[j], a[kk], b[0], b[1]);
      mma(acc[j + 1], a[kk], b[2], b[3]);
    }
    if constexpr (NT % 2 == 1) {
      uint32_t b[2];
      ldsm2t(b, w + 2 * ((kk * 16 + (lane & 15)) * ldw + (NT - 1) * 8));
      mma(acc[NT - 1], a[kk], b[0], b[1]);
    }
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

// W0 and W1, rounded to bf16, at B_W0 and B_W1 of s.
__device__ __forceinline__ void load_density_weights_bf16(
    __nv_bfloat16* s, const float* __restrict__ w0,
    const float* __restrict__ w1) {
  for (int i = threadIdx.x; i < D_IN * D_HID; i += blockDim.x)
    s[B_W0 + (i / D_HID) * LW0 + i % D_HID] = __float2bfloat16_rn(w0[i]);
  for (int i = threadIdx.x; i < D_HID * D_GEO; i += blockDim.x)
    s[B_W1 + (i / D_GEO) * LW1 + i % D_GEO] = __float2bfloat16_rn(w1[i]);
}

__device__ __forceinline__ void load_weights_bf16(
    __nv_bfloat16* s, const float* __restrict__ w0,
    const float* __restrict__ w1, const float* __restrict__ v0,
    const float* __restrict__ v1, const float* __restrict__ v2) {
  load_density_weights_bf16(s, w0, w1);
  for (int i = threadIdx.x; i < RGB_IN * D_HID; i += blockDim.x)
    s[B_V0 + (i / D_HID) * LV0 + i % D_HID] = __float2bfloat16_rn(v0[i]);
  for (int i = threadIdx.x; i < D_HID * D_HID; i += blockDim.x)
    s[B_V1 + (i / D_HID) * LV1 + i % D_HID] = __float2bfloat16_rn(v1[i]);
  for (int i = threadIdx.x; i < D_HID * LV2; i += blockDim.x) {
    const int j = i / LV2, c = i % LV2;
    s[B_V2 + i] = __float2bfloat16_rn(c < 3 ? v2[j * 3 + c] : 0.0f);
  }
}

// The warp's 16 rows in shared memory (row strides LX, LIN, LH, LH, LH):
// x and d (in[:, 16:]) are loaded by the caller; hb, bf16(dout) (in[:, :16])
// and r1b are written here for the re-sums, r2b (B-MLP's only) for the
// weight gradients.
struct WarpRows {
  __nv_bfloat16 *x, *in, *hb, *r1, *r2;
};

// What the forward leaves in registers: the ReLU masks of a0, a1 and a2
// (bit 4j+e of the C fragments), r2b = bf16(relu(a2)) as A fragments, and
// dout in f32 (C fragments).
struct Fwd {
  uint32_t m0, m1, m2;
  uint32_t ar[4][4];
  float dout[2][4];
};

// kBandMag * max_k |bf16(w[k, col])| of a [K, ncols] f32 weight.
__device__ __forceinline__ float col_max(const float* __restrict__ w, int K,
                                         int ncols, int col) {
  float m = 0.0f;
  for (int k = 0; k < K; ++k) m = fmaxf(m, fabsf(bf(w[k * ncols + col])));
  return kBandMag * m;
}

// The floor of the band for a product with A operand a [16 x 16KT]: B-MLP's
// constant; F-MLP's MagFloor from the L1 norms of the warp's rows gr and
// gr + 8 of a, taken on the tensor core as |a| . ones (every column of the
// C fragment holds its row's sum), and the column maxima of the weight at
// cm + off.
template <bool BMLP, int NT, int KT>
__device__ __forceinline__ auto floor_of(const uint32_t (&a)[KT][4],
                                         const float* cm, int off, int lane) {
  if constexpr (BMLP) {
    return AbsFloor{};
  } else {
    constexpr uint32_t kOnes = 0x3F803F80u;  // bf16 1.0, twice
    MagFloor<NT> f;
    float l1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t aa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) aa[r] = a[kk][r] & 0x7FFF7FFFu;
      mma(l1, aa, kOnes, kOnes);
    }
    f.row[0] = l1[0];
    f.row[1] = l1[2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float2 c =
          *reinterpret_cast<const float2*>(cm + off + j * 8 + 2 * (lane & 3));
      f.col[j][0] = c.x;
      f.col[j][1] = c.y;
    }
    return f;
  }
}

// The first layer of the warp's 16 rows (x at w.x): a0 = x . W0, re-summed
// where ambiguous; returns the ReLU mask of a0 and leaves hb = bf16(relu(a0))
// in ah as A fragments (STORE: also at w.hb, for the next product's
// re-sums).  Weights and floor as mlp_forward's.
template <bool BMLP, bool STORE = true>
__device__ __forceinline__ uint32_t density_hidden(const __nv_bfloat16* sm,
                                                   const float* cm,
                                                   const WarpRows& w, int lane,
                                                   uint32_t (&ah)[4][4]) {
  float acc[8][4];
  uint32_t ax[2][4];
  load_a(ax[0], saddr(w.x), LX, lane);
  load_a(ax[1], saddr(w.x + 16), LX, lane);
  zero(acc);
  mm_w<2, 8>(acc, ax, saddr(sm) + 2 * B_W0, LW0, lane);
  fixup<8, D_IN, false, true>(acc, w.x, LX, sm + B_W0, 1, LW0, lane,
                              0xffffffffu, 0.0f, 0.0f,
                              floor_of<BMLP, 8>(ax, cm, CM_W0, lane));
  const uint32_t m = relu_mask(acc);
  to_a<4, STORE>(ah, acc, w.hb, LH, lane);
  return m;
}

// The forward of the warp's 16 rows, at the twin's quantization points:
// a0 = x . W0; hb = bf16(relu(a0)); dout = hb . W1; a1 = bf16(dout) .
// V0[:16] + d . V0[16:]; r1b = bf16(relu(a1)); a2 = r1b . V1; r2b =
// bf16(relu(a2)).  Each sum that is about to be rounded or masked is
// re-summed where ambiguous.  The weights sit at sm (offsets B_*).  BMLP:
// the forward that B-MLP recomputes (r2b also to w.r2, the floor kBandAbs);
// else F-MLP's (the floor from the column maxima at cm, offsets CM_*).
template <bool BMLP>
__device__ __forceinline__ void mlp_forward(const __nv_bfloat16* sm,
                                            const float* cm, const WarpRows& w,
                                            int lane, Fwd& f) {
  const uint32_t s0 = saddr(sm);
  const int gr = lane >> 2, t = lane & 3, q = lane >> 3, r8 = lane & 7;
  uint32_t ah[4][4];
  f.m0 = density_hidden<BMLP>(sm, cm, w, lane, ah);
  __syncwarp();
  float acc[8][4];
  // dout = hb . W1 (f32); db = bf16(dout).
  zero(f.dout);
  mm_w<4, 2>(f.dout, ah, s0 + 2 * B_W1, LW1, lane);
  fixup<2, D_HID>(f.dout, w.hb, LH, sm + B_W1, 1, LW1, lane, 0xffffffffu,
                  0.0f, 0.0f, floor_of<BMLP, 2>(ah, cm, CM_W1, lane));
  uint32_t adb[1][4], ad[4];
  to_a<1>(adb, f.dout, w.in, LIN, lane);
  __syncwarp();
  load_a(ad, saddr(w.in + D_GEO), LIN, lane);
  const uint32_t ain[2][4] = {{adb[0][0], adb[0][1], adb[0][2], adb[0][3]},
                              {ad[0], ad[1], ad[2], ad[3]}};
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
  for (uint32_t fl = ambiguous_bits<8, true>(
           acc, 0xffffffffu, floor_of<BMLP, 8>(ain, cm, CM_V0, lane));
       fl; fl &= fl - 1) {
    const int i = __ffs(fl) - 1;
    const __nv_bfloat16* in = w.in + (gr + ((i >> 1) & 1) * 8) * LIN;
    const __nv_bfloat16* v0c = sm + B_V0 + (i >> 2) * 8 + 2 * t + (i & 1);
    set_entry(acc, i, seq_dot<D_GEO>(in, v0c, LV0) +
                          seq_dot<SH_DIM>(in + D_GEO, v0c + D_GEO * LV0, LV0));
  }
  f.m1 = relu_mask(acc);
  to_a<4>(f.ar, acc, w.r1, LH, lane);
  __syncwarp();
  // a2 = r1b . V1; r2b = bf16(relu(a2)).
  zero(acc);
  mm_w<4, 8>(acc, f.ar, s0 + 2 * B_V1, LV1, lane);
  fixup<8, D_HID, false, true>(acc, w.r1, LH, sm + B_V1, 1, LV1, lane,
                               0xffffffffu, 0.0f, 0.0f,
                               floor_of<BMLP, 8>(f.ar, cm, CM_V1, lane));
  f.m2 = relu_mask(acc);
  to_a<4, BMLP>(f.ar, acc, w.r2, LH, lane);
}

// 16 bytes from global src to shared dst, or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(dst), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of rows r0 .. r0+15 of src [n, W] (bf16) to a warp's
// shared rows at dst (row stride ld), 16 bytes a copy; zeros past n.
template <int W>
__device__ __forceinline__ void load_rows_async(
    const __nv_bfloat16* __restrict__ src, int64_t r0, int n,
    __nv_bfloat16* dst, int ld, int lane) {
  constexpr int kParts = W / 8;
#pragma unroll
  for (int h = 0; h < 16 * kParts / 32; ++h) {
    const int c = lane + 32 * h, row = c / kParts, part = c % kParts;
    const bool live = r0 + row < n;
    cp_async16(saddr(dst + row * ld + part * 8),
               src + (live ? (r0 + row) * W + part * 8 : 0), live);
  }
}

// Starts the copy of rows r0 .. r0+15 of x and d into a warp's buffers: x
// to xs (row stride LX), d to in[:, 16:] (row stride LIN); zeros past n.
__device__ __forceinline__ void load_tile_async(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ d,
    int64_t r0, int n, __nv_bfloat16* xs, __nv_bfloat16* in, int lane) {
  load_rows_async<D_IN>(x, r0, n, xs, LX, lane);
  load_rows_async<SH_DIM>(d, r0, n, in + D_GEO, LIN, lane);
}

// F-MLP: a persistent grid; warp w of block b takes the 16-row tiles
// b * kFwdWarps + w, then every gridDim.x * kFwdWarps-th after it.
__global__ void __launch_bounds__(kFwdThreads, 2)
    mlp_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ d,
                   const float* __restrict__ w0, const float* __restrict__ w1,
                   const float* __restrict__ v0, const float* __restrict__ v1,
                   const float* __restrict__ v2, float* __restrict__ out,
                   int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gr = lane >> 2, t = lane & 3;
  __nv_bfloat16* rows = sm + N_BW + warp * F_WARP;
  const int64_t n_tiles = ((int64_t)n + 15) / 16;
  const int64_t stride = (int64_t)gridDim.x * kFwdWarps;
  int64_t tile = (int64_t)blockIdx.x * kFwdWarps + warp;
  if (tile < n_tiles)
    load_tile_async(x, d, tile * 16, n, rows + F_X, rows + F_IN, lane);
  cp_async_commit();
  load_weights_bf16(sm, w0, w1, v0, v1, v2);
  float* cm = reinterpret_cast<float*>(sm + N_BW + kFwdWarps * F_WARP);
  for (int i = threadIdx.x; i < N_CM; i += blockDim.x)
    cm[i] = i < CM_W1   ? col_max(w0, D_IN, D_HID, i - CM_W0)
            : i < CM_V0 ? col_max(w1, D_HID, D_GEO, i - CM_W1)
            : i < CM_V1 ? col_max(v0, RGB_IN, D_HID, i - CM_V0)
                        : col_max(v1, D_HID, D_HID, i - CM_V1);
  __syncthreads();
  const uint32_t s0 = saddr(sm);
  for (int b = 0; tile < n_tiles; tile += stride, b ^= 1) {
    const int64_t next = tile + stride;
    if (next < n_tiles)
      load_tile_async(x, d, next * 16, n, rows + F_X + (b ^ 1) * 16 * LX,
                      rows + F_IN + (b ^ 1) * 16 * LIN, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();
    Fwd fw;
    mlp_forward<false>(sm, cm,
                       {rows + F_X + b * 16 * LX, rows + F_IN + b * 16 * LIN,
                        rows + F_HB, rows + F_R1, nullptr},
                       lane, fw);
    // rgb = r2b . V2: V2 [64, 8] (3 columns used), four k16 steps.
    float rgb[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t bv[4];
      ldsm4t(bv, s0 + 2 * (B_V2 + (kh * 32 + lane) * LV2));
      mma(rgb, fw.ar[2 * kh], bv[0], bv[1]);
      mma(rgb, fw.ar[2 * kh + 1], bv[2], bv[3]);
    }
    // Lane t = 0 holds rgb columns 0-1 and dout column 0 of rows gr and
    // gr + 8, lane t = 1 rgb column 2: one 16-byte store a row.
    const float c2lo = __shfl_down_sync(0xffffffffu, rgb[0], 1);
    const float c2hi = __shfl_down_sync(0xffffffffu, rgb[2], 1);
    const int64_t r0 = tile * 16;
    float4* o = reinterpret_cast<float4*>(out);
    if (t == 0 && r0 + gr < n)
      o[r0 + gr] = make_float4(rgb[0], rgb[1], c2lo, fw.dout[0][0]);
    if (t == 0 && r0 + gr + 8 < n)
      o[r0 + gr + 8] = make_float4(rgb[2], rgb[3], c2hi, fw.dout[0][2]);
    __syncwarp();  // done with buffer b: the next tile but one loads into it
  }
}

// D-MLP: F-MLP's grid and tile order over the x rows alone.
__global__ void __launch_bounds__(kFwdThreads, 2)
    density_fwd_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w0,
                       const float* __restrict__ w1, float* __restrict__ out,
                       int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __nv_bfloat16* xs = sm + B_V0 + warp * D_WARP;
  const int64_t n_tiles = ((int64_t)n + 15) / 16;
  const int64_t stride = (int64_t)gridDim.x * kFwdWarps;
  int64_t tile = (int64_t)blockIdx.x * kFwdWarps + warp;
  if (tile < n_tiles) load_rows_async<D_IN>(x, tile * 16, n, xs, LX, lane);
  cp_async_commit();
  load_density_weights_bf16(sm, w0, w1);
  float* cm = reinterpret_cast<float*>(sm + B_V0 + kFwdWarps * D_WARP);
  for (int i = threadIdx.x; i < D_HID; i += blockDim.x)
    cm[CM_W0 + i] = col_max(w0, D_IN, D_HID, i);
  __syncthreads();
  const uint32_t s0 = saddr(sm);
  for (int b = 0; tile < n_tiles; tile += stride, b ^= 1) {
    const int64_t next = tile + stride;
    if (next < n_tiles)
      load_rows_async<D_IN>(x, next * 16, n, xs + (b ^ 1) * 16 * LX, LX, lane);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's rows have landed
    __syncwarp();
    uint32_t ah[4][4];
    density_hidden<false, false>(
        sm, cm, {xs + b * 16 * LX, nullptr, nullptr, nullptr, nullptr}, lane,
        ah);
    float s[1][4] = {{0.0f, 0.0f, 0.0f, 0.0f}};
    mm_w<4, 1>(s, ah, s0 + 2 * B_W1, LW1, lane);
    // Lane 4g holds sigma (column 0) of rows g and g + 8: lane r < 16
    // takes row r's, and the warp writes its 16 rows with one store.
    const float lo = __shfl_sync(0xffffffffu, s[0][0], 4 * (lane & 7));
    const float hi = __shfl_sync(0xffffffffu, s[0][2], 4 * (lane & 7));
    const int64_t r = tile * 16 + lane;
    if (lane < 16 && r < n) out[r] = lane < 8 ? lo : hi;
    __syncwarp();  // done with buffer b: the next tile but one loads into it
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

    // ---- forward, recomputed; r2b to the tile only.
    Fwd fw;
    mlp_forward<true>(sm, nullptr,
                      {sm + R_X + wr * LX, sm + R_IN + wr * LIN,
                       sm + R_HB + wr * LH, sm + R_R1 + wr * LH,
                       sm + R_R2 + wr * LH},
                      lane, fw);
    const uint32_t m0 = fw.m0, m1 = fw.m1, m2 = fw.m2;
    float acc[8][4];
    uint32_t ah[4][4], ar[4][4], adb[1][4];

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

// Sets `kernel`'s dynamic shared memory to smem bytes and gives in *blocks
// its persistent grid for n rows: as many blocks of kFwdThreads as fit on
// the card at once, or fewer when the rows' 16-row tiles run out.
template <class Kernel>
cudaError_t persistent_grid(Kernel kernel, size_t smem, int n, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kFwdThreads, smem);
  if (err != cudaSuccess) return err;
  const int64_t need = (((int64_t)n + 15) / 16 + kFwdWarps - 1) / kFwdWarps;
  const int64_t fit = (int64_t)(sm_count() > 0 ? sm_count() : 1) *
                      (per_sm > 0 ? per_sm : 1);
  *blocks = (int)(need < fit ? need : fit);
  return cudaSuccess;
}

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
  int blocks = 0;
  const cudaError_t err = persistent_grid(mlp_fwd_kernel, FWD_SMEM, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  mlp_fwd_kernel<<<blocks, kFwdThreads, FWD_SMEM, (cudaStream_t)stream>>>(
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
  int blocks = 0;
  const cudaError_t err =
      persistent_grid(density_fwd_kernel, DEN_SMEM, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  density_fwd_kernel<<<blocks, kFwdThreads, DEN_SMEM, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)w0, (const float*)w1,
      (float*)out, n);
  return (int)cudaGetLastError();
}
