// MPEG-4 Part 2 Simple Profile video (the codec that the mp4v fourcc
// names), intra-only: every frame is an I-VOP at one fixed quantiser, with
// the H.263 quantisation method, the intra DC VLCs with adaptive DC
// prediction, no AC prediction, and every AC coefficient as a type-3
// escape (fixed-length last/run/level), which is legal for every
// coefficient and needs no run/level table.  Frames come in as RGB and go
// out as BT.601 limited-range 4:2:0, the planes padded to whole
// macroblocks by edge replication; the VOL states the true size.
//
// Plain C interface for ctypes: the VOS/VO/VOL headers (the esds
// decoder-specific info of an mp4v sample entry) and one VOP per frame.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// (code, length): Table B-13 dct_dc_size_luminance, B-14 chrominance.
const int kDcLum[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3}, {1, 4}, {1, 5},
                           {1, 6}, {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}};
const int kDcChrom[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6},
                             {1, 7}, {1, 8}, {1, 9}, {1, 10}, {1, 11}, {1, 12}};
// Table B-6, I-VOP mcbpc for MB type 3 by cbpc; Table B-8 cbpy (intra).
const int kMcbpcIntra[4][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}};
const int kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4}, {2, 6}, {11, 4},
                          {2, 5}, {3, 6}, {5, 4}, {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};

class BitWriter {
 public:
  std::vector<uint8_t> out;
  void put(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; i--) {
      acc_ = uint8_t((acc_ << 1) | ((v >> i) & 1));
      if (++nbits_ == 8) {
        out.push_back(acc_);
        acc_ = 0;
        nbits_ = 0;
      }
    }
  }
  void start_code(uint32_t code) {  // 0x000001xx
    put(0, 16);
    put(code, 16);
  }
  // next_start_code(): a zero bit, then ones to the byte boundary.
  void stuffing() {
    int n = 8 - nbits_;
    put((1u << (n - 1)) - 1, n);
  }

 private:
  uint8_t acc_ = 0;
  int nbits_ = 0;
};

int time_bits(int resolution) {
  int bits = 1;
  while ((1 << bits) < resolution) bits++;
  return bits;
}

void write_headers(BitWriter& bw, int w, int h, int fps) {
  bw.start_code(0x1B0);  // visual_object_sequence
  bw.put(0x01, 8);       // Simple Profile, level 1
  bw.start_code(0x1B5);  // visual_object
  bw.put(1, 1);          // is_visual_object_identifier
  bw.put(1, 4);          // visual_object_verid
  bw.put(1, 3);          // visual_object_priority
  bw.put(1, 4);          // visual_object_type: video
  bw.put(0, 1);          // video_signal_type
  bw.stuffing();
  bw.start_code(0x100);  // video_object 0
  bw.start_code(0x120);  // video_object_layer 0
  bw.put(1, 1);          // random_accessible_vol: every VOP is intra
  bw.put(1, 8);          // video_object_type_indication: Simple Object
  bw.put(1, 1);          // is_object_layer_identifier
  bw.put(1, 4);          // video_object_layer_verid
  bw.put(1, 3);          // video_object_layer_priority
  bw.put(1, 4);          // aspect_ratio_info: square pixels
  bw.put(1, 1);          // vol_control_parameters
  bw.put(1, 2);          // chroma_format 4:2:0
  bw.put(1, 1);          // low_delay
  bw.put(0, 1);          // vbv_parameters
  bw.put(0, 2);          // video_object_layer_shape: rectangular
  bw.put(1, 1);
  bw.put(uint32_t(fps), 16);  // vop_time_increment_resolution
  bw.put(1, 1);
  bw.put(1, 1);          // fixed_vop_rate
  bw.put(1, uint32_t(time_bits(fps)));  // fixed_vop_time_increment
  bw.put(1, 1);
  bw.put(uint32_t(w), 13);
  bw.put(1, 1);
  bw.put(uint32_t(h), 13);
  bw.put(1, 1);
  bw.put(0, 1);          // interlaced
  bw.put(1, 1);          // obmc_disable
  bw.put(0, 1);          // sprite_enable
  bw.put(0, 1);          // not_8_bit
  bw.put(0, 1);          // quant_type: H.263
  bw.put(1, 1);          // complexity_estimation_disable
  bw.put(1, 1);          // resync_marker_disable
  bw.put(0, 1);          // data_partitioned
  bw.put(0, 1);          // scalability
  bw.stuffing();
}

int dc_scaler(int qp, bool luma) {  // Table 7-1, nonlinear
  if (qp <= 4) return 8;
  if (luma) return qp <= 8 ? 2 * qp : (qp <= 24 ? qp + 8 : 2 * qp - 16);
  return qp <= 24 ? (qp + 13) / 2 : qp - 6;
}

struct Dct {
  double c[8][8];  // c[u][x] = C(u)/2 cos((2x+1) u pi / 16)
  Dct() {
    for (int u = 0; u < 8; u++)
      for (int x = 0; x < 8; x++)
        c[u][x] = (u == 0 ? std::sqrt(0.5) : 1.0) * 0.5 * std::cos((2 * x + 1) * u * M_PI / 16.0);
  }
  void forward(const double* in, double* out) const {
    double tmp[64];
    for (int y = 0; y < 8; y++)
      for (int u = 0; u < 8; u++) {
        double s = 0;
        for (int x = 0; x < 8; x++) s += c[u][x] * in[8 * y + x];
        tmp[8 * y + u] = s;
      }
    for (int v = 0; v < 8; v++)
      for (int u = 0; u < 8; u++) {
        double s = 0;
        for (int y = 0; y < 8; y++) s += c[v][y] * tmp[8 * y + u];
        out[8 * v + u] = s;
      }
  }
};

// DC predictor state for one plane of blocks: the reconstructed DC
// (level * dc_scaler) of every block, 1024 outside the VOP.
struct DcGrid {
  int bw, bh;
  std::vector<int> f;
  DcGrid(int w, int h) : bw(w), bh(h), f(size_t(w) * h, 0) {}
  int at(int x, int y) const { return (x < 0 || y < 0) ? 1024 : f[size_t(y) * bw + x]; }
};

void encode_block(BitWriter& bw, const int16_t* lv, bool luma, int dc_diff) {
  int size = 0;
  for (int a = dc_diff < 0 ? -dc_diff : dc_diff; a; a >>= 1) size++;
  const int* code = luma ? kDcLum[size] : kDcChrom[size];
  bw.put(uint32_t(code[0]), code[1]);
  if (size) {
    int v = dc_diff >= 0 ? dc_diff : dc_diff + (1 << size) - 1;
    bw.put(uint32_t(v), size);
    if (size > 8) bw.put(1, 1);  // marker_bit
  }
  int last_k = 0;
  for (int k = 1; k < 64; k++)
    if (lv[kZigzag[k]]) last_k = k;
  int run = 0;
  for (int k = 1; k <= last_k; k++) {
    int level = lv[kZigzag[k]];
    if (!level) {
      run++;
      continue;
    }
    bw.put(3, 7);  // escape
    bw.put(3, 2);  // type 3: fixed length
    bw.put(k == last_k ? 1 : 0, 1);
    bw.put(uint32_t(run), 6);
    bw.put(1, 1);
    bw.put(uint32_t(level) & 0xFFF, 12);
    bw.put(1, 1);
    run = 0;
  }
}

std::vector<uint8_t> encode_vop(const uint8_t* rgb, int w, int h, int fps, int64_t index, int qp) {
  int mbw = (w + 15) / 16, mbh = (h + 15) / 16;
  int yw = mbw * 16, yh = mbh * 16, cw = mbw * 8, ch = mbh * 8;
  std::vector<double> Y(size_t(yw) * yh), U(size_t(cw) * ch), V(size_t(cw) * ch);
  std::vector<int> u_full(size_t(yw) * yh), v_full(size_t(yw) * yh);
  for (int y = 0; y < yh; y++) {
    int sy = y < h ? y : h - 1;
    for (int x = 0; x < yw; x++) {
      const uint8_t* p = rgb + (size_t(sy) * w + (x < w ? x : w - 1)) * 3;
      int r = p[0], g = p[1], b = p[2];
      size_t i = size_t(y) * yw + x;
      Y[i] = ((66 * r + 129 * g + 25 * b + 128) >> 8) + 16;
      u_full[i] = ((-38 * r - 74 * g + 112 * b + 128) >> 8) + 128;
      v_full[i] = ((112 * r - 94 * g - 18 * b + 128) >> 8) + 128;
    }
  }
  for (int y = 0; y < ch; y++)
    for (int x = 0; x < cw; x++) {
      size_t a = size_t(2 * y) * yw + 2 * x, b = a + yw;
      U[size_t(y) * cw + x] = (u_full[a] + u_full[a + 1] + u_full[b] + u_full[b + 1] + 2) / 4;
      V[size_t(y) * cw + x] = (v_full[a] + v_full[a + 1] + v_full[b] + v_full[b + 1] + 2) / 4;
    }

  BitWriter bw;
  bw.start_code(0x1B6);  // vop
  bw.put(0, 2);          // vop_coding_type: I
  int64_t secs = index / fps, prev = index > 0 ? (index - 1) / fps : 0;
  for (int64_t s = prev; s < secs; s++) bw.put(1, 1);  // modulo_time_base
  bw.put(0, 1);
  bw.put(1, 1);
  bw.put(uint32_t(index % fps), time_bits(fps));  // vop_time_increment
  bw.put(1, 1);
  bw.put(1, 1);  // vop_coded
  bw.put(0, 3);  // intra_dc_vlc_thr: DC VLCs everywhere
  bw.put(uint32_t(qp), 5);

  static const Dct dct;
  DcGrid gy(2 * mbw, 2 * mbh), gu(mbw, mbh), gv(mbw, mbh);
  int sc_l = dc_scaler(qp, true), sc_c = dc_scaler(qp, false);
  double in[64], F[64];
  int16_t lv[6][64];
  int dc_diff[6];
  for (int my = 0; my < mbh; my++) {
    for (int mx = 0; mx < mbw; mx++) {
      int cbp = 0;
      for (int b = 0; b < 6; b++) {
        bool luma = b < 4;
        const std::vector<double>& plane = luma ? Y : (b == 4 ? U : V);
        int stride = luma ? yw : cw;
        int bx = luma ? 2 * mx + (b & 1) : mx, by = luma ? 2 * my + (b >> 1) : my;
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++) in[8 * y + x] = plane[size_t(by * 8 + y) * stride + bx * 8 + x];
        dct.forward(in, F);
        int scaler = luma ? sc_l : sc_c;
        int dc = int((F[0] + scaler / 2.0) / scaler);
        if (dc < 1) dc = 1;
        if (dc > 254) dc = 254;
        DcGrid& g = luma ? gy : (b == 4 ? gu : gv);
        int fa = g.at(bx - 1, by), fb = g.at(bx - 1, by - 1), fc = g.at(bx, by - 1);
        int fp = std::abs(fa - fb) < std::abs(fb - fc) ? fc : fa;
        dc_diff[b] = dc - (fp + scaler / 2) / scaler;
        g.f[size_t(by) * g.bw + bx] = dc * scaler;
        bool coded = false;
        lv[b][0] = 0;
        for (int i = 1; i < 64; i++) {
          double a = std::fabs(F[i]);
          int l = a < 1.5 * qp ? 0 : int(a / (2 * qp));
          if (a >= 1.5 * qp && l < 1) l = 1;
          if (l > 2047) l = 2047;
          lv[b][i] = int16_t(F[i] < 0 ? -l : l);
          coded |= l != 0;
        }
        if (coded) cbp |= 1 << (5 - b);
      }
      const int* mc = kMcbpcIntra[cbp & 3];
      bw.put(uint32_t(mc[0]), mc[1]);
      bw.put(0, 1);  // ac_pred_flag
      const int* cy = kCbpy[cbp >> 2];
      bw.put(uint32_t(cy[0]), cy[1]);
      for (int b = 0; b < 6; b++) {
        if (cbp & (1 << (5 - b))) {
          encode_block(bw, lv[b], b < 4, dc_diff[b]);
        } else {
          int16_t zero[64] = {0};
          encode_block(bw, zero, b < 4, dc_diff[b]);
        }
      }
    }
  }
  bw.stuffing();
  return bw.out;
}

uint8_t* to_heap(const std::vector<uint8_t>& v, int64_t* size) {
  uint8_t* p = static_cast<uint8_t*>(malloc(v.size() ? v.size() : 1));
  if (p && !v.empty()) memcpy(p, v.data(), v.size());
  *size = int64_t(v.size());
  return p;
}

}  // namespace

extern "C" {

// The VOS, VO and VOL headers of a w x h stream at `fps` VOPs a second.
int mp4v_headers(int w, int h, int fps, uint8_t** out, int64_t* size) {
  if (w < 1 || h < 1 || w > 8191 || h > 8191 || fps < 1 || fps > 65535) return 1;
  BitWriter bw;
  write_headers(bw, w, h, fps);
  *out = to_heap(bw.out, size);
  return 0;
}

// One I-VOP of an RGB frame uint8 [h, w, 3], the `index`-th of the stream.
int mp4v_encode_vop(const uint8_t* rgb, int w, int h, int fps, int64_t index, int qp,
                    uint8_t** out, int64_t* size) {
  if (w < 1 || h < 1 || w > 8191 || h > 8191 || fps < 1 || qp < 1 || qp > 31 || index < 0)
    return 1;
  std::vector<uint8_t> vop = encode_vop(rgb, w, h, fps, index, qp);
  *out = to_heap(vop, size);
  return 0;
}

void mp4v_free(void* p) { free(p); }

}  // extern "C"
