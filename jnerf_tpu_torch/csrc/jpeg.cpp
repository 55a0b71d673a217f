// JPEG decoder and encoder with libjpeg's integer arithmetic, so that a
// machine without imageio, PIL or cv2 reads and writes the same pixels as
// they do (libjpeg-turbo at its defaults).
//
// Decoder: baseline and extended sequential Huffman (SOF0, SOF1) and
// progressive Huffman (SOF2), 8-bit, 1 or 3 components, integral sampling
// factors, DRI/RSTn; the ISLOW inverse DCT (jidctint.c), "fancy"
// upsampling (jdsample.c) and the YCbCr -> RGB tables (jdcolor.c).  The
// colour space follows jdapimin.c: JFIF means YCbCr, else an Adobe APP14
// transform flag, else the component ids.  Arithmetic coding, lossless,
// hierarchical, 12-bit and 2- or 4-component images are refused.
//
// Encoder: what libjpeg writes under jpeg_set_defaults and
// jpeg_set_quality(q, force_baseline): JFIF APP0, the Annex K tables
// scaled by quality (jcparam.c), standard Huffman tables, RGB -> YCbCr
// (jccolor.c), 2x2 chroma (jcsample.c h2v2_downsample), the ISLOW forward
// DCT (jfdctint.c) and libjpeg-turbo's reciprocal quantizer (jcdctmgr.c).
//
// Plain C interface for ctypes; errors return nonzero with a message.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // Guard entries: a corrupt run past 63 lands on 63, as in libjpeg.
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

inline int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// ------------------------------------------------------------- IDCT
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// libjpeg's post-IDCT range limit: the 10-bit wrapped value + 128, clamped.
inline uint8_t idct_limit(int64_t v) {
  int i = int(v & 1023);
  if (i < 128) return uint8_t(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return uint8_t(i - 896);
}

// jidctint.c jpeg_idct_islow: coef in natural order, q the quant table in
// natural order; writes 8x8 samples at out with row stride `stride`.
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = int64_t(in[16]) * qp[16];
    z3 = int64_t(in[48]) * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qp[0];
    z3 = int64_t(in[32]) * qp[32];
    tmp0 = (z2 + z3) * (1 << CONST_BITS);
    tmp1 = (z2 - z3) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qp[56];
    tmp1 = int64_t(in[40]) * qp[40];
    tmp2 = int64_t(in[24]) * qp[24];
    tmp3 = int64_t(in[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS - PASS1_BITS;
    ws[c + 0] = descale(tmp10 + tmp3, s);
    ws[c + 56] = descale(tmp10 - tmp3, s);
    ws[c + 8] = descale(tmp11 + tmp2, s);
    ws[c + 48] = descale(tmp11 - tmp2, s);
    ws[c + 16] = descale(tmp12 + tmp1, s);
    ws[c + 40] = descale(tmp12 - tmp1, s);
    ws[c + 24] = descale(tmp13 + tmp0, s);
    ws[c + 32] = descale(tmp13 - tmp0, s);
  }
  for (int r = 0; r < 8; r++) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12, tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * (-FIX_1_847759065);
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int s = CONST_BITS + PASS1_BITS + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, s));
    o[7] = idct_limit(descale(tmp10 - tmp3, s));
    o[1] = idct_limit(descale(tmp11 + tmp2, s));
    o[6] = idct_limit(descale(tmp11 - tmp2, s));
    o[2] = idct_limit(descale(tmp12 + tmp1, s));
    o[5] = idct_limit(descale(tmp12 - tmp1, s));
    o[3] = idct_limit(descale(tmp13 + tmp0, s));
    o[4] = idct_limit(descale(tmp13 - tmp0, s));
  }
}

// ------------------------------------------------------------ decoder
struct Huffman {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[17];
  // 9-bit lookahead: (length << 8) | symbol, 0 where the code is longer.
  uint16_t look[512];

  void build() {
    int code = 0, k = 0;
    int huffsize[257], huffcode[257];
    for (int l = 1; l <= 16; l++)
      for (int i = 0; i < bits[l]; i++) huffsize[k++] = l;
    huffsize[k] = 0;
    int n = k;
    k = 0;
    int si = huffsize[0];
    while (huffsize[k]) {
      while (huffsize[k] == si) huffcode[k++] = code++;
      if (code >= (1 << si)) fail("bad Huffman table");
      code <<= 1;
      si++;
    }
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    memset(look, 0, sizeof(look));
    for (int i = 0; i < n; i++) {
      int l = huffsize[i];
      if (l > 9) continue;
      int base = huffcode[i] << (9 - l);
      for (int j = 0; j < (1 << (9 - l)); j++) look[base + j] = uint16_t((l << 8) | vals[i]);
    }
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;  // coefficient blocks per row / column (MCU-padded)
  int dw = 0, dh = 0;  // downsampled width / height in samples
  int pred = 0;
  std::vector<int16_t> coef;
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}
  size_t pos() const { return pos_; }
  void reset() {
    acc_ = 0;
    nbits_ = 0;
  }
  inline void fill(int need) {
    while (nbits_ < need) {
      uint32_t byte = 0;
      if (!marker_ && pos_ < n_) {
        byte = d_[pos_];
        if (byte == 0xFF) {
          uint8_t next = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
          if (next == 0x00) {
            pos_ += 2;
          } else {
            marker_ = true;  // feed zeros from here, as libjpeg does
            byte = 0;
          }
        } else {
          pos_++;
        }
      }
      acc_ |= uint64_t(byte) << (56 - nbits_);
      nbits_ += 8;
    }
  }
  inline int get(int n) {
    if (n == 0) return 0;
    fill(n);
    int v = int(acc_ >> (64 - n));
    acc_ <<= n;
    nbits_ -= n;
    return v;
  }
  inline int bit() { return get(1); }
  inline int decode(const Huffman& t) {
    fill(16);
    int e = t.look[acc_ >> (64 - 9)];
    if (e) {
      int l = e >> 8;
      acc_ <<= l;
      nbits_ -= l;
      return e & 0xFF;
    }
    int l = 10;
    int code = int(acc_ >> (64 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = int(acc_ >> (64 - l));
    }
    if (l > 16) {  // corrupt data: libjpeg warns and returns 0
      acc_ <<= 16;
      nbits_ -= 16;
      return 0;
    }
    acc_ <<= l;
    nbits_ -= l;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // Skip to the next RSTn marker and past it; clears the bit buffer.
  void restart() {
    reset();
    marker_ = false;
    while (pos_ + 1 < n_) {
      if (d_[pos_] == 0xFF && d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) {
        pos_ += 2;
        return;
      }
      if (d_[pos_] == 0xFF && d_[pos_ + 1] != 0x00 && d_[pos_ + 1] != 0xFF) return;
      pos_++;
    }
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool marker_ = false;
};

inline int extend(int v, int s) { return s == 0 ? 0 : (v < (1 << (s - 1)) ? v - (1 << s) + 1 : v); }

const char* sof_name(int m) {
  switch (m) {
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
    default: return "SOF";
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  std::vector<uint8_t> run(int* H, int* W, int* C) {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos_ = 2;
    bool frame = false, done = false;
    while (!done) {
      int m = next_marker();
      if (m < 0) {
        if (!frame || !scanned_) fail("JPEG file ends before its image data");
        break;  // libjpeg accepts a missing EOI after the scans
      }
      if (m == 0xD9) break;
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
      if (m == 0x01) continue;               // TEM
      size_t len = seg_len();
      const uint8_t* p = d_ + pos_ + 2;
      size_t body = len - 2;
      switch (m) {
        case 0xC0: case 0xC1: case 0xC2:
          if (frame) fail("JPEG with two frames");
          read_sof(p, body, m == 0xC2);
          frame = true;
          break;
        case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA: case 0xCB:
        case 0xCD: case 0xCE: case 0xCF: {
          char buf[160];
          snprintf(buf, sizeof buf, "unsupported JPEG: marker 0xFF%02X, %s", m, sof_name(m));
          fail(buf);
        }
        case 0xCC: fail("unsupported JPEG: marker 0xFFCC, DAC (arithmetic coding)");
        case 0xC4: read_dht(p, body); break;
        case 0xDB: read_dqt(p, body); break;
        case 0xDD:
          if (body < 2) fail("bad DRI segment");
          restart_interval_ = (p[0] << 8) | p[1];
          break;
        case 0xDA:
          if (!frame) fail("JPEG scan before its frame header");
          pos_ += len;
          read_sos_and_decode(p, body);
          continue;  // pos_ moved by the scan
        case 0xE0:
          if (body >= 14 && memcmp(p, "JFIF\0", 5) == 0) saw_jfif_ = true;
          break;
        case 0xEE:
          if (body >= 12 && memcmp(p, "Adobe", 5) == 0) {
            saw_adobe_ = true;
            adobe_transform_ = p[11];
          }
          break;
        case 0xDC: break;  // DNL: the frame header's height is used
        default: break;    // APPn, COM and others: skipped
      }
      pos_ += len;
    }
    return finish(H, W, C);
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int H_ = 0, W_ = 0, hmax_ = 1, vmax_ = 1, mcux_ = 0, mcuy_ = 0;
  bool progressive_ = false, scanned_ = false;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  int eobrun_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64];
  bool qt_defined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];

  int next_marker() {
    // Skip anything up to 0xFF, then fill bytes.
    while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) return -1;
    return d_[pos_++];
  }
  size_t seg_len() {
    if (pos_ + 2 > n_) fail("JPEG file truncated in a marker segment");
    size_t len = (size_t(d_[pos_]) << 8) | d_[pos_ + 1];
    if (len < 2 || pos_ + len > n_) fail("JPEG marker segment runs past the file");
    return len;
  }

  void read_sof(const uint8_t* p, size_t n, bool progressive) {
    if (n < 6) fail("bad SOF segment");
    if (p[0] != 8) {
      char buf[128];
      snprintf(buf, sizeof buf, "unsupported JPEG: %d-bit samples in the SOF marker (8-bit only)", p[0]);
      fail(buf);
    }
    H_ = (p[1] << 8) | p[2];
    W_ = (p[3] << 8) | p[4];
    int nc = p[5];
    if (H_ == 0 || W_ == 0) fail("JPEG frame of zero size (DNL height is not supported)");
    if (nc != 1 && nc != 3) {
      char buf[128];
      snprintf(buf, sizeof buf, "unsupported JPEG: %d components in the SOF marker (1 or 3 only%s)",
               nc, nc == 4 ? "; CMYK/YCCK is not read" : "");
      fail(buf);
    }
    if (n < size_t(6 + 3 * nc)) fail("bad SOF segment");
    progressive_ = progressive;
    comps_.resize(nc);
    for (int i = 0; i < nc; i++) {
      Component& c = comps_[i];
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bad sampling factors in the SOF marker");
      hmax_ = std::max(hmax_, c.h);
      vmax_ = std::max(vmax_, c.v);
    }
    mcux_ = (W_ + 8 * hmax_ - 1) / (8 * hmax_);
    mcuy_ = (H_ + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      if (hmax_ % c.h || vmax_ % c.v) fail("unsupported JPEG: fractional sampling factors");
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.dw = int((int64_t(W_) * c.h + hmax_ - 1) / hmax_);
      c.dh = int((int64_t(H_) * c.v + vmax_ - 1) / vmax_);
      c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
    }
  }

  void read_dht(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3 || i + 17 > n) fail("bad DHT segment");
      Huffman& t = tc ? ac_[th] : dc_[th];
      int total = 0;
      for (int l = 1; l <= 16; l++) {
        t.bits[l] = p[i + l];
        total += t.bits[l];
      }
      if (total > 256 || i + 17 + total > n) fail("bad DHT segment");
      memcpy(t.vals, p + i + 17, total);
      t.build();
      i += 17 + total;
    }
  }

  void read_dqt(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      if (tq > 3 || pq > 1) fail("bad DQT segment");
      i++;
      for (int k = 0; k < 64; k++) {
        if (i + (pq ? 2 : 1) > n) fail("bad DQT segment");
        int v = pq ? ((p[i] << 8) | p[i + 1]) : p[i];
        i += pq ? 2 : 1;
        qt_[tq][kNatural[k]] = uint16_t(v);
      }
      qt_defined_[tq] = true;
    }
  }

  void read_sos_and_decode(const uint8_t* p, size_t n) {
    if (n < 1) fail("bad SOS segment");
    int ns = p[0];
    if (ns < 1 || ns > 4 || n < size_t(4 + 2 * ns)) fail("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int cid = p[1 + 2 * i];
      Component* c = nullptr;
      for (Component& cc : comps_)
        if (cc.id == cid) c = &cc;
      if (!c) fail("SOS names a component the frame lacks");
      c->td = p[2 + 2 * i] >> 4;
      c->ta = p[2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3) fail("bad Huffman table number in SOS");
      sc.push_back(c);
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns];
    int ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
    if (!progressive_) {
      ss = 0;
      se = 63;
      ah = al = 0;
    } else if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ns != 1) || al > 13) {
      fail("bad progressive scan parameters");
    }
    for (Component* c : sc) {
      if (ss == 0 && !(progressive_ && ah) && !dc_[c->td].defined) fail("JPEG scan uses an undefined DC Huffman table");
      if (se > 0 && !ac_[c->ta].defined) fail("JPEG scan uses an undefined AC Huffman table");
      c->pred = 0;
    }
    eobrun_ = 0;
    BitReader br(d_, n_, pos_);
    // MCU geometry of this scan.
    int nx, ny;
    if (ns == 1) {
      nx = (sc[0]->dw + 7) / 8;
      ny = (sc[0]->dh + 7) / 8;
    } else {
      nx = mcux_;
      ny = mcuy_;
    }
    int todo = restart_interval_;
    for (int my = 0; my < ny; my++) {
      for (int mx = 0; mx < nx; mx++) {
        if (restart_interval_) {
          if (todo == 0) {
            br.restart();
            for (Component* c : sc) c->pred = 0;
            eobrun_ = 0;
            todo = restart_interval_;
          }
          todo--;
        }
        if (ns == 1) {
          Component* c = sc[0];
          decode_block(br, *c, &c->coef[(size_t(my) * c->bw + mx) * 64], ss, se, ah, al);
        } else {
          for (Component* c : sc)
            for (int by = 0; by < c->v; by++)
              for (int bx = 0; bx < c->h; bx++) {
                size_t b = size_t(my * c->v + by) * c->bw + (mx * c->h + bx);
                decode_block(br, *c, &c->coef[b * 64], ss, se, ah, al);
              }
        }
      }
    }
    scanned_ = true;
    pos_ = br.pos();
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk, int ss, int se, int ah, int al) {
    if (!progressive_) {
      int s = br.decode(dc_[c.td]);
      int diff = s ? extend(br.get(s), s) : 0;
      c.pred += diff;
      blk[0] = int16_t(c.pred);
      const Huffman& ac = ac_[c.ta];
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scan
      if (ah == 0) {
        int s = br.decode(dc_[c.td]);
        int diff = s ? extend(br.get(s), s) : 0;
        c.pred += diff;
        blk[0] = int16_t(c.pred * (1 << al));
      } else if (br.bit()) {
        blk[0] = int16_t(blk[0] | (1 << al));
      }
      return;
    }
    const Huffman& ac = ac_[c.ta];
    if (ah == 0) {  // AC first
      if (eobrun_ > 0) {
        eobrun_--;
        return;
      }
      for (int k = ss; k <= se; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(extend(br.get(s), s) * (1 << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get(r);
          eobrun_--;
          break;
        }
      }
      return;
    }
    // AC refine (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int k = ss;
    if (eobrun_ == 0) {
      for (; k <= se; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.bit() && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && br.bit() && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      eobrun_--;
    }
  }

  // Upsample one component's plane [bh*8, bw*8] to the image, as
  // jdsample.c does (fancy where libjpeg uses it, else replication).
  void upsample(const Component& c, const std::vector<uint8_t>& plane, std::vector<uint8_t>& out) {
    int stride = c.bw * 8;
    int hx = hmax_ / c.h, vy = vmax_ / c.v;
    out.assign(size_t(H_) * W_, 0);
    auto at = [&](int y, int x) -> int { return plane[size_t(y) * stride + x]; };
    auto row_clamp = [&](int y) { return y < 0 ? 0 : (y >= c.dh ? c.dh - 1 : y); };
    if (hx == 1 && vy == 1) {
      for (int y = 0; y < H_; y++) memcpy(&out[size_t(y) * W_], &plane[size_t(y) * stride], W_);
    } else if (hx == 2 && vy == 1 && c.dw > 2) {  // h2v1_fancy_upsample
      std::vector<uint8_t> row(size_t(c.dw) * 2);
      for (int y = 0; y < H_; y++) {
        int in0 = at(y, 0);
        row[0] = uint8_t(in0);
        row[1] = uint8_t((in0 * 3 + at(y, 1) + 2) >> 2);
        for (int x = 1; x < c.dw - 1; x++) {
          int v = at(y, x) * 3;
          row[2 * x] = uint8_t((v + at(y, x - 1) + 1) >> 2);
          row[2 * x + 1] = uint8_t((v + at(y, x + 1) + 2) >> 2);
        }
        int last = at(y, c.dw - 1);
        row[2 * c.dw - 2] = uint8_t((last * 3 + at(y, c.dw - 2) + 1) >> 2);
        row[2 * c.dw - 1] = uint8_t(last);
        memcpy(&out[size_t(y) * W_], row.data(), W_);
      }
    } else if (hx == 2 && vy == 2 && c.dw > 2) {  // h2v2_fancy_upsample
      std::vector<int> colsum(c.dw);
      std::vector<uint8_t> row(size_t(c.dw) * 2);
      for (int y = 0; y < H_; y++) {
        int inrow = y >> 1;
        int other = row_clamp((y & 1) ? inrow + 1 : inrow - 1);
        for (int x = 0; x < c.dw; x++) colsum[x] = at(inrow, x) * 3 + at(other, x);
        int n = c.dw;
        row[0] = uint8_t((colsum[0] * 4 + 8) >> 4);
        row[1] = uint8_t((colsum[0] * 3 + colsum[1] + 7) >> 4);
        for (int x = 1; x < n - 1; x++) {
          row[2 * x] = uint8_t((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
          row[2 * x + 1] = uint8_t((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
        }
        row[2 * n - 2] = uint8_t((colsum[n - 1] * 3 + colsum[n - 2] + 8) >> 4);
        row[2 * n - 1] = uint8_t((colsum[n - 1] * 4 + 7) >> 4);
        memcpy(&out[size_t(y) * W_], row.data(), W_);
      }
    } else if (hx == 1 && vy == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H_; y++) {
        int inrow = y >> 1;
        bool below = y & 1;
        int other = row_clamp(below ? inrow + 1 : inrow - 1);
        int bias = below ? 2 : 1;
        uint8_t* o = &out[size_t(y) * W_];
        for (int x = 0; x < W_; x++) o[x] = uint8_t((at(inrow, x) * 3 + at(other, x) + bias) >> 2);
      }
    } else {  // int_upsample / h2v1_upsample / h2v2_upsample: replication
      for (int y = 0; y < H_; y++) {
        uint8_t* o = &out[size_t(y) * W_];
        int sy = y / vy;
        for (int x = 0; x < W_; x++) o[x] = uint8_t(at(sy, x / hx));
      }
    }
  }

  std::vector<uint8_t> finish(int* H, int* W, int* C) {
    int nc = int(comps_.size());
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ci++) {
      Component& c = comps_[ci];
      if (!qt_defined_[c.tq]) fail("JPEG component uses an undefined quantization table");
      int stride = c.bw * 8;
      std::vector<uint8_t> plane(size_t(stride) * c.bh * 8);
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(&c.coef[(size_t(by) * c.bw + bx) * 64], qt_[c.tq],
                     &plane[size_t(by) * 8 * stride + bx * 8], stride);
      std::vector<int16_t>().swap(c.coef);
      upsample(c, plane, full[ci]);
    }
    *H = H_;
    *W = W_;
    *C = nc;
    if (nc == 1) return full[0];
    bool rgb;
    if (saw_jfif_) {
      rgb = false;
    } else if (saw_adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }
    size_t npx = size_t(H_) * W_;
    std::vector<uint8_t> out(npx * 3);
    if (rgb) {
      for (size_t i = 0; i < npx; i++)
        for (int k = 0; k < 3; k++) out[3 * i + k] = full[k][i];
      return out;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16.
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    const int64_t one_half = int64_t(1) << 15;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + one_half) >> 16);
      cb_b[i] = int((fix(1.77200) * x + one_half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + one_half;
    }
    for (size_t i = 0; i < npx; i++) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      out[3 * i] = uint8_t(clamp255(y + cr_r[cr]));
      out[3 * i + 1] = uint8_t(clamp255(y + int((cb_g[cb] + cr_g[cr]) >> 16)));
      out[3 * i + 2] = uint8_t(clamp255(y + cb_b[cb]));
    }
    return out;
  }
};

// ------------------------------------------------------------ encoder
const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// Canonical Huffman codes (code, length) by symbol, from BITS and HUFFVAL.
struct EncTable {
  uint16_t code[256];
  uint8_t size[256];
  EncTable(const uint8_t* b, const uint8_t* v) {
    memset(size, 0, sizeof size);
    int code_ = 0, k = 0;
    for (int l = 1; l <= 16; l++) {
      for (int i = 0; i < b[l]; i++, k++) {
        code[v[k]] = uint16_t(code_++);
        size[v[k]] = uint8_t(l);
      }
      code_ <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  inline void put(uint32_t bits, int n) {
    acc_ = (acc_ << n) | (bits & ((uint64_t(1) << n) - 1));
    nbits_ += n;
    while (nbits_ >= 8) {
      uint8_t byte = uint8_t(acc_ >> (nbits_ - 8));
      out_.push_back(byte);
      if (byte == 0xFF) out_.push_back(0);
      nbits_ -= 8;
    }
  }
  void flush() {  // pad with 1 bits (jchuff.c flush_bits)
    if (nbits_ > 0) put(0x7F, 8 - nbits_);
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int nbits_ = 0;
};

// jfdctint.c jpeg_fdct_islow on samples - 128, in place (natural order).
void fdct_islow(int32_t* data) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7, tmp10, tmp11, tmp12, tmp13;
  int64_t z1, z2, z3, z4, z5;
  for (int r = 0; r < 8; r++) {
    int32_t* d = data + 8 * r;
    tmp0 = d[0] + d[7];
    tmp7 = d[0] - d[7];
    tmp1 = d[1] + d[6];
    tmp6 = d[1] - d[6];
    tmp2 = d[2] + d[5];
    tmp5 = d[2] - d[5];
    tmp3 = d[3] + d[4];
    tmp4 = d[3] - d[4];
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    d[0] = int32_t((tmp10 + tmp11) * (1 << PASS1_BITS));
    d[4] = int32_t((tmp10 - tmp11) * (1 << PASS1_BITS));
    z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[2] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS));
    d[6] = int32_t(descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS - PASS1_BITS));
    z1 = tmp4 + tmp7;
    z2 = tmp5 + tmp6;
    z3 = tmp4 + tmp6;
    z4 = tmp5 + tmp7;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    d[7] = int32_t(descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS));
    d[5] = int32_t(descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS));
    d[3] = int32_t(descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS));
    d[1] = int32_t(descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS));
  }
  for (int c = 0; c < 8; c++) {
    int32_t* d = data + c;
    tmp0 = d[0] + d[56];
    tmp7 = d[0] - d[56];
    tmp1 = d[8] + d[48];
    tmp6 = d[8] - d[48];
    tmp2 = d[16] + d[40];
    tmp5 = d[16] - d[40];
    tmp3 = d[24] + d[32];
    tmp4 = d[24] - d[32];
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    d[0] = int32_t(descale(tmp10 + tmp11, PASS1_BITS));
    d[32] = int32_t(descale(tmp10 - tmp11, PASS1_BITS));
    z1 = (tmp12 + tmp13) * FIX_0_541196100;
    d[16] = int32_t(descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS));
    d[48] = int32_t(descale(z1 + tmp12 * (-FIX_1_847759065), CONST_BITS + PASS1_BITS));
    z1 = tmp4 + tmp7;
    z2 = tmp5 + tmp6;
    z3 = tmp4 + tmp6;
    z4 = tmp5 + tmp7;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    d[56] = int32_t(descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS));
    d[40] = int32_t(descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS));
    d[24] = int32_t(descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS));
    d[8] = int32_t(descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS));
  }
}

// jcdctmgr.c compute_reciprocal (16-bit DCTELEM): reciprocal, correction, shift.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (uint32_t(1) << r) / divisor;
  uint32_t fr = (uint32_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2) {
    c++;
  } else {
    fq++;
  }
  return {fq, c, r};
}

inline int16_t quantize(int32_t v, const Divisor& d) {
  uint32_t t = uint32_t(v < 0 ? -v : v);
  uint32_t q = uint32_t((uint64_t(t + d.corr) * d.recip) >> d.shift);
  return int16_t(v < 0 ? -int32_t(q) : int32_t(q));
}

void quant_table(const uint8_t* base, int quality, uint16_t* out) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; i++) {
    long t = (long(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;  // force_baseline
    out[i] = uint16_t(t);
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v));
}

struct EncComp {
  int id, h, v, tq, tbl;
  int bw, bh;   // blocks per row / column, MCU-padded
  int wib, hib; // real blocks (width_in_blocks, height_in_blocks)
  std::vector<uint8_t> plane;  // [bh*8, bw*8] samples, edges replicated
};

std::vector<uint8_t> encode(const uint8_t* px, int H, int W, int C, int quality) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) fail("JPEG size out of range");
  if (C != 1 && C != 3) fail("the JPEG encoder takes 1 or 3 channels");
  uint16_t q[2][64];
  quant_table(kStdLumaQ, quality, q[0]);
  quant_table(kStdChromaQ, quality, q[1]);
  int hmax = C == 3 ? 2 : 1, vmax = hmax;
  int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);
  std::vector<EncComp> comps;
  if (C == 1) {
    comps.push_back({1, 1, 1, 0, 0, 0, 0, 0, 0, {}});
  } else {
    comps.push_back({1, 2, 2, 0, 0, 0, 0, 0, 0, {}});
    comps.push_back({2, 1, 1, 1, 1, 0, 0, 0, 0, {}});
    comps.push_back({3, 1, 1, 1, 1, 0, 0, 0, 0, {}});
  }
  // Colour conversion (jccolor.c rgb_ycc_convert).
  size_t npx = size_t(H) * W;
  std::vector<std::vector<uint8_t>> full(C);
  if (C == 1) {
    full[0].assign(px, px + npx);
  } else {
    const int64_t one_half = int64_t(1) << 15, cbcr_off = int64_t(128) << 16;
    auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
    int64_t tab[8][256];
    for (int i = 0; i < 256; i++) {
      tab[0][i] = fix(0.29900) * i;
      tab[1][i] = fix(0.58700) * i;
      tab[2][i] = fix(0.11400) * i + one_half;
      tab[3][i] = -fix(0.16874) * i;
      tab[4][i] = -fix(0.33126) * i;
      tab[5][i] = fix(0.50000) * i + cbcr_off + one_half - 1;
      tab[6][i] = -fix(0.41869) * i;
      tab[7][i] = -fix(0.08131) * i;
    }
    for (int k = 0; k < 3; k++) full[k].resize(npx);
    for (size_t i = 0; i < npx; i++) {
      int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = uint8_t((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      full[1][i] = uint8_t((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
      full[2][i] = uint8_t((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
    }
  }
  for (int ci = 0; ci < C; ci++) {
    EncComp& c = comps[ci];
    int dw = (W * c.h + hmax - 1) / hmax, dh = (H * c.v + vmax - 1) / vmax;
    c.wib = (dw + 7) / 8;
    c.hib = (dh + 7) / 8;
    c.bw = mcux * c.h;
    c.bh = mcuy * c.v;
    int pw = c.bw * 8, ph = c.bh * 8;
    c.plane.assign(size_t(pw) * ph, 0);
    const std::vector<uint8_t>& src = full[ci];
    if (c.h == hmax && c.v == vmax) {
      for (int y = 0; y < ph; y++) {
        int sy = y < H ? y : H - 1;
        for (int x = 0; x < pw; x++) c.plane[size_t(y) * pw + x] = src[size_t(sy) * W + (x < W ? x : W - 1)];
      }
    } else {  // jcsample.c h2v2_downsample of the edge-replicated image
      for (int y = 0; y < ph; y++) {
        int oy = y < dh ? y : dh - 1;
        int y0 = 2 * oy < H ? 2 * oy : H - 1, y1 = 2 * oy + 1 < H ? 2 * oy + 1 : H - 1;
        for (int x = 0; x < pw; x++) {
          int x0 = 2 * x < W ? 2 * x : W - 1, x1 = 2 * x + 1 < W ? 2 * x + 1 : W - 1;
          int bias = (x & 1) ? 2 : 1;
          c.plane[size_t(y) * pw + x] = uint8_t(
              (src[size_t(y0) * W + x0] + src[size_t(y0) * W + x1] + src[size_t(y1) * W + x0] +
               src[size_t(y1) * W + x1] + bias) >> 2);
        }
      }
    }
  }
  std::vector<uint8_t> o;
  o.reserve(npx / 2 + 1024);
  o.push_back(0xFF); o.push_back(0xD8);
  // JFIF APP0: version 1.01, aspect-ratio units, density 1:1, no thumbnail.
  const uint8_t app0[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01,
                          0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), app0, app0 + sizeof app0);
  int ntables = C == 3 ? 2 : 1;
  for (int t = 0; t < ntables; t++) {
    o.push_back(0xFF); o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    for (int k = 0; k < 64; k++) o.push_back(uint8_t(q[t][kNatural[k]]));
  }
  o.push_back(0xFF); o.push_back(0xC0);
  put16(o, 8 + 3 * C);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(uint8_t(C));
  for (const EncComp& c : comps) {
    o.push_back(uint8_t(c.id));
    o.push_back(uint8_t((c.h << 4) | c.v));
    o.push_back(uint8_t(c.tq));
  }
  const uint8_t* dcbits[2] = {kDcLumaBits, kDcChromaBits};
  const uint8_t* acbits[2] = {kAcLumaBits, kAcChromaBits};
  const uint8_t* acvals[2] = {kAcLumaVals, kAcChromaVals};
  for (int t = 0; t < ntables; t++) {
    for (int ac = 0; ac < 2; ac++) {
      const uint8_t* bits = ac ? acbits[t] : dcbits[t];
      const uint8_t* vals = ac ? acvals[t] : kDcVals;
      int n = 0;
      for (int l = 1; l <= 16; l++) n += bits[l];
      o.push_back(0xFF); o.push_back(0xC4);
      put16(o, 2 + 1 + 16 + n);
      o.push_back(uint8_t((ac << 4) | t));
      for (int l = 1; l <= 16; l++) o.push_back(bits[l]);
      o.insert(o.end(), vals, vals + n);
    }
  }
  o.push_back(0xFF); o.push_back(0xDA);
  put16(o, 6 + 2 * C);
  o.push_back(uint8_t(C));
  for (const EncComp& c : comps) {
    o.push_back(uint8_t(c.id));
    o.push_back(uint8_t((c.tbl << 4) | c.tbl));
  }
  o.push_back(0); o.push_back(63); o.push_back(0);

  EncTable dc_t[2] = {EncTable(kDcLumaBits, kDcVals), EncTable(kDcChromaBits, kDcVals)};
  EncTable ac_t[2] = {EncTable(kAcLumaBits, kAcLumaVals), EncTable(kAcChromaBits, kAcChromaVals)};
  Divisor div[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) div[t][i] = reciprocal(uint32_t(q[t][i]) << 3);
  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  int32_t ws[64];
  int16_t mcu[4][64];
  auto emit = [&](const EncComp& c, int ci, const int16_t* blk) {
    const EncTable& dct = dc_t[c.tbl];
    const EncTable& act = ac_t[c.tbl];
    int diff = blk[0] - last_dc[ci];
    last_dc[ci] = blk[0];
    int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff;
    int nbits = t ? 32 - __builtin_clz(uint32_t(t)) : 0;
    bw.put(dct.code[nbits], dct.size[nbits]);
    if (nbits) bw.put(uint32_t(t2), nbits);
    int run = 0;
    for (int k = 1; k < 64; k++) {
      int v = blk[kNatural[k]];
      if (v == 0) {
        run++;
        continue;
      }
      while (run > 15) {
        bw.put(act.code[0xF0], act.size[0xF0]);
        run -= 16;
      }
      int a = v < 0 ? -v : v, a2 = v < 0 ? v - 1 : v;
      nbits = 32 - __builtin_clz(uint32_t(a));
      int sym = (run << 4) | nbits;
      bw.put(act.code[sym], act.size[sym]);
      bw.put(uint32_t(a2), nbits);
      run = 0;
    }
    if (run > 0) bw.put(act.code[0], act.size[0]);
  };
  for (int my = 0; my < mcuy; my++) {
    for (int mx = 0; mx < mcux; mx++) {
      for (int ci = 0; ci < C; ci++) {
        const EncComp& c = comps[ci];
        int pw = c.bw * 8;
        int n = 0;
        for (int by = 0; by < c.v; by++) {
          int row = my * c.v + by;
          for (int bx = 0; bx < c.h; bx++, n++) {
            int col = mx * c.h + bx;
            int16_t* blk = mcu[n];
            if (row < c.hib && col < c.wib) {
              const uint8_t* src = &c.plane[size_t(row) * 8 * pw + col * 8];
              for (int y = 0; y < 8; y++)
                for (int x = 0; x < 8; x++) ws[8 * y + x] = int32_t(src[size_t(y) * pw + x]) - 128;
              fdct_islow(ws);
              for (int i = 0; i < 64; i++) blk[i] = quantize(ws[i], div[c.tq][i]);
            } else {
              // jccoefct.c dummy blocks: zero AC, the DC of the block before.
              memset(blk, 0, 64 * sizeof(int16_t));
              blk[0] = row < c.hib ? mcu[n - 1][0] : mcu[by * c.h - 1][0];
            }
          }
        }
        for (int b = 0; b < n; b++) emit(c, ci, mcu[b]);
      }
    }
  }
  bw.flush();
  o.push_back(0xFF); o.push_back(0xD9);
  return o;
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) snprintf(err, size_t(errlen), "%s", msg.c_str());
}

uint8_t* to_heap(const std::vector<uint8_t>& v) {
  uint8_t* p = static_cast<uint8_t*>(malloc(v.size() ? v.size() : 1));
  if (p && !v.empty()) memcpy(p, v.data(), v.size());
  return p;
}

}  // namespace

extern "C" {

// JPEG bytes -> *out (malloc'ed uint8 [H, W, C], C = 1 or 3).
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t** out, int* h, int* w, int* c,
                char* err, int errlen) {
  try {
    Decoder dec(data, size_t(size));
    std::vector<uint8_t> px = dec.run(h, w, c);
    *out = to_heap(px);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 2;
  }
}

// uint8 [H, W, C] (C = 1 grey or 3 RGB) -> *out (malloc'ed JPEG bytes).
int jpeg_encode(const uint8_t* px, int h, int w, int c, int quality, uint8_t** out,
                int64_t* out_size, char* err, int errlen) {
  try {
    std::vector<uint8_t> bytes = encode(px, h, w, c, quality);
    *out = to_heap(bytes);
    *out_size = int64_t(bytes.size());
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return 2;
  }
}

void jpeg_free(void* p) { free(p); }

}  // extern "C"
