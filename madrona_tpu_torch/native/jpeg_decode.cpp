// JPEG decoding to RGBA8 with libjpeg-turbo's arithmetic.
//
// The decoder behind madrona_tpu_torch/assets/jpeg.py. It takes baseline,
// extended-sequential (8-bit) and progressive Huffman files of 1, 3 or 4
// components with sampling factors of 1 or 2, and restart intervals, and
// gives the bytes that PIL's Image.open(...).convert("RGBA") gives through
// libjpeg-turbo (with its x86 SIMD routines) and Pillow's conversions:
//   * entropy decoding into per-component coefficient arrays (jdhuff.c,
//     jdphuff.c), every scan before any sample is made, as libjpeg does
//     for a multi-scan file before its first output row;
//   * block smoothing of a progressive file whose scans leave one of the
//     first nine coefficients short of its last bit (jdcoefct.c,
//     decompress_smooth_data, libjpeg-turbo 2.1's 5 x 5 window);
//   * the "islow" integer IDCT (jidctint.c), with the SIMD routine's
//     16-bit dequantisation and saturation in place of the C range table
//     (the two agree on every coefficient set a valid file carries);
//   * fancy upsampling (jdsample.c: h2v1, h1v2, h2v2 with their biases and
//     edge rows, box upsampling of a component 2 samples wide or less);
//   * YCbCr -> RGB and YCCK -> CMYK by the 16-fraction-bit tables of
//     jdcolor.c; grey and RGB copied;
//   * Pillow's side: "L" and "RGB" to RGBA with alpha 255; 4-component
//     files as Adobe's inverted CMYK ("CMYK;I"), then Pillow's cmyk2rgb.
// Arithmetic coding, 12-bit samples, lossless and hierarchical files,
// sampling factors above 2 and other component counts are refused with a
// message naming the variant.
//
// Plain C interface for ctypes: jpeg_decode, jpeg_free.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries so a corrupt run past 63 lands on a dummy slot
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool present = false;
  // canonical code tables (jdhuff.c's jpeg_make_d_derived_tbl)
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t huffval[256];
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[1 << 9];
};

void build_huffman(Huffman &t, const uint8_t *bits, const uint8_t *vals,
                   int nvals) {
  std::memset(t.huffval, 0, sizeof t.huffval);
  std::memcpy(t.huffval, vals, nvals);
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int numsymbols = p;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) throw Error("JPEG: bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l - 1]) {
      t.valoffset[l] = p - huffcode[p];
      p += bits[l - 1];
      t.maxcode[l] = huffcode[p - 1];
    } else {
      t.maxcode[l] = -1;
    }
  }
  t.valoffset[17] = 0;
  t.maxcode[17] = 0x7FFFFFFF;
  std::memset(t.look, 0, sizeof t.look);
  for (int i = 0; i < numsymbols; i++) {
    int l = huffsize[i];
    if (l > 9) continue;
    int lookbits = huffcode[i] << (9 - l);
    for (int c = 0; c < (1 << (9 - l)); c++)
      t.look[lookbits + c] = (uint16_t)((l << 8) | t.huffval[i]);
  }
  t.present = true;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int width_in_blocks = 0, height_in_blocks = 0;  // of the component alone
  int bw = 0, bh = 0;                             // padded to whole MCUs
  int ds_w = 0, ds_h = 0;                         // downsampled size
  bool latched = false;
  uint16_t qt[64];                                // natural order
  std::vector<int16_t> coef;                      // bw * bh * 64
  int dc_pred = 0;
  int coef_bits[64];                              // progression status
  std::vector<uint8_t> plane;                     // bw*8 x bh*8 samples
};

class Decoder {
 public:
  Decoder(const uint8_t *data, size_t n) : d_(data), n_(n) {}

  void decode(std::vector<uint8_t> &rgba, int &width, int &height);

 private:
  const uint8_t *d_;
  size_t n_;
  size_t pos_ = 0;

  uint16_t qt_[4][64];
  bool qt_present_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comp_;
  int width_ = 0, height_ = 0, hmax_ = 1, vmax_ = 1;
  int mcux_ = 0, mcuy_ = 0;
  bool progressive_ = false, frame_ = false;
  int restart_interval_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;

  // scan state
  std::vector<int> scan_comps_;
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int eobrun_ = 0;
  // bit reader
  size_t bpos_ = 0;
  uint32_t bitbuf_ = 0;
  int bitcnt_ = 0;
  bool hit_marker_ = false;

  int byte() {
    if (pos_ >= n_) throw Error("JPEG: the file ends inside a header");
    return d_[pos_++];
  }
  int u16() {
    int a = byte();
    return (a << 8) | byte();
  }

  void read_app(int marker);
  void read_dqt();
  void read_dht();
  void read_sof(int marker);
  void read_sos();
  void read_dri();

  // entropy-coded data
  void fill() {
    while (bitcnt_ <= 24) {
      int c = 0;
      if (!hit_marker_ && bpos_ < n_) {
        c = d_[bpos_];
        if (c == 0xFF) {
          int c2 = bpos_ + 1 < n_ ? d_[bpos_ + 1] : 0xD9;
          if (c2 == 0) {
            bpos_ += 2;
          } else {
            // a marker: libjpeg feeds zeros from here on
            hit_marker_ = true;
            c = 0;
          }
        } else {
          bpos_++;
        }
      }
      bitbuf_ |= (uint32_t)c << (24 - bitcnt_);
      bitcnt_ += 8;
    }
  }
  int get_bits(int k) {
    if (k == 0) return 0;
    if (bitcnt_ < k) fill();
    int v = (int)(bitbuf_ >> (32 - k));
    bitbuf_ <<= k;
    bitcnt_ -= k;
    return v;
  }
  int get_bit() { return get_bits(1); }
  int decode_huff(const Huffman &t) {
    if (bitcnt_ < 16) fill();
    int look = (int)(bitbuf_ >> (32 - 9));
    int e = t.look[look];
    if (e) {
      int l = e >> 8;
      bitbuf_ <<= l;
      bitcnt_ -= l;
      return e & 0xFF;
    }
    int l = 10;
    int code = (int)(bitbuf_ >> (32 - l));
    while (l <= 16 && code > t.maxcode[l]) {
      l++;
      code = (int)(bitbuf_ >> (32 - l));
    }
    if (l > 16) {
      // a corrupt code: libjpeg returns 0 and goes on
      bitbuf_ <<= 16;
      bitcnt_ -= 16;
      return 0;
    }
    bitbuf_ <<= l;
    bitcnt_ -= l;
    return t.huffval[(code + t.valoffset[l]) & 0xFF];
  }
  static int extend(int v, int s) {
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
  }
  int receive_extend(int s) { return s ? extend(get_bits(s), s) : 0; }

  void restart(int &expected_rst);
  void decode_scan();
  void decode_block_baseline(Component &c, int16_t *blk);
  void decode_block_dc_first(Component &c, int16_t *blk);
  void decode_block_dc_refine(int16_t *blk);
  void decode_block_ac_first(Component &c, int16_t *blk);
  void decode_block_ac_refine(Component &c, int16_t *blk);
  void decode_block(Component &c, int16_t *blk);

  void idct_all();
  void output(std::vector<uint8_t> &rgba);
};

void Decoder::read_app(int marker) {
  int len = u16() - 2;
  if (len < 0 || pos_ + len > n_) throw Error("JPEG: bad APP segment");
  const uint8_t *p = d_ + pos_;
  if (marker == 0xE0 && len >= 14 && std::memcmp(p, "JFIF\0", 5) == 0)
    jfif_ = true;
  if (marker == 0xEE && len >= 12 && std::memcmp(p, "Adobe", 5) == 0) {
    adobe_ = true;
    adobe_transform_ = p[11];
  }
  pos_ += len;
}

void Decoder::read_dqt() {
  int len = u16() - 2;
  size_t end = pos_ + len;
  while (pos_ < end) {
    int pq_tq = byte();
    int pq = pq_tq >> 4, tq = pq_tq & 15;
    if (tq > 3) throw Error("JPEG: quantisation table index above 3");
    for (int i = 0; i < 64; i++)
      qt_[tq][kZigzag[i]] = (uint16_t)(pq ? u16() : byte());
    qt_present_[tq] = true;
  }
}

void Decoder::read_dht() {
  int len = u16() - 2;
  size_t end = pos_ + len;
  while (pos_ < end) {
    int tc_th = byte();
    int tc = tc_th >> 4, th = tc_th & 15;
    if (th > 3 || tc > 1) throw Error("JPEG: bad Huffman table index");
    uint8_t bits[16];
    int count = 0;
    for (int i = 0; i < 16; i++) count += bits[i] = (uint8_t)byte();
    if (count > 256) throw Error("JPEG: bad Huffman table");
    uint8_t vals[256];
    for (int i = 0; i < count; i++) vals[i] = (uint8_t)byte();
    build_huffman(tc ? ac_[th] : dc_[th], bits, vals, count);
  }
}

void Decoder::read_sof(int marker) {
  if (frame_) throw Error("JPEG: a second frame header");
  int len = u16();
  int precision = byte();
  height_ = u16();
  width_ = u16();
  int nc = byte();
  if (len != 8 + 3 * nc) throw Error("JPEG: bad frame header length");
  progressive_ = marker == 0xC2;
  if (precision != 8)
    throw Error("JPEG: " + std::to_string(precision) +
                "-bit samples are not decoded");
  if (nc != 1 && nc != 3 && nc != 4)
    throw Error("JPEG: " + std::to_string(nc) +
                "-component images are not decoded");
  if (width_ <= 0 || height_ <= 0)
    throw Error("JPEG: the image has no width or height (DNL marker)");
  comp_.resize(nc);
  for (auto &c : comp_) {
    c.id = byte();
    int hv = byte();
    c.h = hv >> 4;
    c.v = hv & 15;
    c.tq = byte();
    if (c.h < 1 || c.v < 1 || c.tq > 3)
      throw Error("JPEG: bad component in the frame header");
    if (c.h > 2 || c.v > 2)
      throw Error("JPEG: sampling factors " + std::to_string(c.h) + "x" +
                  std::to_string(c.v) + " (above 2) are not decoded");
    hmax_ = std::max(hmax_, c.h);
    vmax_ = std::max(vmax_, c.v);
  }
  mcux_ = (width_ + 8 * hmax_ - 1) / (8 * hmax_);
  mcuy_ = (height_ + 8 * vmax_ - 1) / (8 * vmax_);
  for (auto &c : comp_) {
    c.ds_w = (int)(((int64_t)width_ * c.h + hmax_ - 1) / hmax_);
    c.ds_h = (int)(((int64_t)height_ * c.v + vmax_ - 1) / vmax_);
    c.width_in_blocks = (c.ds_w + 7) / 8;
    c.height_in_blocks = (c.ds_h + 7) / 8;
    c.bw = mcux_ * c.h;
    c.bh = mcuy_ * c.v;
    c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
  }
  frame_ = true;
}

void Decoder::read_dri() {
  u16();
  restart_interval_ = u16();
}

void Decoder::read_sos() {
  if (!frame_) throw Error("JPEG: a scan before the frame header");
  int len = u16();
  int ns = byte();
  if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
    throw Error("JPEG: bad scan header");
  scan_comps_.clear();
  for (int i = 0; i < ns; i++) {
    int id = byte(), tables = byte();
    int ci = -1;
    for (size_t k = 0; k < comp_.size(); k++)
      if (comp_[k].id == id) ci = (int)k;
    if (ci < 0) throw Error("JPEG: a scan names an unknown component");
    comp_[ci].dc_tbl = tables >> 4;
    comp_[ci].ac_tbl = tables & 15;
    if (comp_[ci].dc_tbl > 3 || comp_[ci].ac_tbl > 3)
      throw Error("JPEG: bad Huffman table index");
    scan_comps_.push_back(ci);
  }
  ss_ = byte();
  se_ = byte();
  int a = byte();
  ah_ = a >> 4;
  al_ = a & 15;
  if (progressive_) {
    if (ss_ > se_ || se_ > 63 || (ss_ == 0 && se_ != 0) ||
        (ss_ > 0 && ns != 1) || al_ > 13)
      throw Error("JPEG: bad progressive scan parameters");
  } else {
    ss_ = 0;
    se_ = 63;
    ah_ = al_ = 0;
  }
  for (int ci : scan_comps_) {
    Component &c = comp_[ci];
    // libjpeg latches a component's table at its first scan
    if (!c.latched) {
      if (!qt_present_[c.tq])
        throw Error("JPEG: a component's quantisation table is missing");
      std::memcpy(c.qt, qt_[c.tq], sizeof c.qt);
      c.latched = true;
    }
    bool dc_needed = (!progressive_) || (ss_ == 0 && ah_ == 0);
    bool ac_needed = (!progressive_) || ss_ > 0;
    if (dc_needed && !dc_[c.dc_tbl].present)
      throw Error("JPEG: a scan's DC Huffman table is missing");
    if (ac_needed && !ac_[c.ac_tbl].present)
      throw Error("JPEG: a scan's AC Huffman table is missing");
    if (progressive_)
      for (int k = ss_; k <= se_; k++) c.coef_bits[k] = al_;
  }
  decode_scan();
}

void Decoder::restart(int &expected_rst) {
  // drop the bits left, find the RSTn marker
  bitbuf_ = 0;
  bitcnt_ = 0;
  hit_marker_ = false;
  while (bpos_ + 1 < n_ && !(d_[bpos_] == 0xFF && d_[bpos_ + 1] != 0 &&
                             d_[bpos_ + 1] != 0xFF))
    bpos_++;
  if (bpos_ + 1 < n_ && d_[bpos_ + 1] == 0xD0 + expected_rst) bpos_ += 2;
  expected_rst = (expected_rst + 1) & 7;
  for (auto &c : comp_) c.dc_pred = 0;
  eobrun_ = 0;
}

void Decoder::decode_block_baseline(Component &c, int16_t *blk) {
  int s = decode_huff(dc_[c.dc_tbl]);
  c.dc_pred += receive_extend(s);
  blk[0] = (int16_t)c.dc_pred;
  const Huffman &ac = ac_[c.ac_tbl];
  for (int k = 1; k < 64; k++) {
    int rs = decode_huff(ac);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kZigzag[k]] = (int16_t)receive_extend(s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

void Decoder::decode_block_dc_first(Component &c, int16_t *blk) {
  int s = decode_huff(dc_[c.dc_tbl]);
  c.dc_pred += receive_extend(s);
  blk[0] = (int16_t)(c.dc_pred * (1 << al_));
}

void Decoder::decode_block_dc_refine(int16_t *blk) {
  if (get_bit()) blk[0] = (int16_t)(blk[0] | (1 << al_));
}

void Decoder::decode_block_ac_first(Component &c, int16_t *blk) {
  if (eobrun_ > 0) {
    eobrun_--;
    return;
  }
  const Huffman &ac = ac_[c.ac_tbl];
  for (int k = ss_; k <= se_; k++) {
    int rs = decode_huff(ac);
    int r = rs >> 4, s = rs & 15;
    if (s) {
      k += r;
      blk[kZigzag[k]] = (int16_t)(receive_extend(s) * (1 << al_));
    } else {
      if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        eobrun_--;
        break;
      }
    }
  }
}

void Decoder::decode_block_ac_refine(Component &c, int16_t *blk) {
  int p1 = 1 << al_, m1 = -1 * (1 << al_);
  int k = ss_;
  const Huffman &ac = ac_[c.ac_tbl];
  if (eobrun_ == 0) {
    for (; k <= se_; k++) {
      int rs = decode_huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = get_bit() ? p1 : m1;
      } else if (r != 15) {
        eobrun_ = 1 << r;
        if (r) eobrun_ += get_bits(r);
        break;
      }
      do {
        int16_t *coef = blk + kZigzag[k];
        if (*coef != 0) {
          if (get_bit() && (*coef & p1) == 0)
            *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= se_);
      if (s) blk[kZigzag[k]] = (int16_t)s;
    }
  }
  if (eobrun_ > 0) {
    for (; k <= se_; k++) {
      int16_t *coef = blk + kZigzag[k];
      if (*coef != 0 && get_bit() && (*coef & p1) == 0)
        *coef = (int16_t)(*coef >= 0 ? *coef + p1 : *coef + m1);
    }
    eobrun_--;
  }
}

void Decoder::decode_block(Component &c, int16_t *blk) {
  if (!progressive_) {
    decode_block_baseline(c, blk);
  } else if (ss_ == 0) {
    if (ah_ == 0)
      decode_block_dc_first(c, blk);
    else
      decode_block_dc_refine(blk);
  } else {
    if (ah_ == 0)
      decode_block_ac_first(c, blk);
    else
      decode_block_ac_refine(c, blk);
  }
}

void Decoder::decode_scan() {
  bpos_ = pos_;
  bitbuf_ = 0;
  bitcnt_ = 0;
  hit_marker_ = false;
  eobrun_ = 0;
  for (auto &c : comp_) c.dc_pred = 0;
  int expected_rst = 0;
  int todo = restart_interval_;
  if (scan_comps_.size() == 1) {
    // non-interleaved: one block an MCU, the component's own block grid
    Component &c = comp_[scan_comps_[0]];
    for (int by = 0; by < c.height_in_blocks; by++)
      for (int bx = 0; bx < c.width_in_blocks; bx++) {
        if (restart_interval_) {
          if (todo == 0) {
            restart(expected_rst);
            todo = restart_interval_;
          }
          todo--;
        }
        decode_block(c, &c.coef[((size_t)by * c.bw + bx) * 64]);
      }
  } else {
    for (int my = 0; my < mcuy_; my++)
      for (int mx = 0; mx < mcux_; mx++) {
        if (restart_interval_) {
          if (todo == 0) {
            restart(expected_rst);
            todo = restart_interval_;
          }
          todo--;
        }
        for (int ci : scan_comps_) {
          Component &c = comp_[ci];
          for (int y = 0; y < c.v; y++)
            for (int x = 0; x < c.h; x++) {
              size_t b = (size_t)(my * c.v + y) * c.bw + (mx * c.h + x);
              decode_block(c, &c.coef[b * 64]);
            }
        }
      }
  }
  // resume the marker parse after the entropy-coded data
  pos_ = bpos_;
  while (pos_ + 1 < n_ && !(d_[pos_] == 0xFF && d_[pos_ + 1] != 0 &&
                            !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7)))
    pos_++;
}

// ------------------------------------------------------------------ IDCT

const int32_t CONST_BITS = 13, PASS1_BITS = 2;
const int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) {
  return (x + (1 << (n - 1))) >> n;
}
inline int16_t sat16(int32_t x) {
  return (int16_t)std::min(32767, std::max(-32768, x));
}

// One 1-D pass of jidctint.c's islow transform: in[0..7] at stride, into
// the eight sums before the descale (out[0..7] in output order).
inline void idct_1d(int32_t i0, int32_t i1, int32_t i2, int32_t i3,
                    int32_t i4, int32_t i5, int32_t i6, int32_t i7,
                    int32_t out[8]) {
  int32_t z2 = i2, z3 = i6;
  int32_t z1 = (z2 + z3) * FIX_0_541196100;
  int32_t tmp2 = z1 + z3 * (-FIX_1_847759065);
  int32_t tmp3 = z1 + z2 * FIX_0_765366865;
  int32_t tmp0 = (i0 + i4) * (1 << CONST_BITS);
  int32_t tmp1 = (i0 - i4) * (1 << CONST_BITS);
  int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  tmp0 = i7;
  tmp1 = i5;
  tmp2 = i3;
  tmp3 = i1;
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int32_t z4 = tmp1 + tmp3;
  int32_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 = tmp0 * FIX_0_298631336;
  tmp1 = tmp1 * FIX_2_053119869;
  tmp2 = tmp2 * FIX_3_072711026;
  tmp3 = tmp3 * FIX_1_501321110;
  z1 = z1 * (-FIX_0_899976223);
  z2 = z2 * (-FIX_2_562915447);
  z3 = z3 * (-FIX_1_961570560);
  z4 = z4 * (-FIX_0_390180644);
  z3 += z5;
  z4 += z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out,
                int stride) {
  int16_t ws[64];
  int32_t o[8];
  for (int c = 0; c < 8; c++) {
    int16_t in[8];
    for (int r = 0; r < 8; r++)
      in[r] = (int16_t)(coef[r * 8 + c] * q[r * 8 + c]);  // pmullw
    idct_1d(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], o);
    for (int r = 0; r < 8; r++)
      ws[r * 8 + c] = sat16(descale(o[r], CONST_BITS - PASS1_BITS));
  }
  for (int r = 0; r < 8; r++) {
    const int16_t *w = ws + r * 8;
    idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], o);
    for (int c = 0; c < 8; c++) {
      int32_t x = sat16(descale(o[c], CONST_BITS + PASS1_BITS + 3));
      out[r * stride + c] = (uint8_t)(std::min(127, std::max(-128, x)) + 128);
    }
  }
}

// libjpeg-turbo's block smoothing (jdcoefct.c, decompress_smooth_data):
// estimates of the first nine AC coefficients that the scans left
// unrefined, from the DC values of a 5 x 5 window of blocks, and (where no
// AC bit of those nine came) a new DC. Rows past the edges are taken as
// that code takes them (held to PIL on every scan prefix of PIL's
// progressive files, tests/test_torch_image_decode.py).
void smooth_block(const Component &c, int by, int bx, int last_imcu,
                  int16_t *ws) {
  const int *cb = c.coef_bits;
  int v = c.v, imcu = by / v, br = by % v;
  int block_rows = v;
  if (imcu == last_imcu) {
    block_rows = c.height_in_blocks % v;
    if (block_rows == 0) block_rows = v;
  }
  // jdcoefct.c counts the rows of the iMCU row being output as if every
  // iMCU row had that many
  int ibr = imcu * block_rows + br, ibrs = block_rows * (last_imcu + 1);
  int prev = ibr > 0 ? by - 1 : by;
  int prev2 = ibr > 1 ? by - 2 : prev;
  int next = ibr < ibrs - 1 ? by + 1 : by;
  int next2 = ibr < ibrs - 2 ? by + 2 : next;
  int rows[5] = {prev2, prev, by, next, next2};
  // the columns, clamped at the component's last real block
  int last_col = c.width_in_blocks - 1;
  int cols[5];
  for (int k = 0; k < 5; k++)
    cols[k] = std::min(std::max(bx + k - 2, 0), last_col);
  int DC[26];
  for (int r = 0; r < 5; r++)
    for (int k = 0; k < 5; k++)
      DC[1 + r * 5 + k] =
          c.coef[((size_t)rows[r] * c.bw + cols[k]) * 64];
  const uint16_t *q = c.qt;
  int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9],
          Q02 = q[2], Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  bool change_dc = true;
  for (int k = 1; k < 10; k++) change_dc = change_dc && cb[k] == -1;
  auto estimate = [&](int k, int pos, int64_t qk, int64_t num) {
    int al = cb[k];
    if (al == 0 || ws[pos] != 0) return;
    num *= Q00;
    int64_t pred;
    if (num >= 0) {
      pred = ((qk << 7) + num) / (qk << 8);
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = ((qk << 7) - num) / (qk << 8);
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    ws[pos] = (int16_t)pred;
  };
  const int *D = DC;
  estimate(1, 1, Q01,
           change_dc ? (-D[1] - D[2] + D[4] + D[5] - 3 * D[6] + 13 * D[7] -
                        13 * D[9] + 3 * D[10] - 3 * D[11] + 38 * D[12] -
                        38 * D[14] + 3 * D[15] - 3 * D[16] + 13 * D[17] -
                        13 * D[19] + 3 * D[20] - D[21] - D[22] + D[24] +
                        D[25])
                     : (-7 * D[11] + 50 * D[12] - 50 * D[14] + 7 * D[15]));
  estimate(2, 8, Q10,
           change_dc ? (-D[1] - 3 * D[2] - 3 * D[3] - 3 * D[4] - D[5] - D[6] +
                        13 * D[7] + 38 * D[8] + 13 * D[9] - D[10] + D[16] -
                        13 * D[17] - 38 * D[18] - 13 * D[19] + D[20] + D[21] +
                        3 * D[22] + 3 * D[23] + 3 * D[24] + D[25])
                     : (-7 * D[3] + 50 * D[8] - 50 * D[18] + 7 * D[23]));
  estimate(3, 16, Q20,
           change_dc ? (D[3] + 2 * D[7] + 7 * D[8] + 2 * D[9] - 5 * D[12] -
                        14 * D[13] - 5 * D[14] + 2 * D[17] + 7 * D[18] +
                        2 * D[19] + D[23])
                     : (-D[3] + 13 * D[8] - 24 * D[13] + 13 * D[18] - D[23]));
  estimate(4, 9, Q11,
           change_dc ? (-D[1] + D[5] + 9 * D[7] - 9 * D[9] - 9 * D[17] +
                        9 * D[19] + D[21] - D[25])
                     : (D[10] + D[16] - 10 * D[17] + 10 * D[19] - D[2] -
                        D[20] + D[22] - D[24] + D[4] - D[6] + 10 * D[7] -
                        10 * D[9]));
  estimate(5, 2, Q02,
           change_dc ? (2 * D[7] - 5 * D[8] + 2 * D[9] + D[11] + 7 * D[12] -
                        14 * D[13] + 7 * D[14] + D[15] + 2 * D[17] -
                        5 * D[18] + 2 * D[19])
                     : (-D[11] + 13 * D[12] - 24 * D[13] + 13 * D[14] -
                        D[15]));
  if (!change_dc) return;
  estimate(6, 3, Q03, D[7] - D[9] + 2 * D[12] - 2 * D[14] + D[17] - D[19]);
  estimate(7, 10, Q12, D[7] - 3 * D[8] + D[9] - D[17] + 3 * D[18] - D[19]);
  estimate(8, 17, Q21, D[7] - D[9] - 3 * D[12] + 3 * D[14] + D[17] - D[19]);
  estimate(9, 24, Q30, D[7] + 2 * D[8] + D[9] - D[17] - 2 * D[18] - D[19]);
  int64_t num = Q00 * (-2 * D[1] - 6 * D[2] - 8 * D[3] - 6 * D[4] - 2 * D[5] -
                       6 * D[6] + 6 * D[7] + 42 * D[8] + 6 * D[9] - 6 * D[10] -
                       8 * D[11] + 42 * D[12] + 152 * D[13] + 42 * D[14] -
                       8 * D[15] - 6 * D[16] + 6 * D[17] + 42 * D[18] +
                       6 * D[19] - 6 * D[20] - 2 * D[21] - 6 * D[22] -
                       8 * D[23] - 6 * D[24] - 2 * D[25]);
  int64_t pred = num >= 0 ? ((Q00 << 7) + num) / (Q00 << 8)
                          : -(((Q00 << 7) - num) / (Q00 << 8));
  ws[0] = (int16_t)pred;
}

void Decoder::idct_all() {
  // libjpeg smooths the blocks of a progressive file where every
  // component has some DC bits and the ten quantisers smoothing reads are
  // nonzero, and some component's scans leave one of the first nine AC
  // coefficients (zig-zag 1-9) short of its last bit
  static const int kQPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool smooth = progressive_, useful = false;
  for (auto &c : comp_) {
    smooth = smooth && c.latched && c.coef_bits[0] >= 0;
    for (int k = 0; k < 10 && c.latched; k++)
      smooth = smooth && c.qt[kQPos[k]] != 0;
    for (int k = 1; k < 10; k++) useful = useful || c.coef_bits[k] != 0;
  }
  smooth = smooth && useful;
  for (auto &c : comp_) {
    // a component no scan reached has no table: libjpeg's zero
    // multipliers, flat 128
    if (!c.latched) std::memset(c.qt, 0, sizeof c.qt);
    int pw = c.bw * 8;
    c.plane.assign((size_t)pw * c.bh * 8, 0);
    int16_t ws[64];
    for (int by = 0; by < c.height_in_blocks; by++)
      for (int bx = 0; bx < c.width_in_blocks; bx++) {
        const int16_t *blk = &c.coef[((size_t)by * c.bw + bx) * 64];
        if (smooth) {
          std::memcpy(ws, blk, sizeof ws);
          smooth_block(c, by, bx, mcuy_ - 1, ws);
          blk = ws;
        }
        idct_islow(blk, c.qt, &c.plane[(size_t)by * 8 * pw + bx * 8], pw);
      }
  }
}

// ------------------------------------------------------------ upsampling

// The component at full size (width_ x height_), by jdsample.c's method
// for its factors.
std::vector<uint8_t> upsample(const Component &c, int hmax, int vmax,
                              int width, int height) {
  int pw = c.bw * 8;
  int rh = hmax / c.h, rv = vmax / c.v;
  std::vector<uint8_t> out((size_t)width * height);
  auto at = [&](int y, int x) -> int {
    y = std::min(std::max(y, 0), c.ds_h - 1);
    x = std::min(std::max(x, 0), c.ds_w - 1);
    return c.plane[(size_t)y * pw + x];
  };
  bool fancy_h = rh == 2 && c.ds_w > 2;
  for (int y = 0; y < height; y++) {
    uint8_t *row = &out[(size_t)y * width];
    if (rh == 1 && rv == 1) {
      for (int x = 0; x < width; x++) row[x] = (uint8_t)at(y, x);
    } else if (rh == 2 && rv == 1) {
      for (int x = 0; x < width; x++) {
        int i = x >> 1;
        if (!fancy_h) {
          row[x] = (uint8_t)at(y, i);
        } else if (x & 1) {
          row[x] = (uint8_t)((at(y, i) * 3 + at(y, i + 1) + 2) >> 2);
        } else {
          row[x] = (uint8_t)((at(y, i) * 3 + at(y, i - 1) + 1) >> 2);
        }
      }
    } else if (rh == 1 && rv == 2) {
      int i = y >> 1, nb = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
      for (int x = 0; x < width; x++)
        row[x] = (uint8_t)((at(i, x) * 3 + at(nb, x) + bias) >> 2);
    } else {  // 2 x 2
      int i = y >> 1, nb = (y & 1) ? i + 1 : i - 1;
      for (int x = 0; x < width; x++) {
        int j = x >> 1;
        if (!fancy_h) {
          row[x] = (uint8_t)at(i, j);
          continue;
        }
        int self = at(i, j) * 3 + at(nb, j);
        if (x & 1) {
          int next = at(i, j + 1) * 3 + at(nb, j + 1);
          row[x] = (uint8_t)((self * 3 + next + 7) >> 4);
        } else {
          int prev = at(i, j - 1) * 3 + at(nb, j - 1);
          row[x] = (uint8_t)((self * 3 + prev + 8) >> 4);
        }
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------- colour

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int32_t)(x * (1 << 16) + 0.5); };
    for (int i = 0, x = -128; i <= 255; i++, x++) {
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};

inline uint8_t clamp8(int x) { return (uint8_t)std::min(255, std::max(0, x)); }

void Decoder::output(std::vector<uint8_t> &rgba) {
  size_t npx = (size_t)width_ * height_;
  rgba.assign(npx * 4, 255);
  std::vector<std::vector<uint8_t>> full;
  for (auto &c : comp_) full.push_back(upsample(c, hmax_, vmax_, width_,
                                                height_));
  int nc = (int)comp_.size();
  static const YccTables T;
  if (nc == 1) {
    for (size_t i = 0; i < npx; i++)
      rgba[4 * i] = rgba[4 * i + 1] = rgba[4 * i + 2] = full[0][i];
    return;
  }
  if (nc == 3) {
    bool rgb;
    if (jfif_)
      rgb = false;
    else if (adobe_)
      rgb = adobe_transform_ == 0;
    else
      rgb = comp_[0].id == 'R' && comp_[1].id == 'G' && comp_[2].id == 'B';
    for (size_t i = 0; i < npx; i++) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      if (rgb) {
        rgba[4 * i] = (uint8_t)y;
        rgba[4 * i + 1] = (uint8_t)cb;
        rgba[4 * i + 2] = (uint8_t)cr;
      } else {
        rgba[4 * i] = clamp8(y + T.cr_r[cr]);
        rgba[4 * i + 1] = clamp8(y + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16));
        rgba[4 * i + 2] = clamp8(y + T.cb_b[cb]);
      }
    }
    return;
  }
  // 4 components: CMYK, or YCCK under an Adobe transform other than 0
  bool ycck = adobe_ && adobe_transform_ != 0;
  for (size_t i = 0; i < npx; i++) {
    int cmyk[4];
    if (ycck) {
      int y = full[0][i], cb = full[1][i], cr = full[2][i];
      cmyk[0] = clamp8(255 - (y + T.cr_r[cr]));
      cmyk[1] = clamp8(255 - (y + (int)((T.cb_g[cb] + T.cr_g[cr]) >> 16)));
      cmyk[2] = clamp8(255 - (y + T.cb_b[cb]));
    } else {
      cmyk[0] = full[0][i];
      cmyk[1] = full[1][i];
      cmyk[2] = full[2][i];
    }
    cmyk[3] = full[3][i];
    // Pillow: "CMYK;I" (Adobe's inverted samples), then cmyk2rgb
    int nk = cmyk[3];  // 255 - (255 - k)
    for (int ch = 0; ch < 3; ch++) {
      int cc = 255 - cmyk[ch];
      int tmp = cc * nk + 128;
      int mul = ((tmp >> 8) + tmp) >> 8;
      rgba[4 * i + ch] = clamp8(nk - mul);
    }
  }
}

void Decoder::decode(std::vector<uint8_t> &rgba, int &width, int &height) {
  if (n_ < 3 || d_[0] != 0xFF || d_[1] != 0xD8)
    throw Error("JPEG: no SOI marker");
  pos_ = 2;
  bool eoi = false;
  int scans = 0;
  while (!eoi) {
    // find the next marker
    while (pos_ < n_ && d_[pos_] != 0xFF) pos_++;
    while (pos_ < n_ && d_[pos_] == 0xFF) pos_++;
    if (pos_ >= n_) break;  // a file cut short: decode what came
    int m = d_[pos_++];
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        read_sof(m);
        break;
      case 0xC3:
        throw Error("JPEG: lossless JPEG (SOF3) is not decoded");
      case 0xC5:
      case 0xC6:
      case 0xC7:
        throw Error("JPEG: hierarchical JPEG (SOF" + std::to_string(m - 0xC0) +
                    ") is not decoded");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
      case 0xCC:
        throw Error("JPEG: arithmetic coding (" +
                    std::string(m == 0xCC ? "DAC"
                                          : "SOF" + std::to_string(m - 0xC0)) +
                    ") is not decoded");
      case 0xC4:
        read_dht();
        break;
      case 0xDB:
        read_dqt();
        break;
      case 0xDD:
        read_dri();
        break;
      case 0xDA:
        read_sos();
        scans++;
        break;
      case 0xD9:
        eoi = true;
        break;
      case 0xDC:
        throw Error("JPEG: a DNL marker (height after the scan) is not "
                    "decoded");
      case 0xDE:
      case 0xDF:
        throw Error("JPEG: hierarchical JPEG (DHP/EXP) is not decoded");
      case 0xD8:
        break;
      default:
        if (m >= 0xD0 && m <= 0xD7) break;  // a stray RSTn
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m);
        } else {
          int len = u16();
          pos_ += len - 2;
        }
    }
  }
  if (!frame_ || scans == 0) throw Error("JPEG: no image data");
  idct_all();
  output(rgba);
  width = width_;
  height = height_;
}

}  // namespace

extern "C" {

// Decodes ``n`` bytes of a JPEG file into a new [h, w, 4] RGBA8 buffer
// (*out, freed by jpeg_free). Returns 0, or 1 with a message in ``err``.
int jpeg_decode(const uint8_t *data, int64_t n, uint8_t **out, int32_t *w,
                int32_t *h, char *err, int64_t errlen) {
  *out = nullptr;
  try {
    Decoder dec(data, (size_t)n);
    std::vector<uint8_t> rgba;
    int width = 0, height = 0;
    dec.decode(rgba, width, height);
    *out = (uint8_t *)std::malloc(rgba.size());
    if (*out == nullptr) throw Error("JPEG: out of memory");
    std::memcpy(*out, rgba.data(), rgba.size());
    *w = width;
    *h = height;
    return 0;
  } catch (const std::exception &e) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
    return 1;
  }
}

void jpeg_free(uint8_t *p) { std::free(p); }

}  // extern "C"
