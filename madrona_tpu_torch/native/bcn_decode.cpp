// Block-compressed (BCn) texture decoding to RGBA8, as Pillow's BcnDecode.c
// gives a DDS file's first surface after convert("RGBA").
//
// The formats are Microsoft's "Block Compression (Direct3D 10)", "BC6H
// Format" and "BC7 Format" (Khronos Data Format Specification 1.3, S3TC,
// RGTC and BPTC), with Pillow's arithmetic where the specifications leave
// room:
//  * BC1: 5:6:5 endpoints widened by bit replication; c0 > c1 gives the
//    thirds (2 c0 + c1) / 3 and (c0 + 2 c1) / 3, truncated, else the half
//    (c0 + c1) / 2 and transparent black. BC2 and BC3 colour blocks always
//    take the thirds;
//  * BC2: explicit 4-bit alpha, widened as a * 17;
//  * BC3 alpha, BC4 and BC5 channels: a0 > a1 gives six interpolated values
//    ((7 - k) a0 + k a1) / 7, else four ((5 - k) a0 + k a1) / 5, 0 and 255,
//    truncated. Signed BC5 endpoints are biased by 128 and then decoded
//    unsigned (-128 -> 0, 127 -> 255); its blue is 128, unsigned BC5's 0;
//  * BC6H: the 14 modes and their bit layouts, signed and delta endpoints,
//    unquantisation, the 32 two-region partitions, interpolation with BC7's
//    weights, the scale to a half float (x 31 / 64, signed x 31 / 32), and
//    Pillow's conversion to 8 bits: the half's value clamped to [0, 1] and
//    multiplied by 255 in float, truncated. A reserved mode code gives
//    black;
//  * BC7: modes 0-7 with their partitions, anchors, p-bits, rotations and
//    index selection; the reserved mode byte 0 gives opaque black.
// Blocks are laid out left to right, top to bottom; a block's pixels past
// the image's right or bottom edge are dropped.
//
// bcn_decode returns 0 when the image is filled and 1 when the data ends
// before its last block (Pillow: "image file is truncated").

#include <cstdint>
#include <cstring>

namespace {

struct Rgba {
  uint8_t r, g, b, a;
};

int load16(const uint8_t* p) { return p[0] | (p[1] << 8); }

uint32_t load32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | ((uint32_t)p[3] << 24);
}

int get_bit(const uint8_t* src, int bit) { return (src[bit >> 3] >> (bit & 7)) & 1; }

// ``count`` (0 to 8) bits from bit ``bit`` of the block, low bit first.
int get_bits(const uint8_t* src, int bit, int count) {
  if (!count) return 0;
  int by = bit >> 3;
  bit &= 7;
  int x = src[by];
  if (bit + count > 8) x |= src[by + 1] << 8;
  return (x >> bit) & ((1 << count) - 1);
}

Rgba decode_565(int x) {
  Rgba c;
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  c.r = r | (r >> 5);
  c.g = g | (g >> 6);
  c.b = b | (b >> 5);
  c.a = 255;
  return c;
}

void bc1_colour(Rgba* dst, const uint8_t* src, bool always_four) {
  int c0 = load16(src), c1 = load16(src + 2);
  uint32_t lut = load32(src + 4);
  Rgba p[4];
  p[0] = decode_565(c0);
  p[1] = decode_565(c1);
  int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b;
  int r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || always_four) {
    p[2] = {(uint8_t)((2 * r0 + r1) / 3), (uint8_t)((2 * g0 + g1) / 3),
            (uint8_t)((2 * b0 + b1) / 3), 255};
    p[3] = {(uint8_t)((r0 + 2 * r1) / 3), (uint8_t)((g0 + 2 * g1) / 3),
            (uint8_t)((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = {(uint8_t)((r0 + r1) / 2), (uint8_t)((g0 + g1) / 2),
            (uint8_t)((b0 + b1) / 2), 255};
    p[3] = {0, 0, 0, 0};
  }
  for (int n = 0; n < 16; n++) dst[n] = p[3 & (lut >> (2 * n))];
}

// The BC3 alpha / BC4 / BC5 channel block into byte ``o`` of each pixel
// (``stride`` bytes apart); ``bias`` 128 for signed endpoints.
void bc3_channel(uint8_t* dst, const uint8_t* src, int stride, int o, int bias) {
  int a0 = (uint8_t)(src[0] + bias), a1 = (uint8_t)(src[1] + bias);
  int a[8];
  a[0] = a0;
  a[1] = a1;
  if (a0 > a1) {
    for (int k = 1; k < 7; k++) a[k + 1] = ((7 - k) * a0 + k * a1) / 7;
  } else {
    for (int k = 1; k < 5; k++) a[k + 1] = ((5 - k) * a0 + k * a1) / 5;
    a[6] = 0;
    a[7] = 255;
  }
  uint32_t lut1 = src[2] | (src[3] << 8) | (src[4] << 16);
  uint32_t lut2 = src[5] | (src[6] << 8) | (src[7] << 16);
  for (int n = 0; n < 8; n++) dst[stride * n + o] = a[7 & (lut1 >> (3 * n))];
  for (int n = 0; n < 8; n++) dst[stride * (8 + n) + o] = a[7 & (lut2 >> (3 * n))];
}

// ---------------------------------------------------------------- BC7

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};

const Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
    {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
    {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};

// two-subset partitions, one bit a pixel
const uint16_t kPartition2[64] = {
    0xcccc, 0x8888, 0xeeee, 0xecc8, 0xc880, 0xfeec, 0xfec8, 0xec80,
    0xc800, 0xffec, 0xfe80, 0xe800, 0xffe8, 0xff00, 0xfff0, 0xf000,
    0xf710, 0x008e, 0x7100, 0x08ce, 0x008c, 0x7310, 0x3100, 0x8cce,
    0x088c, 0x3110, 0x6666, 0x366c, 0x17e8, 0x0ff0, 0x718e, 0x399c,
    0xaaaa, 0xf0f0, 0x5a5a, 0x33cc, 0x3c3c, 0x55aa, 0x9696, 0xa55a,
    0x73ce, 0x13c8, 0x324c, 0x3bdc, 0x6996, 0xc33c, 0x9966, 0x0660,
    0x0272, 0x04e4, 0x4e40, 0x2720, 0xc936, 0x936c, 0x39c6, 0x639c,
    0x9336, 0x9cc6, 0x817e, 0xe718, 0xccf0, 0x0fcc, 0x7744, 0xee22};

// three-subset partitions, two bits a pixel
const uint32_t kPartition3[64] = {
    0xaa685050, 0x6a5a5040, 0x5a5a4200, 0x5450a0a8, 0xa5a50000, 0xa0a05050,
    0x5555a0a0, 0x5a5a5050, 0xaa550000, 0xaa555500, 0xaaaa5500, 0x90909090,
    0x94949494, 0xa4a4a4a4, 0xa9a59450, 0x2a0a4250, 0xa5945040, 0x0a425054,
    0xa5a5a500, 0x55a0a0a0, 0xa8a85454, 0x6a6a4040, 0xa4a45000, 0x1a1a0500,
    0x0050a4a4, 0xaaa59090, 0x14696914, 0x69691400, 0xa08585a0, 0xaa821414,
    0x50a4a450, 0x6a5a0200, 0xa9a58000, 0x5090a0a8, 0xa8a09050, 0x24242424,
    0x00aa5500, 0x24924924, 0x24499224, 0x50a50a50, 0x500aa550, 0xaaaa4444,
    0x66660000, 0xa5a0a5a0, 0x50a050a0, 0x69286928, 0x44aaaa44, 0x66666600,
    0xaa444444, 0x54a854a8, 0x95809580, 0x96969600, 0xa85454a8, 0x80959580,
    0xaa141414, 0x96960000, 0xaaaa1414, 0xa05050a0, 0xa0a5a5a0, 0x96000000,
    0x40804080, 0xa9a8a9a8, 0xaaaaaa44, 0x2a4a5254};

// anchor index of subset 1 of two; of subsets 1 and 2 of three
const uint8_t kAnchor2[64] = {
    15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
    15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
    15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
    6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kAnchor3a[64] = {
    3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
    3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
    8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
    3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kAnchor3b[64] = {
    15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
    15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
    15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
    15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};

const uint8_t kWeights2[4] = {0, 21, 43, 64};
const uint8_t kWeights3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
const uint8_t kWeights4[16] = {0,  4,  9,  13, 17, 21, 26, 30,
                               34, 38, 43, 47, 51, 55, 60, 64};

const uint8_t* weights(int bits) {
  return bits == 2 ? kWeights2 : bits == 3 ? kWeights3 : kWeights4;
}

int subset_of(int ns, int partition, int n) {
  if (ns == 2) return 1 & (kPartition2[partition] >> n);
  if (ns == 3) return 3 & (kPartition3[partition] >> (2 * n));
  return 0;
}

// Pixel n's index is one bit short when it is its subset's anchor.
bool is_anchor(int ns, int partition, int subset, int n) {
  if (n == 0) return true;
  if (ns == 2) return subset == 1 && n == kAnchor2[partition];
  if (ns == 3)
    return (subset == 1 && n == kAnchor3a[partition]) ||
           (subset == 2 && n == kAnchor3b[partition]);
  return false;
}

int widen(int v, int bits) {
  v = (v << (8 - bits)) & 255;
  return v | (v >> bits);
}

uint8_t lerp64(int e0, int e1, int w) { return (uint8_t)(((64 - w) * e0 + w * e1 + 32) >> 6); }

void bc7_block(Rgba* col, const uint8_t* src) {
  if (!src[0]) {
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  int mode = 0;
  while (!(src[0] & (1 << mode))) mode++;
  const Bc7Mode& m = kBc7Modes[mode];
  int bit = mode + 1;
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int rotation = get_bits(src, bit, m.rb);
  bit += m.rb;
  int index_sel = get_bits(src, bit, m.isb);
  bit += m.isb;
  int numep = m.ns * 2;
  int ep[6][4];
  for (int c = 0; c < 3; c++)
    for (int i = 0; i < numep; i++, bit += m.cb) ep[i][c] = get_bits(src, bit, m.cb);
  for (int i = 0; i < numep; i++) {
    ep[i][3] = m.ab ? get_bits(src, bit, m.ab) : 255;
    bit += m.ab;
  }
  int cb = m.cb, ab = m.ab;
  if (m.epb || m.spb) {
    cb++;
    if (ab) ab++;
    for (int i = 0; i < numep; i++) {
      int p;
      if (m.epb) {
        p = get_bit(src, bit++);
      } else {
        if (!(i & 1)) p = get_bit(src, bit++);
        else p = get_bit(src, bit - 1);
      }
      for (int c = 0; c < 3; c++) ep[i][c] = (ep[i][c] << 1) | p;
      if (ab) ep[i][3] = (ep[i][3] << 1) | p;
    }
  }
  for (int i = 0; i < numep; i++) {
    for (int c = 0; c < 3; c++) ep[i][c] = widen(ep[i][c], cb);
    if (ab) ep[i][3] = widen(ep[i][3], ab);
  }
  const uint8_t* cw = weights(m.ib);
  const uint8_t* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  int cbit = bit, abit = bit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; i++) {
    int s = subset_of(m.ns, partition, i);
    int ib = m.ib - (is_anchor(m.ns, partition, s, i) ? 1 : 0);
    int i0 = get_bits(src, cbit, ib);
    cbit += ib;
    int wc = cw[i0], wa = cw[i0];
    if (ab && m.ib2) {
      int ib2 = m.ib2 - (i == 0 ? 1 : 0);
      int i1 = get_bits(src, abit, ib2);
      abit += ib2;
      if (index_sel) {
        wc = aw[i1];
      } else {
        wa = aw[i1];
      }
    }
    const int* e0 = ep[2 * s];
    const int* e1 = ep[2 * s + 1];
    Rgba p = {lerp64(e0[0], e1[0], wc), lerp64(e0[1], e1[1], wc),
              lerp64(e0[2], e1[2], wc), lerp64(e0[3], e1[3], wa)};
    uint8_t t;
    switch (rotation) {
      case 1: t = p.r; p.r = p.a; p.a = t; break;
      case 2: t = p.g; p.g = p.a; p.a = t; break;
      case 3: t = p.b; p.b = p.a; p.a = t; break;
    }
    col[i] = p;
  }
}

// ---------------------------------------------------------------- BC6H

struct Bc6Mode {
  int ns, transformed, pb, epb, rb, gb, bb;
  const char* layout;  // the endpoint fields after the mode bits
};

// Each field "<channel><endpoint>[hi:lo]" lists its bits in the stream
// from the right index to the left one; channel r, g, b; endpoint w, x
// (region 0), y, z (region 1).
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5,
     "gy[4] by[4] bz[4] rw[9:0] gw[9:0] bw[9:0] rx[4:0] gz[4] gy[3:0] "
     "gx[4:0] bz[0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] "
     "bz[3]"},
    {2, 1, 5, 7, 6, 6, 6,
     "gy[5] gz[4] gz[5] rw[6:0] bz[0] bz[1] by[4] gw[6:0] by[5] bz[2] gy[4] "
     "bw[6:0] bz[3] bz[5] bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] bx[5:0] "
     "by[3:0] ry[5:0] rz[5:0]"},
    {2, 1, 5, 11, 5, 4, 4,
     "rw[9:0] gw[9:0] bw[9:0] rx[4:0] rw[10] gy[3:0] gx[3:0] gw[10] bz[0] "
     "gz[3:0] bx[3:0] bw[10] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] bz[3]"},
    {2, 1, 5, 11, 4, 5, 4,
     "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] gz[4] gy[3:0] gx[4:0] gw[10] "
     "gz[3:0] bx[3:0] bw[10] bz[1] by[3:0] ry[3:0] bz[0] bz[2] rz[3:0] "
     "gy[4] bz[3]"},
    {2, 1, 5, 11, 4, 4, 5,
     "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10] by[4] gy[3:0] gx[3:0] gw[10] "
     "bz[0] gz[3:0] bx[4:0] bw[10] by[3:0] ry[3:0] bz[1] bz[2] rz[3:0] "
     "bz[4] bz[3]"},
    {2, 1, 5, 9, 5, 5, 5,
     "rw[8:0] by[4] gw[8:0] gy[4] bw[8:0] bz[4] rx[4:0] gz[4] gy[3:0] "
     "gx[4:0] bz[0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] rz[4:0] "
     "bz[3]"},
    {2, 1, 5, 8, 6, 5, 5,
     "rw[7:0] gz[4] by[4] gw[7:0] bz[2] gy[4] bw[7:0] bz[3] bz[4] rx[5:0] "
     "gy[3:0] gx[4:0] bz[0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[5:0] rz[5:0]"},
    {2, 1, 5, 8, 5, 6, 5,
     "rw[7:0] bz[0] by[4] gw[7:0] gy[5] gy[4] bw[7:0] gz[5] bz[4] rx[4:0] "
     "gz[4] gy[3:0] gx[5:0] gz[3:0] bx[4:0] bz[1] by[3:0] ry[4:0] bz[2] "
     "rz[4:0] bz[3]"},
    {2, 1, 5, 8, 5, 5, 6,
     "rw[7:0] bz[1] by[4] gw[7:0] by[5] gy[4] bw[7:0] bz[5] bz[4] rx[4:0] "
     "gz[4] gy[3:0] gx[4:0] bz[0] gz[3:0] bx[5:0] by[3:0] ry[4:0] bz[2] "
     "rz[4:0] bz[3]"},
    {2, 0, 5, 6, 6, 6, 6,
     "rw[5:0] gz[4] bz[0] bz[1] by[4] gw[5:0] gy[5] by[5] bz[2] gy[4] "
     "bw[5:0] gz[5] bz[3] bz[5] bz[4] rx[5:0] gy[3:0] gx[5:0] gz[3:0] "
     "bx[5:0] by[3:0] ry[5:0] rz[5:0]"},
    {1, 0, 0, 10, 10, 10, 10,
     "rw[9:0] gw[9:0] bw[9:0] rx[9:0] gx[9:0] bx[9:0]"},
    {1, 1, 0, 11, 9, 9, 9,
     "rw[9:0] gw[9:0] bw[9:0] rx[8:0] rw[10] gx[8:0] gw[10] bx[8:0] bw[10]"},
    {1, 1, 0, 12, 8, 8, 8,
     "rw[9:0] gw[9:0] bw[9:0] rx[7:0] rw[10:11] gx[7:0] gw[10:11] bx[7:0] "
     "bw[10:11]"},
    {1, 1, 0, 16, 4, 4, 4,
     "rw[9:0] gw[9:0] bw[9:0] rx[3:0] rw[10:15] gx[3:0] gw[10:15] bx[3:0] "
     "bw[10:15]"}};

// (endpoint * 3 + channel) << 4 | bit, for each endpoint bit in stream order
struct Bc6Layouts {
  uint8_t bits[14][75];
  int count[14];
  Bc6Layouts() {
    for (int m = 0; m < 14; m++) {
      int n = 0;
      for (const char* p = kBc6Modes[m].layout; *p;) {
        if (*p == ' ') { p++; continue; }
        int ch = p[0] == 'r' ? 0 : p[0] == 'g' ? 1 : 2;
        int e = p[1] == 'w' ? 0 : p[1] == 'x' ? 1 : p[1] == 'y' ? 2 : 3;
        p += 3;  // past "[" too
        int left = 0, right;
        while (*p >= '0' && *p <= '9') left = left * 10 + (*p++ - '0');
        right = left;
        if (*p == ':') {
          p++;
          right = 0;
          while (*p >= '0' && *p <= '9') right = right * 10 + (*p++ - '0');
        }
        p++;  // "]"
        int step = left >= right ? 1 : -1;
        for (int b = right;; b += step) {
          bits[m][n++] = (uint8_t)(((e * 3 + ch) << 4) | b);
          if (b == left) break;
        }
      }
      count[m] = n;
    }
  }
};

const Bc6Layouts& bc6_layouts() {
  static const Bc6Layouts layouts;
  return layouts;
}

int sign_extend(int v, int bits) {
  v &= (1 << bits) - 1;
  return (v & (1 << (bits - 1))) ? v - (1 << bits) : v;
}

int bc6_unquantize(int x, int prec, bool sign) {
  if (!sign) {
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xffff;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  x = (int16_t)(uint16_t)x;
  if (prec >= 16) return x;
  bool neg = x < 0;
  if (neg) x = -x;
  if (x != 0) {
    if (x >= (1 << (prec - 1)) - 1) x = 0x7fff;
    else x = ((x << 15) + 0x4000) >> (prec - 1);
  }
  return neg ? -x : x;
}

float half_to_float(uint16_t h) {
  // the exact value of a half (F. Giesen's half_to_float_fast5)
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;  // 2^112
  o.u = (uint32_t)(h & 0x7fff) << 13;
  o.f *= m.f;
  m.u = 0x47800000;  // 65536
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (uint32_t)(h & 0x8000) << 16;
  return o.f;
}

uint8_t bc6_channel(int v, bool sign) {
  uint16_t h;
  if (sign) h = v < 0 ? (uint16_t)(0x8000 | ((-v) * 31 / 32)) : (uint16_t)(v * 31 / 32);
  else h = (uint16_t)(v * 31 / 64);
  float f = half_to_float(h);
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return (uint8_t)(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* src, bool sign) {
  int mode = src[0] & 0x1f, bit;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
    bit = 5;
  } else {
    mode = 10 + (mode >> 2);
    bit = 5;
  }
  if (mode >= 14) {
    for (int i = 0; i < 16; i++) col[i] = {0, 0, 0, 255};
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  const Bc6Layouts& lay = bc6_layouts();
  int e[12] = {0};
  for (int i = 0; i < lay.count[mode]; i++) {
    int d = lay.bits[mode][i];
    e[d >> 4] |= get_bit(src, bit + i) << (d & 15);
  }
  bit += lay.count[mode];
  int partition = get_bits(src, bit, m.pb);
  bit += m.pb;
  int numep = m.ns * 6;
  const int delta_bits[3] = {m.rb, m.gb, m.bb};
  if (sign)
    for (int c = 0; c < 3; c++) e[c] = sign_extend(e[c], m.epb);
  if (sign || m.transformed)
    for (int i = 3; i < numep; i++) e[i] = sign_extend(e[i], delta_bits[i % 3]);
  if (m.transformed) {
    for (int i = 3; i < numep; i++) {
      // Pillow keeps the sum in epb bits and does not sign-extend it:
      // only a 16-bit sum comes out negative (its int16 read)
      e[i] = (e[i] + e[i % 3]) & ((1 << m.epb) - 1);
    }
  }
  int u[12];
  for (int i = 0; i < numep; i++) u[i] = bc6_unquantize(e[i], m.epb, sign);
  int ib = m.ns == 2 ? 3 : 4;
  const uint8_t* w = weights(ib);
  for (int i = 0; i < 16; i++) {
    int s = subset_of(m.ns, partition, i);
    int bits = ib - (is_anchor(m.ns, partition, s, i) ? 1 : 0);
    int k = w[get_bits(src, bit, bits)];
    bit += bits;
    const int* e0 = u + 6 * s;
    const int* e1 = e0 + 3;
    int v[3];
    for (int c = 0; c < 3; c++) v[c] = (e0[c] * (64 - k) + e1[c] * k) >> 6;
    col[i] = {bc6_channel(v[0], sign), bc6_channel(v[1], sign), bc6_channel(v[2], sign), 255};
  }
}

}  // namespace

// ``format``: 1 BC1, 2 BC2, 3 BC3, 4 BC4, 5 BC5, 6 BC6H, 7 BC7;
// ``is_signed``: BC5S or BC6H_SF16. ``out``: [h, w, 4] RGBA.
extern "C" int bcn_decode(const uint8_t* data, int64_t n, int format, int is_signed,
                          int w, int h, uint8_t* out) {
  const int64_t block = (format == 1 || format == 4) ? 8 : 16;
  const int64_t bw = (w + 3) / 4, bh = (h + 3) / 4;
  if (w <= 0 || h <= 0) return 0;
  if (n < bw * bh * block) return 1;
  for (int64_t by = 0; by < bh; by++) {
    for (int64_t bx = 0; bx < bw; bx++) {
      const uint8_t* src = data + (by * bw + bx) * block;
      Rgba col[16];
      std::memset(col, 0, sizeof(col));
      switch (format) {
        case 1: bc1_colour(col, src, false); break;
        case 2:
          bc1_colour(col, src + 8, true);
          for (int i = 0; i < 16; i++) {
            int a = 15 & (src[i >> 1] >> (4 * (i & 1)));
            col[i].a = (uint8_t)(a * 17);
          }
          break;
        case 3:
          bc1_colour(col, src + 8, true);
          bc3_channel(&col[0].a, src, 4, 0, 0);
          break;
        case 4:
          bc3_channel(&col[0].r, src, 4, 0, 0);
          for (int i = 0; i < 16; i++) col[i] = {col[i].r, col[i].r, col[i].r, 255};
          break;
        case 5: {
          int bias = is_signed ? 128 : 0;
          bc3_channel(&col[0].r, src, 4, 0, bias);
          bc3_channel(&col[0].r, src + 8, 4, 1, bias);
          for (int i = 0; i < 16; i++) {
            col[i].b = is_signed ? 128 : 0;
            col[i].a = 255;
          }
          break;
        }
        case 6: bc6_block(col, src, is_signed != 0); break;
        case 7: bc7_block(col, src); break;
        default: return 2;
      }
      for (int j = 0; j < 4; j++) {
        int64_t y = by * 4 + j;
        if (y >= h) break;
        for (int i = 0; i < 4; i++) {
          int64_t x = bx * 4 + i;
          if (x >= w) break;
          std::memcpy(out + (y * w + x) * 4, &col[j * 4 + i], 4);
        }
      }
    }
  }
  return 0;
}
