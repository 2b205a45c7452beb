// TIFF strip and tile codecs and predictors, as libtiff 4.7 runs them when
// Pillow decodes a compressed TIFF through it.
//
//  * tiff_lzw: LZW with MSB-first codes and the "early change" (the code
//    width grows one code before the table reaches 2^n), or with
//    `compat` the old-style codes (LSB-first, the width grows at 2^n).
//    As libtiff's LZWDecode and LZWDecodeCompat: the table starts empty,
//    so a chunk must begin with a clear code; consecutive clear codes are
//    skipped; a code past the next free entry is an error; the table has
//    1024 spare entries past 4095, and after those only a clear code or
//    the end code may come; the end code or the end of the data before
//    `occ` bytes are out is an error; a string longer than the room left
//    is cut, and the output ends there.
//  * tiff_packbits: PackBits as libtiff's PackBitsDecode: -128 is a no-op;
//    a run or literal longer than the room left is cut; the data ending
//    first stops decoding, and fewer than `occ` bytes out is an error.
//  * tiff_predict: the horizontal predictor (2) on 8-, 16- or 32-bit
//    samples in the host's order (horAcc8/16/32: each sample adds the one
//    `stride` samples before it in its row, with wrap-around), and the
//    floating-point predictor (3; fpAcc): the row's bytes summed with
//    wrap-around at `stride`, then its byte planes (most significant
//    first) gathered into little-endian samples.
// Each returns 0 on success, else an error code the Python side names.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kClear = 256;
constexpr int kEoi = 257;
constexpr int kFirst = 258;
constexpr int kBitsMin = 9;
constexpr int kBitsMax = 12;
constexpr int kTable = 4095 + 1024;  // libtiff's CSIZE

struct Entry {
  int next;        // the prefix's entry, -1 for none
  int length;      // the string's length
  uint8_t value;   // its last byte
  uint8_t first;   // its first byte
};

struct Bits {
  const uint8_t* p;
  int64_t n, pos = 0;  // bytes, next byte
  uint64_t acc = 0;
  int have = 0;
  bool lsb;
  // The next `nbits`-bit code, or -1 where the data has run out.
  int get(int nbits) {
    while (have < nbits) {
      if (pos >= n) return -1;
      if (lsb) acc |= (uint64_t)p[pos++] << have;
      else acc = (acc << 8) | p[pos++];
      have += 8;
    }
    int code;
    if (lsb) {
      code = (int)(acc & ((1u << nbits) - 1));
      acc >>= nbits;
    } else {
      code = (int)((acc >> (have - nbits)) & ((1u << nbits) - 1));
    }
    have -= nbits;
    return code;
  }
};

}  // namespace

// 0: `occ` bytes out; 1: the data or an end code came first; 2: a code not
// yet in the table (or the table overrun).
extern "C" int tiff_lzw(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ, int compat) {
  std::vector<Entry> tab(kTable);
  for (int i = 0; i < 256; i++) tab[i] = {-1, 1, (uint8_t)i, (uint8_t)i};
  Bits bits{in, n};
  bits.lsb = compat != 0;
  // the grow point: the free entry past which the width grows
  auto grow_at = [compat](int nbits) { return (1 << nbits) - (compat ? 1 : 2); };
  int nbits = kBitsMin, free_ent = -1, old = -1;
  int64_t o = 0;
  while (o < occ) {
    int code = bits.get(nbits);
    if (code < 0 || code == kEoi) return 1;
    if (code == kClear) {
      free_ent = kFirst;
      nbits = kBitsMin;
      do {
        code = bits.get(nbits);
      } while (code == kClear);
      if (code < 0 || code == kEoi) return 1;
      if (code > kEoi) return 2;
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= kTable) return 2;
    Entry& e = tab[free_ent];
    if (code >= free_ent) {
      if (code != free_ent) return 2;
      e.value = tab[old].first;
    } else {
      e.value = tab[code].first;
    }
    e.next = old;
    e.first = tab[old].first;
    e.length = tab[old].length + 1;
    if (++free_ent > grow_at(nbits)) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      if (free_ent >= kTable) free_ent = -1;
    }
    old = code;
    int len = tab[code].length;
    if (len > occ - o) {
      // cut: the string's first occ - o bytes
      int c = code;
      while (tab[c].length > occ - o) c = tab[c].next;
      for (int64_t k = occ - 1; k >= o; k--) {
        out[k] = tab[c].value;
        c = tab[c].next;
      }
      return 0;
    }
    int c = code;
    for (int64_t k = o + len - 1; k >= o; k--) {
      out[k] = tab[c].value;
      c = tab[c].next;
    }
    o += len;
  }
  return 0;
}

// 0: `occ` bytes out; 1: the data ended first.
extern "C" int tiff_packbits(const uint8_t* in, int64_t n, uint8_t* out, int64_t occ) {
  int64_t i = 0, o = 0;
  while (i < n && o < occ) {
    int b = (int8_t)in[i++];
    if (b < 0) {
      if (b == -128) continue;
      int64_t run = -b + 1;
      if (run > occ - o) run = occ - o;
      if (i >= n) break;
      std::memset(out + o, in[i++], run);
      o += run;
    } else {
      int64_t run = b + 1;
      if (run > occ - o) run = occ - o;
      if (n - i < run) break;
      std::memcpy(out + o, in + i, run);
      o += run;
      i += run;
    }
  }
  return o < occ ? 1 : 0;
}

namespace {

template <typename T>
void hor_acc(uint8_t* row, int64_t count, int stride) {
  T v[8];
  for (int64_t k = stride; k < count; k++) {
    std::memcpy(&v[0], row + (k - stride) * sizeof(T), sizeof(T));
    std::memcpy(&v[1], row + k * sizeof(T), sizeof(T));
    T s = (T)(v[0] + v[1]);
    std::memcpy(row + k * sizeof(T), &s, sizeof(T));
  }
}

}  // namespace

// Undoes predictor `kind` (2 or 3) on `size` bytes of rows of `rowsize`
// bytes, samples of `bytes` bytes, `stride` samples a pixel. 0 on success;
// 3 where a row does not split into whole pixels (libtiff's error).
extern "C" int tiff_predict(uint8_t* buf, int64_t size, int64_t rowsize, int kind, int bytes,
                            int stride) {
  if (rowsize <= 0 || size % rowsize) return 3;
  std::vector<uint8_t> tmp(kind == 3 ? rowsize : 0);
  for (int64_t r = 0; r < size; r += rowsize) {
    uint8_t* row = buf + r;
    if (kind == 2) {
      const int64_t count = rowsize / bytes;
      if (count % stride) return 3;
      if (bytes == 1) hor_acc<uint8_t>(row, count, stride);
      else if (bytes == 2) hor_acc<uint16_t>(row, count, stride);
      else hor_acc<uint32_t>(row, count, stride);
    } else {
      if (rowsize % ((int64_t)bytes * stride)) return 3;
      for (int64_t k = stride; k < rowsize; k++) row[k] = (uint8_t)(row[k] + row[k - stride]);
      std::memcpy(tmp.data(), row, rowsize);
      const int64_t wc = rowsize / bytes;
      for (int64_t c = 0; c < wc; c++)
        for (int b = 0; b < bytes; b++) row[bytes * c + b] = tmp[(bytes - b - 1) * wc + c];
    }
  }
  return 0;
}
