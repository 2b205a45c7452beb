// LZW decoding of a GIF frame's image data, as Pillow's GifDecode.c runs
// it: the indices of one frame rectangle from the data sub-blocks that
// start at an offset of the file.
//
// Pillow's decoder reads the file's bytes from the frame's data on as
// one stream of sub-blocks and does not stop at the block terminator: a
// zero-length block is read as an empty block and the next byte as the
// next block's length. Decoding ends when the last row of the rectangle
// is written. Pillow feeds the decoder the file in chunks of 64 KiB from
// the data's start, and a sub-block is read only once the chunks fed hold
// all of it; the end code returns to the feeder, which feeds the next
// chunk and decoding goes on after the end code as if it were not there.
// Where the file has no next chunk, Pillow raises ("image file is
// truncated"): so does a frame whose data ends before its last pixel. A
// code past the table's next free entry, or a first code after a clear
// that is not a literal, is broken data. Codes grow to 12 bits; a full
// table (4096 entries) adds no more entries and keeps 12-bit codes until
// a clear. Rows of an interlaced frame come in the four passes (every 8th
// from 0, every 8th from 4, every 4th from 2, every 2nd from 1).
//
// gif_lzw returns 0 when the frame is decoded, 1 when the file ends
// before that, 2 on broken data and 3 when the code size is above 12.

#include <cstdint>
#include <cstring>

namespace {

constexpr int kBits = 12;
constexpr int kTable = 1 << kBits;
constexpr int64_t kChunk = 65536;  // ImageFile.decodermaxblock

struct Rows {
  int w, h, x = 0, y = 0, step, interlace;
  uint8_t* out;
  // Pillow's NEWLINE: false once the last row is done.
  bool newline() {
    x = 0;
    y += step;
    while (y >= h) {
      switch (interlace) {
        case 1: y = 4; interlace = 2; break;
        case 2: step = 4; y = 2; interlace = 3; break;
        case 3: step = 2; y = 1; interlace = 0; break;
        default: return false;
      }
    }
    return true;
  }
};

}  // namespace

extern "C" int gif_lzw(const uint8_t* data, int64_t n, int64_t pos, int bits,
                       int interlace, int w, int h, uint8_t* out) {
  if (bits < 0 || bits > kBits) return 3;
  static thread_local uint8_t suffix[kTable];
  static thread_local uint16_t link[kTable];
  uint8_t stack[kTable + 1];
  const int clear = 1 << bits, end = clear + 1;
  Rows rows{w, h, 0, 0, interlace ? 8 : 1, interlace ? 1 : 0, out};
  int next = clear + 2, codesize = bits + 1, codemask = (1 << codesize) - 1;
  int state = 2;  // 2: first code after a clear, 3: in a string
  int lastcode = 0, lastdata = 0;
  uint32_t bitbuf = 0;
  int bitcount = 0, blocksize = 0;
  int64_t fed = pos + kChunk < n ? pos + kChunk : n;  // end of the chunks fed
  auto feed = [&]() {
    if (fed >= n) return false;
    fed = fed + kChunk < n ? fed + kChunk : n;
    return true;
  };
  for (;;) {
    while (bitcount < codesize) {
      if (blocksize > 0) {
        bitbuf |= uint32_t(data[pos++]) << bitcount;
        bitcount += 8;
        --blocksize;
      } else {
        // a new sub-block, taken only when all of it has been fed
        while (pos >= fed || fed - pos < int64_t(data[pos]) + 1)
          if (!feed()) return 1;
        blocksize = data[pos++];
      }
    }
    int c = int(bitbuf & uint32_t(codemask));
    bitbuf >>= codesize;
    bitcount -= codesize;
    if (c == clear) {
      next = clear + 2;
      codesize = bits + 1;
      codemask = (1 << codesize) - 1;
      state = 2;
      continue;
    }
    if (c == end) {
      if (!feed()) return 1;
      continue;
    }
    int len;
    const uint8_t* p;
    if (state == 2) {
      if (c > clear) return 2;
      lastdata = lastcode = c;
      stack[kTable] = uint8_t(c);
      p = stack + kTable;
      len = 1;
      state = 3;
    } else {
      const int thiscode = c;
      if (c > next) return 2;
      int top = kTable + 1;
      if (c == next) {
        stack[--top] = uint8_t(lastdata);
        c = lastcode;
      }
      while (c >= clear) {
        stack[--top] = suffix[c];
        c = link[c];
      }
      stack[--top] = uint8_t(c);
      lastdata = c;
      if (next < kTable) {
        suffix[next] = uint8_t(c);
        link[next] = uint16_t(lastcode);
        if (next == codemask && codesize < kBits) {
          ++codesize;
          codemask = (1 << codesize) - 1;
        }
        ++next;
      }
      lastcode = thiscode;
      p = stack + top;
      len = kTable + 1 - top;
    }
    for (int i = 0; i < len; ++i) {
      rows.out[int64_t(rows.y) * w + rows.x] = p[i];
      if (++rows.x >= w && !rows.newline()) return 0;
    }
  }
}
