// QOI ("Quite OK Image") decoding to RGBA8, as Pillow's QoiDecoder runs it.
//
// The ops of the QOI specification, with Pillow's reading of them:
//  * the previous pixel starts as (0, 0, 0, 255); the 64-slot index starts
//    empty, and an index op on a slot never written gives (0, 0, 0, 0);
//  * every op but a run sets the previous pixel and writes it into the
//    index at (3 r + 5 g + 7 b + 11 a) % 64 (an index op too, at its
//    value's own slot); QOI_OP_RGB keeps the previous alpha;
//  * a run repeats the previous pixel and may run past the last pixel,
//    which ends the image; the end marker is not read.
// qoi_decode returns 0 when the image is filled and 1 when the data ends
// before that (Pillow fails to read the op's bytes).

#include <cstdint>
#include <cstring>

extern "C" int qoi_decode(const uint8_t* data, int64_t n, int64_t pos, int64_t pixels,
                          uint8_t* out) {
  uint8_t index[64][4];
  bool seen[64] = {false};
  uint8_t px[4] = {0, 0, 0, 255};
  int64_t done = 0;
  while (done < pixels) {
    if (pos >= n) return 1;
    const int op = data[pos++];
    if (op == 0xfe || op == 0xff) {
      const int k = op == 0xfe ? 3 : 4;
      if (pos + k > n) return 1;
      std::memcpy(px, data + pos, k);
      pos += k;
    } else if ((op >> 6) == 0) {
      static const uint8_t kUnwritten[4] = {0, 0, 0, 0};
      std::memcpy(px, seen[op] ? index[op] : kUnwritten, 4);
    } else if ((op >> 6) == 1) {
      px[0] = (uint8_t)(px[0] + ((op >> 4) & 3) - 2);
      px[1] = (uint8_t)(px[1] + ((op >> 2) & 3) - 2);
      px[2] = (uint8_t)(px[2] + (op & 3) - 2);
    } else if ((op >> 6) == 2) {
      if (pos >= n) return 1;
      const int second = data[pos++];
      const int dg = (op & 63) - 32;
      px[0] = (uint8_t)(px[0] + dg + (second >> 4) - 8);
      px[1] = (uint8_t)(px[1] + dg);
      px[2] = (uint8_t)(px[2] + dg + (second & 15) - 8);
    } else {
      int64_t run = (op & 63) + 1;
      if (run > pixels - done) run = pixels - done;
      for (int64_t i = 0; i < run; i++, done++) std::memcpy(out + 4 * done, px, 4);
      continue;
    }
    const int slot = (px[0] * 3 + px[1] * 5 + px[2] * 7 + px[3] * 11) % 64;
    std::memcpy(index[slot], px, 4);
    seen[slot] = true;
    std::memcpy(out + 4 * done++, px, 4);
  }
  return 0;
}
