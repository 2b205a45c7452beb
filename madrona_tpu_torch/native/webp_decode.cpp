// WebP decoding to RGBA8 as libwebp's WebPAnimDecoder gives a file's first
// frame (RFC 6386 for VP8, RFC 9649 for the container and VP8L).
//
// webp_frame decodes one frame's bitstream into its rectangle of the canvas:
//  * VP8 (lossy): the boolean decoder, the segment, quantiser and filter
//    headers, the coefficient probabilities and tokens, the 16x16, 4x4 and
//    chroma intra predictors with libwebp's edge samples (127 above the
//    frame, 129 left of it), the inverse WHT and DCT, the simple and
//    normal loop filters in macroblock order (prediction reads unfiltered
//    pixels), then libwebp's "fancy" chroma upsampler and its fixed-point
//    YUV -> RGB, all in the integer arithmetic of libwebp's C code, whose
//    SIMD paths give the same bytes;
//  * ALPH: raw or VP8L-coded alpha with the none, horizontal, vertical
//    and gradient filters (no dequantisation dithering: WebPAnimDecoder
//    asks for none);
//  * VP8L (lossless): prefix codes (simple and normal, with the code
//    length code), meta prefix codes, LZ77 with the 120 short distance
//    codes, the colour cache, and the predictor, cross-colour,
//    subtract-green and colour-indexing (with pixel packing) transforms.
// The constant tables are RFC 6386's (libwebp orders the 4x4 intra modes
// as kYModesIntra4's leaves and permutes kBModesProba to match).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// [type][band][context][node], flattened
const uint8_t kCoeffsUpdateProba[4 * 8 * 3 * 11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

const uint8_t kCoeffsProba0[4 * 8 * 3 * 11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// [top mode][left mode][node], modes numbered as kYModesIntra4 leaves
const uint8_t kBModesProba[10 * 10 * 9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// the 120 short distance codes: (dy << 4) | (8 - dx)
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42,
    56, 5, 55, 57, 21, 27, 54, 58, 37, 43, 72, 4,
    71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69,
    75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62,
    120, 1, 119, 121, 83, 93, 17, 31, 100, 108, 66, 78,
    118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125,
    81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112,
};

// ------------------------------------------------------------ VP8 (lossy)

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// 4x4 intra modes, numbered as the tree's leaves
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU,
       // 16x16 and chroma DC at the frame's edges
       DC_NOTOP, DC_NOLEFT, DC_NOTOPLEFT };
const int8_t kYModesIntra4[18] = {
    -B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR,
    -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

// The boolean entropy decoder of RFC 6386 section 7 (past the end of its
// data it reads zeros).
struct BoolDecoder {
  const uint8_t* p = nullptr;
  const uint8_t* end = nullptr;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  uint8_t next() { return p < end ? *p++ : 0; }
  void init(const uint8_t* d, size_t n) {
    p = d;
    end = d + n;
    value = (uint32_t(next()) << 8) | next();
    range = 255;
    bit_count = 0;
  }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8);
    const uint32_t big = split << 8;
    int ret;
    if (value >= big) {
      ret = 1;
      range -= split;
      value -= big;
    } else {
      ret = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return ret;
  }
  int value_bits(int n) {
    int v = 0;
    while (n-- > 0) v |= bit(0x80) << n;
    return v;
  }
  int signed_value(int n) {
    const int v = value_bits(n);
    return bit(0x80) ? -v : v;
  }
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t uvmode, is_i4x4, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  int limit, ilevel, hev_thresh, inner;
};

inline uint8_t clip8(int v) { return v < 0 ? 0 : v > 255 ? 255 : uint8_t(v); }

constexpr int BPS = 32;  // the work buffer's stride

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void transform_one(const int16_t* in, uint8_t* dst) {
  auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
  auto mul2 = [](int a) { return (a * 35468) >> 16; };
  int C[16], *tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8], b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = int16_t((a0 + a1) >> 3);
    out[16] = int16_t((a3 + a2) >> 3);
    out[32] = int16_t((a0 - a1) >> 3);
    out[48] = int16_t((a3 - a2) >> 3);
    out += 64;
  }
}

// ---- intra prediction into the work buffer (dst[-BPS] is the top row,
// dst[-1] the left column)

void fill(uint8_t* dst, int size, int v) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1 + y * BPS];
    for (int x = 0; x < size; ++x) dst[y * BPS + x] = clip8(top[x] + l - tl);
  }
}

void predict_big(uint8_t* dst, int size, int mode) {
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case B_DC: {
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case DC_NOTOP: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOLEFT: {
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case DC_NOTOPLEFT:
      fill(dst, size, 0x80);
      break;
    case B_TM:
      true_motion(dst, size);
      break;
    case B_VE:
      for (int j = 0; j < size; ++j) memcpy(dst + j * BPS, dst - BPS, size);
      break;
    case B_HE:
      for (int j = 0; j < size; ++j) memset(dst + j * BPS, dst[j * BPS - 1], size);
      break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]

void predict4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS];
  const int L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      dc >>= 3;
      for (int j = 0; j < 4; ++j) memset(dst + j * BPS, dc, 4);
      break;
    }
    case B_TM:
      true_motion(dst, 4);
      break;
    case B_VE: {
      const uint8_t v[4] = {uint8_t(avg3(X, A, B)), uint8_t(avg3(A, B, C)),
                            uint8_t(avg3(B, C, D)), uint8_t(avg3(C, D, E))};
      for (int j = 0; j < 4; ++j) memcpy(dst + j * BPS, v, 4);
      break;
    }
    case B_HE: {
      const int r[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int j = 0; j < 4; ++j) memset(dst + j * BPS, r[j], 4);
      break;
    }
    case B_RD:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_LD:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VR:
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case B_VL:
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case B_HU:
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
      break;
    case B_HD:
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
  }
}

#undef DST

// ---- the loop filters (on a plane of stride `st`)

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it &&
         std::abs(p1 - p0) <= it && std::abs(q3 - q2) <= it &&
         std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// across an edge: `hstride` steps across it, `vstride` along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}

void edge(uint8_t* p, int hstride, int vstride, int size, int thresh,
          int ithresh, int hev_t, bool mb_edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (mb_edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

struct Planes {
  int stride_y, stride_uv;
  std::vector<uint8_t> y, u, v;
};

struct VP8Decoder {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int seg_proba[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  // dequantisation, per segment: y1 dc/ac, y2 dc/ac, uv dc/ac
  int dq[4][6];
  uint8_t proba[4][8][3][11];
  int use_skip_proba = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  void parse_headers(const uint8_t* data, size_t n);
  void decode(const uint8_t* data, size_t n, Planes& out);
  int get_coeffs(BoolDecoder& tbr, int type, int ctx, const int* dqm, int first,
                 int16_t* out);
};

void VP8Decoder::parse_headers(const uint8_t* data, size_t n) {
  if (n < 10) throw Error("VP8: the frame header is cut short");
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int key_frame = !(bits & 1);
  const int profile = (bits >> 1) & 7;
  const int show = (bits >> 4) & 1;
  const uint32_t part0 = bits >> 5;
  if (!key_frame) throw Error("VP8: not a key frame");
  if (profile > 3) throw Error("VP8: unknown profile");
  if (!show) throw Error("VP8: frame not shown");
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    throw Error("VP8: bad start code");
  width = (data[6] | (data[7] << 8)) & 0x3fff;
  height = (data[8] | (data[9] << 8)) & 0x3fff;
  if (!width || !height) throw Error("VP8: zero size");
  mb_w = (width + 15) >> 4;
  mb_h = (height + 15) >> 4;
  data += 10;
  n -= 10;
  if (part0 > n) throw Error("VP8: the first partition is cut short");
  br.init(data, part0);
  br.bit(0x80);  // colour space
  br.bit(0x80);  // clamping type
  use_segment = br.bit(0x80);
  if (use_segment) {
    update_map = br.bit(0x80);
    if (br.bit(0x80)) {
      absolute_delta = br.bit(0x80);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.bit(0x80) ? br.signed_value(7) : 0;
      for (int s = 0; s < 4; ++s)
        filter_strength[s] = br.bit(0x80) ? br.signed_value(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) seg_proba[s] = br.bit(0x80) ? br.value_bits(8) : 255;
  }
  simple = br.bit(0x80);
  level = br.value_bits(6);
  sharpness = br.value_bits(3);
  use_lf_delta = br.bit(0x80);
  if (use_lf_delta && br.bit(0x80)) {
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) ref_lf_delta[i] = br.signed_value(6);
    for (int i = 0; i < 4; ++i)
      if (br.bit(0x80)) mode_lf_delta[i] = br.signed_value(6);
  }
  filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // partitions
  const uint8_t* buf = data + part0;
  size_t size_left = n - part0;
  const int last = (1 << br.value_bits(2)) - 1;
  if (size_left < size_t(3 * last)) throw Error("VP8: partition sizes cut short");
  const uint8_t* sz = buf;
  const uint8_t* part = buf + 3 * last;
  size_left -= 3 * last;
  parts.assign(last + 1, BoolDecoder());
  for (int p = 0; p < last; ++p) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > size_left) psize = size_left;
    parts[p].init(part, psize);
    part += psize;
    size_left -= psize;
    sz += 3;
  }
  parts[last].init(part, size_left);
  if (size_left == 0) throw Error("VP8: the last partition is empty");
  // quantisers
  const int base_q0 = br.value_bits(7);
  int dqd[5];
  for (int i = 0; i < 5; ++i) dqd[i] = br.bit(0x80) ? br.signed_value(4) : 0;
  auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
  for (int i = 0; i < 4; ++i) {
    int q;
    if (use_segment) {
      q = quantizer[i] + (absolute_delta ? 0 : base_q0);
    } else if (i > 0) {
      memcpy(dq[i], dq[0], sizeof(dq[0]));
      continue;
    } else {
      q = base_q0;
    }
    int* m = dq[i];
    m[0] = kDcTable[clip(q + dqd[0], 127)];
    m[1] = kAcTable[clip(q, 127)];
    m[2] = kDcTable[clip(q + dqd[1], 127)] * 2;
    m[3] = (kAcTable[clip(q + dqd[2], 127)] * 101581) >> 16;
    if (m[3] < 8) m[3] = 8;
    m[4] = kDcTable[clip(q + dqd[3], 117)];
    m[5] = kAcTable[clip(q + dqd[4], 127)];
  }
  br.bit(0x80);  // refresh entropy probabilities (one frame: ignored)
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) {
          const int k = ((t * 8 + b) * 3 + c) * 11 + p;
          proba[t][b][c][p] =
              br.bit(kCoeffsUpdateProba[k]) ? br.value_bits(8) : kCoeffsProba0[k];
        }
  use_skip_proba = br.bit(0x80);
  if (use_skip_proba) skip_p = br.value_bits(8);
  // filter strengths
  for (int s = 0; s < 4; ++s) {
    int base = level;
    if (use_segment) base = filter_strength[s] + (absolute_delta ? 0 : level);
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FInfo& f = fstrengths[s][i4x4];
      int lv = base;
      if (use_lf_delta) {
        lv += ref_lf_delta[0];
        if (i4x4) lv += mode_lf_delta[0];
      }
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          if (il > 9 - sharpness) il = 9 - sharpness;
        }
        if (il < 1) il = 1;
        f.ilevel = il;
        f.limit = 2 * lv + il;
        f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      } else {
        f.limit = 0;
        f.ilevel = 0;
        f.hev_thresh = 0;
      }
      f.inner = i4x4;
    }
  }
}

int VP8Decoder::get_coeffs(BoolDecoder& tbr, int type, int ctx, const int* dqm,
                           int n, int16_t* out) {
  const uint8_t* p = proba[type][kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!tbr.bit(p[0])) return n;
    while (!tbr.bit(p[1])) {
      ++n;
      if (n == 16) return 16;
      p = proba[type][kBands[n]][0];
    }
    int v;
    const int band_next = kBands[n + 1];
    if (!tbr.bit(p[2])) {
      v = 1;
      p = proba[type][band_next][1];
    } else {
      if (!tbr.bit(p[3])) {
        if (!tbr.bit(p[4])) v = 2;
        else v = 3 + tbr.bit(p[5]);
      } else if (!tbr.bit(p[6])) {
        if (!tbr.bit(p[7])) {
          v = 5 + tbr.bit(159);
        } else {
          v = 7 + 2 * tbr.bit(165);
          v += tbr.bit(145);
        }
      } else {
        const int bit1 = tbr.bit(p[8]);
        const int bit0 = tbr.bit(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tbr.bit(*tab);
        v += 3 + (8 << cat);
      }
      p = proba[type][band_next][2];
    }
    const int s = tbr.bit(0x80) ? -v : v;
    out[kZigzag[n]] = int16_t(s * dqm[n > 0]);
  }
  return 16;
}

inline uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

void VP8Decoder::decode(const uint8_t* data, size_t n, Planes& out) {
  parse_headers(data, n);
  const int sy = mb_w * 16, suv = mb_w * 8;
  out.stride_y = sy;
  out.stride_uv = suv;
  out.y.assign(size_t(sy) * mb_h * 16, 0);
  out.u.assign(size_t(suv) * mb_h * 8, 0);
  out.v.assign(size_t(suv) * mb_h * 8, 0);
  std::vector<FInfo> finfo(size_t(mb_w) * mb_h);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
  std::vector<uint8_t> nz_top(mb_w, 0), nz_dc_top(mb_w, 0);
  // unfiltered bottom rows of the macroblocks above: y 16, u 8, v 8
  std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  std::vector<MBData> row(mb_w);
  // work buffer: 1 + 16 luma rows, then 1 + 8 rows of u and v side by side
  uint8_t work[BPS * 17 + BPS * 9];
  uint8_t* const y_dst = work + BPS + 8;
  uint8_t* const u_dst = work + BPS * 17 + BPS + 8;
  uint8_t* const v_dst = u_dst + 16;
  const int kScan[16] = {0 + 0 * BPS,  4 + 0 * BPS,  8 + 0 * BPS,  12 + 0 * BPS,
                         0 + 4 * BPS,  4 + 4 * BPS,  8 + 4 * BPS,  12 + 4 * BPS,
                         0 + 8 * BPS,  4 + 8 * BPS,  8 + 8 * BPS,  12 + 8 * BPS,
                         0 + 12 * BPS, 4 + 12 * BPS, 8 + 12 * BPS, 12 + 12 * BPS};
  const int last_part = int(parts.size()) - 1;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    // intra modes of the row, from the first partition
    uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& b = row[mb_x];
      uint8_t* top = &intra_t[4 * mb_x];
      if (update_map) {
        b.segment = !br.bit(seg_proba[0]) ? br.bit(seg_proba[1])
                                          : br.bit(seg_proba[2]) + 2;
      } else {
        b.segment = 0;
      }
      b.skip = use_skip_proba ? br.bit(skip_p) : 0;
      b.is_i4x4 = !br.bit(145);
      if (!b.is_i4x4) {
        const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE)
                                      : (br.bit(163) ? B_VE : B_DC);
        b.imodes[0] = uint8_t(ymode);
        memset(top, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = b.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
            int i = kYModesIntra4[br.bit(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
            ymode = -i;
            top[x] = uint8_t(ymode);
          }
          memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = uint8_t(ymode);
        }
      }
      b.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
    }
    // residuals
    BoolDecoder& tbr = parts[mb_y & last_part];
    uint8_t nz_left = 0, nz_dc_left = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBData& b = row[mb_x];
      const int* q = dq[b.segment];
      int skip = b.skip;
      if (!skip) {
        int16_t* dst = b.coeffs;
        memset(dst, 0, sizeof(b.coeffs));
        uint32_t non_zero_y = 0, non_zero_uv = 0;
        int first, ac_type;
        if (!b.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = nz_dc_top[mb_x] + nz_dc_left;
          const int nzd = get_coeffs(tbr, 1, ctx, q + 2, 0, dc);
          nz_dc_top[mb_x] = nz_dc_left = nzd > 0;
          if (nzd > 1) {
            transform_wht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 256; i += 16) dst[i] = int16_t(dc0);
          }
          first = 1;
          ac_type = 0;
        } else {
          first = 0;
          ac_type = 3;
        }
        uint8_t tnz = nz_top[mb_x] & 0x0f, lnz = nz_left & 0x0f;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          uint32_t nz_coeffs = 0;
          for (int x = 0; x < 4; ++x) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(tbr, ac_type, ctx, q, first, dst);
            l = nz > first;
            tnz = uint8_t((tnz >> 1) | (l << 7));
            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
          }
          tnz >>= 4;
          lnz = uint8_t((lnz >> 1) | (l << 7));
          non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        uint32_t out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t nz_coeffs = 0;
          tnz = uint8_t(nz_top[mb_x] >> (4 + ch));
          lnz = uint8_t(nz_left >> (4 + ch));
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              const int ctx = l + (tnz & 1);
              const int nz = get_coeffs(tbr, 2, ctx, q + 4, 0, dst);
              l = nz > 0;
              tnz = uint8_t((tnz >> 1) | (l << 3));
              nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
              dst += 16;
            }
            tnz >>= 2;
            lnz = uint8_t((lnz >> 1) | (l << 5));
          }
          non_zero_uv |= nz_coeffs << (4 * ch);
          out_t |= uint32_t(tnz << 4) << ch;
          out_l |= uint32_t(lnz & 0xf0) << ch;
        }
        nz_top[mb_x] = uint8_t(out_t);
        nz_left = uint8_t(out_l);
        b.non_zero_y = non_zero_y;
        b.non_zero_uv = non_zero_uv;
        skip = !(non_zero_y | non_zero_uv);
      } else {
        nz_top[mb_x] = nz_left = 0;
        if (!b.is_i4x4) nz_dc_top[mb_x] = nz_dc_left = 0;
        b.non_zero_y = b.non_zero_uv = 0;
        memset(b.coeffs, 0, sizeof(b.coeffs));
      }
      if (filter_type > 0) {
        FInfo f = fstrengths[b.segment][b.is_i4x4];
        f.inner |= !skip;
        finfo[size_t(mb_y) * mb_w + mb_x] = f;
      }
    }
    // reconstruction, as libwebp's ReconstructRow
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
      memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
      memset(u_dst - BPS - 1, 127, 8 + 1);
      memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBData& b = row[mb_x];
      if (mb_x > 0) {
        for (int j = -1; j < 16; ++j) memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
        for (int j = -1; j < 8; ++j) {
          memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
          memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
        }
      }
      if (mb_y > 0) {
        memcpy(y_dst - BPS, &top_y[16 * mb_x], 16);
        memcpy(u_dst - BPS, &top_u[8 * mb_x], 8);
        memcpy(v_dst - BPS, &top_v[8 * mb_x], 8);
      }
      const int16_t* coeffs = b.coeffs;
      if (b.is_i4x4) {
        uint8_t* top_right = y_dst - BPS + 16;
        if (mb_y > 0) {
          if (mb_x >= mb_w - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
          else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
        }
        for (int k = 1; k <= 3; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
        for (int i = 0; i < 16; ++i) {
          uint8_t* dst = y_dst + kScan[i];
          predict4(dst, b.imodes[i]);
          transform_one(coeffs + i * 16, dst);
        }
      } else {
        int mode = b.imodes[0];
        if (mode == B_DC)
          mode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                           : (mb_y == 0 ? DC_NOTOP : B_DC);
        predict_big(y_dst, 16, mode);
        for (int i = 0; i < 16; ++i) transform_one(coeffs + i * 16, y_dst + kScan[i]);
      }
      int uvmode = b.uvmode;
      if (uvmode == B_DC)
        uvmode = mb_x == 0 ? (mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT)
                           : (mb_y == 0 ? DC_NOTOP : B_DC);
      predict_big(u_dst, 8, uvmode);
      predict_big(v_dst, 8, uvmode);
      for (int i = 0; i < 4; ++i) {
        const int off = (i & 1) * 4 + (i >> 1) * 4 * BPS;
        transform_one(coeffs + 256 + i * 16, u_dst + off);
        transform_one(coeffs + 320 + i * 16, v_dst + off);
      }
      memcpy(&top_y[16 * mb_x], y_dst + 15 * BPS, 16);
      memcpy(&top_u[8 * mb_x], u_dst + 7 * BPS, 8);
      memcpy(&top_v[8 * mb_x], v_dst + 7 * BPS, 8);
      for (int j = 0; j < 16; ++j)
        memcpy(&out.y[size_t(mb_y * 16 + j) * sy + mb_x * 16], y_dst + j * BPS, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(&out.u[size_t(mb_y * 8 + j) * suv + mb_x * 8], u_dst + j * BPS, 8);
        memcpy(&out.v[size_t(mb_y * 8 + j) * suv + mb_x * 8], v_dst + j * BPS, 8);
      }
    }
  }
  if (filter_type == 0) return;
  // the loop filter, macroblock by macroblock in raster order
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const FInfo& f = finfo[size_t(mb_y) * mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      uint8_t* yp = &out.y[size_t(mb_y * 16) * sy + mb_x * 16];
      if (filter_type == 1) {
        if (mb_x > 0) simple_edge(yp, 1, sy, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k, 1, sy, limit);
        if (mb_y > 0) simple_edge(yp, sy, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_edge(yp + 4 * k * sy, sy, 1, limit);
      } else {
        uint8_t* up = &out.u[size_t(mb_y * 8) * suv + mb_x * 8];
        uint8_t* vp = &out.v[size_t(mb_y * 8) * suv + mb_x * 8];
        const int il = f.ilevel, hv = f.hev_thresh;
        if (mb_x > 0) {
          edge(yp, 1, sy, 16, limit + 4, il, hv, true);
          edge(up, 1, suv, 8, limit + 4, il, hv, true);
          edge(vp, 1, suv, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) edge(yp + 4 * k, 1, sy, 16, limit, il, hv, false);
          edge(up + 4, 1, suv, 8, limit, il, hv, false);
          edge(vp + 4, 1, suv, 8, limit, il, hv, false);
        }
        if (mb_y > 0) {
          edge(yp, sy, 1, 16, limit + 4, il, hv, true);
          edge(up, suv, 1, 8, limit + 4, il, hv, true);
          edge(vp, suv, 1, 8, limit + 4, il, hv, true);
        }
        if (f.inner) {
          for (int k = 1; k <= 3; ++k) edge(yp + 4 * k * sy, sy, 1, 16, limit, il, hv, false);
          edge(up + 4 * suv, suv, 1, 8, limit, il, hv, false);
          edge(vp + 4 * suv, suv, 1, 8, limit, il, hv, false);
        }
      }
    }
  }
}

// libwebp's fixed-point YUV -> RGB (14-bit coefficients, 6 fraction bits)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) {
  return ((v & ~16383) == 0) ? uint8_t(v >> 6) : (v < 0) ? 0 : 255;
}
inline void yuv_to_rgba(int y, int u, int v, uint8_t* rgba) {
  rgba[0] = yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgba[1] = yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgba[2] = yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  rgba[3] = 255;
}

// libwebp's "fancy" upsampler: one pair of output rows from two chroma rows
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y,
                   const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
  yuv_to_rgba(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
  if (bottom_y)
    yuv_to_rgba(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                bottom_dst);
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = top_u[x], t_v = top_v[x], c_u = cur_u[x], c_v = cur_v[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    yuv_to_rgba(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1,
                top_dst + (2 * x - 1) * 4);
    yuv_to_rgba(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 2 * x * 4);
    if (bottom_y) {
      yuv_to_rgba(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                  bottom_dst + (2 * x - 1) * 4);
      yuv_to_rgba(bottom_y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1,
                  bottom_dst + 2 * x * 4);
    }
    tl_u = t_u;
    tl_v = t_v;
    l_u = c_u;
    l_v = c_v;
  }
  if (!(len & 1)) {
    yuv_to_rgba(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                top_dst + (len - 1) * 4);
    if (bottom_y)
      yuv_to_rgba(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                  bottom_dst + (len - 1) * 4);
  }
}

// a VP8 frame's RGBA (alpha 255) into rows of `stride` bytes
void vp8_to_rgba(const uint8_t* data, size_t n, int want_w, int want_h, uint8_t* out,
                 int64_t stride) {
  VP8Decoder dec;
  Planes pl;
  dec.decode(data, n, pl);
  if (dec.width != want_w || dec.height != want_h)
    throw Error("VP8: the frame size differs from its container's");
  const int w = dec.width, h = dec.height;
  const uint8_t* Y = pl.y.data();
  const uint8_t* U = pl.u.data();
  const uint8_t* V = pl.v.data();
  const int sy = pl.stride_y, suv = pl.stride_uv;
  upsample_pair(Y, nullptr, U, V, U, V, out, nullptr, w);
  int y = 0;
  for (; y + 2 < h; y += 2) {
    const int k = y / 2;
    upsample_pair(Y + size_t(y + 1) * sy, Y + size_t(y + 2) * sy, U + size_t(k) * suv,
                  V + size_t(k) * suv, U + size_t(k + 1) * suv, V + size_t(k + 1) * suv,
                  out + (y + 1) * stride, out + (y + 2) * stride, w);
  }
  if (!(h & 1)) {
    const int k = (h - 1) / 2;
    upsample_pair(Y + size_t(h - 1) * sy, nullptr, U + size_t(k) * suv, V + size_t(k) * suv,
                  U + size_t(k) * suv, V + size_t(k) * suv, out + (h - 1) * stride, nullptr, w);
  }
}

// --------------------------------------------------------- VP8L (lossless)

struct BitReader {
  const uint8_t* p;
  size_t n, pos = 0;  // pos in bits
  BitReader(const uint8_t* d, size_t size) : p(d), n(size) {}
  uint32_t bits(int k) {
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) {
      const size_t byte = pos >> 3;
      if (byte >= n) throw Error("VP8L: the bitstream is cut short");
      v |= uint32_t((p[byte] >> (pos & 7)) & 1) << i;
    }
    return v;
  }
  int bit() { return int(bits(1)); }
};

// A canonical prefix code (as deflate's): the first bit read is the
// code's most significant; a code of one symbol takes no bits.
struct Huffman {
  int single = -1;
  std::vector<int> count, symbols;  // count[len], symbols by (len, symbol)
  void build(const std::vector<int>& lengths) {
    count.assign(16, 0);
    symbols.clear();
    int nonzero = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) ++count[lengths[s]], ++nonzero, last = int(s);
    if (nonzero == 0) throw Error("VP8L: an empty prefix code");
    if (nonzero == 1) {
      single = last;
      return;
    }
    single = -1;
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) throw Error("VP8L: an over-subscribed prefix code");
    }
    if (left > 0) throw Error("VP8L: an incomplete prefix code");
    for (int len = 1; len < 16; ++len)
      for (size_t s = 0; s < lengths.size(); ++s)
        if (lengths[s] == len) symbols.push_back(int(s));
  }
  int read(BitReader& br) const {
    if (single >= 0) return single;
    int code = 0, first = 0, index = 0;
    for (int len = 1; len < 16; ++len) {
      code |= br.bit();
      const int c = count[len];
      if (code - first < c) return symbols[index + code - first];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    throw Error("VP8L: a bad prefix code");
  }
};

const int kCodeLengthCodeOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7, 8, 9, 10, 11, 12, 13, 14, 15};

Huffman read_code(BitReader& br, int alphabet) {
  std::vector<int> lengths(alphabet, 0);
  if (br.bit()) {  // simple code
    const int num = br.bit() + 1;
    const int first_8bit = br.bit();
    const int s0 = int(br.bits(first_8bit ? 8 : 1));
    if (s0 >= alphabet) throw Error("VP8L: a symbol past its alphabet");
    lengths[s0] = 1;
    if (num == 2) {
      const int s1 = int(br.bits(8));
      if (s1 >= alphabet) throw Error("VP8L: a symbol past its alphabet");
      lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num_codes = int(br.bits(4)) + 4;
    for (int i = 0; i < num_codes; ++i) cl[kCodeLengthCodeOrder[i]] = int(br.bits(3));
    Huffman lens;
    lens.build(cl);
    int max_symbol = alphabet;
    if (br.bit()) {
      const int length_nbits = 2 + 2 * int(br.bits(3));
      max_symbol = 2 + int(br.bits(length_nbits));
      if (max_symbol > alphabet) throw Error("VP8L: max_symbol past its alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int code_len = lens.read(br);
      if (code_len < 16) {
        lengths[symbol++] = code_len;
        if (code_len) prev = code_len;
      } else {
        const int slot = code_len - 16;
        const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int repeat = int(br.bits(extra[slot])) + offset[slot];
        if (symbol + repeat > alphabet) throw Error("VP8L: a repeat past its alphabet");
        const int len = code_len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = len;
      }
    }
  }
  Huffman h;
  h.build(lengths);
  return h;
}

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline int copy_distance(int symbol, BitReader& br) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const int offset = (2 + (symbol & 1)) << extra;
  return offset + int(br.bits(extra)) + 1;
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct VP8LDecoder {
  BitReader br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  explicit VP8LDecoder(BitReader b) : br(b) {}

  std::vector<uint32_t> image_stream(int xsize, int ysize, bool level0);
  void decode_image_data(std::vector<uint32_t>& out, int xsize, int ysize, int cache_bits,
                         const std::vector<std::vector<Huffman>>& groups,
                         const std::vector<uint32_t>& meta, int meta_bits);
};

std::vector<uint32_t> VP8LDecoder::image_stream(int xsize, int ysize, bool level0) {
  int tx = xsize;
  if (level0) {
    while (br.bit()) {
      const int type = int(br.bits(2));
      if (seen & (1u << type)) throw Error("VP8L: a transform used twice");
      seen |= 1u << type;
      Transform t;
      t.type = type;
      t.xsize = tx;
      t.ysize = ysize;
      t.bits = 0;
      if (type == 0 || type == 1) {
        t.bits = int(br.bits(3)) + 2;
        t.data = image_stream(sub_sample(tx, t.bits), sub_sample(ysize, t.bits), false);
      } else if (type == 3) {
        const int num_colors = int(br.bits(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        tx = sub_sample(t.xsize, t.bits);
        std::vector<uint32_t> pal = image_stream(num_colors, 1, false);
        const int final_colors = 1 << (8 >> t.bits);
        t.data.assign(final_colors, 0);
        uint8_t* nd = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* od = reinterpret_cast<const uint8_t*>(pal.data());
        for (int i = 0; i < 4; ++i) nd[i] = od[i];
        for (int i = 4; i < 4 * num_colors; ++i) nd[i] = uint8_t(od[i] + nd[i - 4]);
      }
      transforms.push_back(std::move(t));
    }
  }
  int cache_bits = 0;
  if (br.bit()) {
    cache_bits = int(br.bits(4));
    if (cache_bits < 1 || cache_bits > 11) throw Error("VP8L: bad colour cache size");
  }
  std::vector<uint32_t> meta;
  int meta_bits = 0, num_groups = 1;
  if (level0 && br.bit()) {
    meta_bits = int(br.bits(3)) + 2;
    meta = image_stream(sub_sample(tx, meta_bits), sub_sample(ysize, meta_bits), false);
    num_groups = 0;
    for (auto& m : meta) {
      m = (m >> 8) & 0xffff;
      if (int(m) + 1 > num_groups) num_groups = int(m) + 1;
    }
  }
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<std::vector<Huffman>> groups(num_groups);
  for (auto& g : groups)
    for (int k = 0; k < 5; ++k) g.push_back(read_code(br, alphabets[k]));
  std::vector<uint32_t> out(size_t(tx) * ysize);
  decode_image_data(out, tx, ysize, cache_bits, groups, meta, meta_bits);
  return out;
}

void VP8LDecoder::decode_image_data(std::vector<uint32_t>& out, int xsize, int ysize,
                                    int cache_bits,
                                    const std::vector<std::vector<Huffman>>& groups,
                                    const std::vector<uint32_t>& meta, int meta_bits) {
  std::vector<uint32_t> cache(cache_bits ? size_t(1) << cache_bits : 0, 0);
  const int meta_w = meta_bits ? sub_sample(xsize, meta_bits) : 0;
  const size_t total = size_t(xsize) * ysize;
  size_t pos = 0;
  int col = 0, row = 0;
  auto insert = [&](uint32_t argb) {
    if (cache_bits) cache[(0x1e35a7bdu * argb) >> (32 - cache_bits)] = argb;
  };
  while (pos < total) {
    const std::vector<Huffman>& g =
        meta_bits ? groups[meta[size_t(row >> meta_bits) * meta_w + (col >> meta_bits)]]
                  : groups[0];
    const int code = g[0].read(br);
    if (code < 256) {
      const int red = g[1].read(br), blue = g[2].read(br), alpha = g[3].read(br);
      const uint32_t argb = (uint32_t(alpha) << 24) | (red << 16) | (code << 8) | blue;
      out[pos++] = argb;
      insert(argb);
      if (++col >= xsize) col = 0, ++row;
    } else if (code < 256 + 24) {
      const int length = copy_distance(code - 256, br);
      const int dist_symbol = g[4].read(br);
      const int dist_code = copy_distance(dist_symbol, br);
      int dist;
      if (dist_code > 120) {
        dist = dist_code - 120;
      } else {
        const int c = kCodeToPlane[dist_code - 1];
        const int yoff = c >> 4, xoff = 8 - (c & 0xf);
        dist = yoff * xsize + xoff;
        if (dist < 1) dist = 1;
      }
      if (size_t(dist) > pos || total - pos < size_t(length))
        throw Error("VP8L: a backward reference out of the image");
      for (int i = 0; i < length; ++i, ++pos) {
        out[pos] = out[pos - dist];
        insert(out[pos]);
      }
      col += length;
      while (col >= xsize) col -= xsize, ++row;
    } else {
      const int key = code - 256 - 24;
      if (!cache_bits || key >= int(cache.size())) throw Error("VP8L: bad colour cache code");
      out[pos++] = cache[key];
      if (++col >= xsize) col = 0, ++row;
    }
  }
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int clip255(int a) { return a < 0 ? 0 : a > 255 ? 255 : a; }
inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= uint32_t(clip255(int((c0 >> s) & 0xff) + int((c1 >> s) & 0xff) -
                            int((c2 >> s) & 0xff))) << s;
  return out;
}
inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
  const uint32_t ave = average2(c0, c1);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
    out |= uint32_t(clip255(a + (a - b) / 2)) << s;
  }
  return out;
}
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {  // a = T, b = L, c = TL
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ac = int((a >> s) & 0xff), bc = int((b >> s) & 0xff), cc = int((c >> s) & 0xff);
    pa_minus_pb += std::abs(bc - cc) - std::abs(ac - cc);
  }
  return pa_minus_pb <= 0 ? a : b;
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TR, uint32_t TL) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return clamped_add_subtract_full(L, T, TL);
    case 13: return clamped_add_subtract_half(L, T, TL);
    default: return 0xff000000u;
  }
}

// the inverse transforms, last read first; returns [height, width] ARGB
std::vector<uint32_t> vp8l_pixels(const uint8_t* data, size_t n, int w, int h) {
  VP8LDecoder dec{BitReader(data, n)};
  std::vector<uint32_t> img = dec.image_stream(w, h, true);
  for (int ti = int(dec.transforms.size()) - 1; ti >= 0; --ti) {
    const Transform& t = dec.transforms[ti];
    const int W = t.xsize, H = t.ysize;
    if (t.type == 0) {  // predictor
      const int tw = sub_sample(W, t.bits);
      for (int y = 0; y < H; ++y) {
        uint32_t* rowp = &img[size_t(y) * W];
        const uint32_t* up = y ? rowp - W : nullptr;
        for (int x = 0; x < W; ++x) {
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xff000000u : rowp[x - 1];
          } else if (x == 0) {
            pred = up[0];
          } else {
            const int mode = (t.data[size_t(y >> t.bits) * tw + (x >> t.bits)] >> 8) & 0xf;
            // the top-right of the last column is the row's first pixel
            const uint32_t tr = x + 1 < W ? up[x + 1] : rowp[0];
            pred = predict(mode, rowp[x - 1], up[x], tr, up[x - 1]);
          }
          rowp[x] = add_pixels(rowp[x], pred);
        }
      }
    } else if (t.type == 1) {  // cross colour
      const int tw = sub_sample(W, t.bits);
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          const uint32_t m = t.data[size_t(y >> t.bits) * tw + (x >> t.bits)];
          const int8_t g2r = int8_t(m & 0xff), g2b = int8_t((m >> 8) & 0xff);
          const int8_t r2b = int8_t((m >> 16) & 0xff);
          uint32_t& px = img[size_t(y) * W + x];
          const int8_t green = int8_t(px >> 8);
          int red = (px >> 16) & 0xff, blue = px & 0xff;
          red += (int(g2r) * green) >> 5;
          red &= 0xff;
          blue += (int(g2b) * green) >> 5;
          blue += (int(r2b) * int8_t(red)) >> 5;
          blue &= 0xff;
          px = (px & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
        }
    } else if (t.type == 2) {  // subtract green
      for (auto& px : img) {
        const uint32_t g = (px >> 8) & 0xff;
        const uint32_t rb = ((px & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        px = (px & 0xff00ff00u) | rb;
      }
    } else {  // colour indexing, with pixel packing
      const int packed_w = sub_sample(W, t.bits);
      const int bpp = 8 >> t.bits, per = 1 << t.bits, mask = (1 << bpp) - 1;
      std::vector<uint32_t> out(size_t(W) * H);
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          const uint32_t packed = img[size_t(y) * packed_w + x / per];
          const int idx = int((packed >> 8) >> ((x % per) * bpp)) & mask;
          out[size_t(y) * W + x] = t.data[size_t(idx)];
        }
      img.swap(out);
    }
  }
  if (img.size() != size_t(w) * h) throw Error("VP8L: the image size is inconsistent");
  return img;
}

void vp8l_to_rgba(const uint8_t* data, size_t n, int want_w, int want_h, uint8_t* out,
                  int64_t stride) {
  if (n < 5 || data[0] != 0x2f) throw Error("VP8L: bad signature");
  const uint32_t hdr = data[1] | (data[2] << 8) | (data[3] << 16) | (uint32_t(data[4]) << 24);
  const int w = int(hdr & 0x3fff) + 1, h = int((hdr >> 14) & 0x3fff) + 1;
  if ((hdr >> 29) != 0) throw Error("VP8L: unknown version");
  if (w != want_w || h != want_h) throw Error("VP8L: the frame size differs from its container's");
  std::vector<uint32_t> img = vp8l_pixels(data + 5, n - 5, w, h);
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const uint32_t a = img[size_t(y) * w + x];
      uint8_t* o = out + y * stride + 4 * x;
      o[0] = uint8_t(a >> 16);
      o[1] = uint8_t(a >> 8);
      o[2] = uint8_t(a);
      o[3] = uint8_t(a >> 24);
    }
}

// the ALPH chunk's alpha into byte 3 of each pixel
void alph_to_rgba(const uint8_t* data, size_t n, int w, int h, uint8_t* out, int64_t stride) {
  if (n < 1) throw Error("ALPH: empty chunk");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3;
  const int pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) throw Error("ALPH: unknown header");
  std::vector<uint8_t> a(size_t(w) * h);
  if (method == 0) {
    if (n - 1 < a.size()) throw Error("ALPH: the raw alpha is cut short");
    memcpy(a.data(), data + 1, a.size());
  } else {
    std::vector<uint32_t> img = vp8l_pixels(data + 1, n - 1, w, h);
    for (size_t i = 0; i < a.size(); ++i) a[i] = uint8_t(img[i] >> 8);
  }
  for (int y = 0; y < h; ++y) {
    uint8_t* rowp = &a[size_t(y) * w];
    const uint8_t* prev = y ? rowp - w : nullptr;
    if (filter == 1 || (filter > 1 && !prev)) {  // horizontal
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) pred = rowp[x] = uint8_t(pred + rowp[x]);
    } else if (filter == 2) {  // vertical
      for (int x = 0; x < w; ++x) rowp[x] = uint8_t(prev[x] + rowp[x]);
    } else if (filter == 3) {  // gradient
      uint8_t top = prev[0], top_left = top, left = top;
      for (int x = 0; x < w; ++x) {
        top = prev[x];
        const int g = left + top - top_left;
        const int pred = (g & ~0xff) == 0 ? g : g < 0 ? 0 : 255;
        left = uint8_t(rowp[x] + pred);
        top_left = top;
        rowp[x] = left;
      }
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) out[y * stride + 4 * x + 3] = a[size_t(y) * w + x];
}

}  // namespace

// One frame into the RGBA canvas at `out` (rows of `stride` bytes, the
// frame's top-left pixel first). kind 0: VP8 (with `alph` the ALPH
// chunk's payload, or null), 1: VP8L. Returns 0, or 1 with `err` set.
extern "C" int webp_frame(const uint8_t* data, int64_t n, int kind, const uint8_t* alph,
                          int64_t alph_n, int w, int h, uint8_t* out, int64_t stride,
                          char* err, int64_t err_n) {
  try {
    if (kind == 0) {
      vp8_to_rgba(data, size_t(n), w, h, out, stride);
      if (alph) alph_to_rgba(alph, size_t(alph_n), w, h, out, stride);
    } else {
      vp8l_to_rgba(data, size_t(n), w, h, out, stride);
    }
    return 0;
  } catch (const std::exception& e) {
    snprintf(err, size_t(err_n), "%s", e.what());
    return 1;
  }
}
