// The native pool's own image decoders (jpeg_decode.cpp, png_decode.cpp).
//
// Each decodes a whole file held in memory into 8-bit RGB, interleaved,
// row-major, and gives the bytes that the pool's decode gave when it was
// built on libjpeg-turbo 2.1 and libpng 1.6: libjpeg's default
// decompression to JCS_RGB (the accurate integer IDCT, fancy upsampling,
// its colour tables) and libpng's simplified API to PNG_FORMAT_RGB with
// no background (alpha composited onto black in linear light, 16-bit
// samples read as linear and encoded to sRGB).  A file either library
// refused makes the decoder return false; a truncated JPEG is completed
// as libjpeg completes it.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace znicz_native {

bool decode_jpeg_rgb(const uint8_t *buf, size_t len, std::vector<uint8_t> &px,
                     int &w, int &h);

bool decode_png_rgb(const uint8_t *buf, size_t len, std::vector<uint8_t> &px,
                    int &w, int &h);

}  // namespace znicz_native
