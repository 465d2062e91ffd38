// A JPEG decoder whose output is byte-equal to libjpeg-turbo 2.1's default
// decompression to JCS_RGB on x86: Huffman-coded sequential (SOF0, SOF1)
// and progressive (SOF2) 8-bit files, 1 or 3 components, the accurate
// integer IDCT (jpeg_idct_islow, with the arithmetic of its SIMD version),
// fancy upsampling, the YCbCr->RGB tables of jdcolor.c and, for a
// progressive file whose coefficients are not all refined, block smoothing
// (jdcoefct.c's decompress_smooth_data).  It follows libjpeg's handling
// of a damaged stream too: past the end of the file the source reads a
// fake EOI, the entropy decoder feeds zero bits after a marker, and the
// rest of a segment decodes as zeros.  What libjpeg refuses (CMYK/YCCK,
// 12-bit and lossless frames, a bad table) makes decode_jpeg_rgb return
// false, and so do arithmetic-coded frames (SOF9/SOF10), which libjpeg
// decodes.

#include "image_decode.h"

#include <cstring>
#include <new>

namespace znicz_native {
namespace {

struct Fail {};  // what libjpeg reports through error_exit

// zigzag index -> natural index, with 16 guard entries for corrupt runs
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ITU T.81 Annex K.3 tables, which libjpeg-turbo installs in table slots
// 0 and 1 when a file defines none there (Motion-JPEG frames)
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVal[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVal[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVal[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

enum Marker {
  kSOF0 = 0xC0, kSOF1 = 0xC1, kSOF2 = 0xC2, kSOF3 = 0xC3, kDHT = 0xC4,
  kSOF5 = 0xC5, kSOF6 = 0xC6, kSOF7 = 0xC7, kJPG = 0xC8, kSOF9 = 0xC9,
  kSOF10 = 0xCA, kSOF11 = 0xCB, kDAC = 0xCC, kSOF13 = 0xCD, kSOF14 = 0xCE,
  kSOF15 = 0xCF, kRST0 = 0xD0, kRST7 = 0xD7, kSOI = 0xD8, kEOI = 0xD9,
  kSOS = 0xDA, kDQT = 0xDB, kDNL = 0xDC, kDRI = 0xDD, kAPP0 = 0xE0,
  kAPP14 = 0xEE, kAPP15 = 0xEF, kCOM = 0xFE, kTEM = 0x01,
};

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {};
  uint8_t val[256] = {};
};

// jpeg_make_d_derived_tbl's bit-sequential tables, with a 9-bit lookahead
constexpr int kLook = 9;
struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t val[256];
  uint16_t look[1 << kLook];  // (length << 8) | symbol, 0: longer code
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int wib = 0, hib = 0;  // width and height in blocks
  int bw = 0, bh = 0;    // coefficient array, padded to the MCU
  int dw = 0, dh = 0;    // downsampled width and height in samples
  bool latched = false;
  uint16_t quant[64] = {};
  int coef_bits[64];
  int prev_coef_bits[64] = {};  // coef_bits before the latest scan
  int latch[10] = {}, prev_latch[10] = {};  // both as output starts
  std::vector<int16_t> coef;
  int16_t *block(int by, int bx) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

// ------------------------------------------------------------------ IDCT
// jidctint.c's accurate integer IDCT (CONST_BITS 13, PASS1_BITS 2) with the
// arithmetic of libjpeg-turbo's x86 SIMD version of it, which the library
// runs on every block here: 16-bit dequantized coefficients and 16-bit
// sums of pairs, 32-bit products and sums, each pass's results saturated
// to 16 bits, and the output saturated to -128..127 before the +128
// level shift.  On a valid stream every value is in range and this is the
// C routine's result; past the end of a truncated one the two differ, and
// the SIMD route is what libjpeg-turbo gives.
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t F_0_298 = 2446, F_0_390 = 3196, F_0_541 = 4433,
                  F_0_765 = 6270, F_0_899 = 7373, F_1_175 = 9633,
                  F_1_501 = 12299, F_1_847 = 15137, F_1_961 = 16069,
                  F_2_053 = 16819, F_2_562 = 20995, F_3_072 = 25172;

inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(x); }
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}
// (a + rounding) >> n on 32-bit lanes that wrap
inline int32_t descale32(int64_t x, int n) {
  uint32_t u = static_cast<uint32_t>(x) + (uint32_t{1} << (n - 1));
  return static_cast<int32_t>(u) >> n;
}

// One 8-point pass over d[0..7] (stride 1), the outputs before descaling.
inline void idct_1d(const int16_t *d, int64_t *out) {
  const int64_t tmp3e = int64_t{d[2]} * (F_0_541 + F_0_765) + int64_t{d[6]} * F_0_541;
  const int64_t tmp2e = int64_t{d[2]} * F_0_541 + int64_t{d[6]} * (F_0_541 - F_1_847);
  const int64_t tmp0e = int64_t{wrap16(d[0] + d[4])} * (1 << kConstBits);
  const int64_t tmp1e = int64_t{wrap16(d[0] - d[4])} * (1 << kConstBits);
  const int64_t tmp10 = tmp0e + tmp3e, tmp13 = tmp0e - tmp3e;
  const int64_t tmp11 = tmp1e + tmp2e, tmp12 = tmp1e - tmp2e;
  const int64_t z3 = wrap16(d[7] + d[3]), z4 = wrap16(d[5] + d[1]);
  const int64_t z3o = z3 * (F_1_175 - F_1_961) + z4 * F_1_175;
  const int64_t z4o = z3 * F_1_175 + z4 * (F_1_175 - F_0_390);
  const int64_t tmp0 = int64_t{d[7]} * (F_0_298 - F_0_899) + int64_t{d[1]} * -F_0_899 + z3o;
  const int64_t tmp3 = int64_t{d[7]} * -F_0_899 + int64_t{d[1]} * (F_1_501 - F_0_899) + z4o;
  const int64_t tmp1 = int64_t{d[5]} * (F_2_053 - F_2_562) + int64_t{d[3]} * -F_2_562 + z4o;
  const int64_t tmp2 = int64_t{d[5]} * -F_2_562 + int64_t{d[3]} * (F_3_072 - F_2_562) + z3o;
  out[0] = tmp10 + tmp3;
  out[7] = tmp10 - tmp3;
  out[1] = tmp11 + tmp2;
  out[6] = tmp11 - tmp2;
  out[2] = tmp12 + tmp1;
  out[5] = tmp12 - tmp1;
  out[3] = tmp13 + tmp0;
  out[4] = tmp13 - tmp0;
}

void idct_islow(const int16_t *in, const uint16_t *qt, uint8_t *out,
                size_t stride) {
  int16_t ws[64];  // row-major, as the coefficients
  bool ac_rows_zero = true;
  for (int k = 8; k < 64 && ac_rows_zero; ++k) ac_rows_zero = in[k] == 0;
  if (ac_rows_zero) {
    // the SIMD routine's shortcut: rows 1..7 all zero, a 16-bit shift
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = wrap16(in[c] * static_cast<int16_t>(qt[c]));
      const int16_t v = wrap16(static_cast<int32_t>(
          static_cast<uint32_t>(static_cast<uint16_t>(dc)) << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    }
  } else {
    for (int c = 0; c < 8; ++c) {
      int16_t d[8];
      for (int r = 0; r < 8; ++r)
        d[r] = wrap16(in[8 * r + c] * static_cast<int16_t>(qt[8 * r + c]));
      int64_t o[8];
      idct_1d(d, o);
      for (int r = 0; r < 8; ++r)
        ws[8 * r + c] = sat16(descale32(o[r], kConstBits - kPass1Bits));
    }
  }
  for (int r = 0; r < 8; ++r) {
    int64_t o[8];
    idct_1d(ws + 8 * r, o);
    uint8_t *op = out + stride * r;
    for (int c = 0; c < 8; ++c) {
      int32_t v = sat16(descale32(o[c], kConstBits + kPass1Bits + 3));
      v = v < -128 ? -128 : (v > 127 ? 127 : v);
      op[c] = static_cast<uint8_t>(v + 128);
    }
  }
}

// ---------------------------------------------------------------- colour
// jdcolor.c's build_ycc_rgb_table: SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t{1} << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (1L << kScale) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
};

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// ---------------------------------------------------------------- decoder
class Decoder {
 public:
  Decoder(const uint8_t *buf, size_t len) : buf_(buf), len_(len) {}

  void run(std::vector<uint8_t> &px, int &w, int &h) {
    if (byte() != 0xFF || byte() != kSOI) throw Fail();  // JERR_NO_SOI
    if (read_markers(true) != kSOS) throw Fail();        // JERR_NO_IMAGE
    initial_setup();
    if (comps_in_scan_ == 0) throw Fail();  // JERR_COMPONENT_COUNT
    for (;;) {
      if (comps_in_scan_ > 0) decode_scan();
      int m = read_markers(false);
      if (m == kEOI) break;
      if (!multi_scan_) throw Fail();  // JERR_EOI_EXPECTED
    }
    output(px);
    w = width_;
    h = height_;
  }

 private:
  // ------------------------------------------------------------ input
  // jpeg_mem_src: past the end of the buffer the source reads FF D9
  int byte() {
    if (pos_ < len_) return buf_[pos_++];
    return ((pos_++ - len_) & 1) ? kEOI : 0xFF;
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }
  void skip(long n) {
    for (; n > 0 && pos_ < len_; --n) ++pos_;
    pos_ += n > 0 ? static_cast<size_t>(n) : 0;
  }

  // jdmarker.c's next_marker: skip to FF, swallow FF fill bytes and FF 00
  void next_marker() {
    for (;;) {
      int c = byte();
      while (c != 0xFF) c = byte();
      do {
        c = byte();
      } while (c == 0xFF);
      if (c != 0) {
        unread_marker_ = c;
        return;
      }
    }
  }

  // jdmarker.c's read_markers: returns kSOS or kEOI
  int read_markers(bool in_header) {
    for (;;) {
      if (unread_marker_ == 0) next_marker();
      int m = unread_marker_;
      unread_marker_ = 0;
      switch (m) {
        case kSOI:
          throw Fail();  // JERR_SOI_DUPLICATE
        case kSOF0:
        case kSOF1:
          get_sof(false);
          break;
        case kSOF2:
          get_sof(true);
          break;
        case kSOF9:   // arithmetic coding: not decoded here
        case kSOF10:
        case kSOF3:
        case kSOF5:
        case kSOF6:
        case kSOF7:
        case kJPG:
        case kSOF11:
        case kSOF13:
        case kSOF14:
        case kSOF15:
          throw Fail();  // JERR_SOF_UNSUPPORTED
        case kSOS:
          get_sos();
          return kSOS;
        case kEOI:
          if (in_header) throw Fail();  // JERR_NO_IMAGE
          return kEOI;
        case kDAC:
          get_dac();
          break;
        case kDHT:
          get_dht();
          break;
        case kDQT:
          get_dqt();
          break;
        case kDRI:
          if (u16() != 4) throw Fail();  // JERR_BAD_LENGTH
          restart_interval_ = u16();
          break;
        case kAPP0:
        case kAPP14:
          get_interesting_appn(m);
          break;
        case kDNL:
        case kCOM:
          skip(u16() - 2L);
          break;
        case kTEM:
          break;
        default:
          if (m >= kRST0 && m <= kRST7) break;  // parameterless
          if (m > kAPP0 && m <= kAPP15) {
            skip(u16() - 2L);
            break;
          }
          throw Fail();  // JERR_UNKNOWN_MARKER
      }
    }
  }

  void get_sof(bool progressive) {
    int length = u16();
    int precision = byte();
    int hh = u16(), ww = u16(), nc = byte();
    length -= 8;
    if (saw_sof_) throw Fail();                 // JERR_SOF_DUPLICATE
    if (hh <= 0 || ww <= 0 || nc <= 0) throw Fail();  // JERR_EMPTY_IMAGE
    if (length != nc * 3) throw Fail();         // JERR_BAD_LENGTH
    precision_ = precision;
    height_ = hh;
    width_ = ww;
    progressive_ = progressive;
    comps_.assign(nc, Component());
    for (auto &c : comps_) {
      c.id = byte();
      int s = byte();
      c.h = (s >> 4) & 15;
      c.v = s & 15;
      c.tq = byte();
      for (int &b : c.coef_bits) b = -1;
    }
    saw_sof_ = true;
  }

  void get_sos() {
    if (!saw_sof_) throw Fail();  // JERR_SOF_BEFORE
    int length = u16();
    int n = byte();
    if (length != n * 2 + 6 || n > 4 || (n == 0 && !progressive_))
      throw Fail();  // JERR_BAD_LENGTH
    comps_in_scan_ = n;
    Component *cur[4] = {nullptr, nullptr, nullptr, nullptr};
    const int nc = static_cast<int>(comps_.size());
    for (int i = 0; i < n; ++i) {
      int cc = byte(), c = byte();
      int found = -1;
      // jdmarker.c tests the scan slot at the component's frame index
      for (int ci = 0; ci < nc && ci < 4; ++ci) {
        if (cc == comps_[ci].id && !cur[ci]) {
          found = ci;
          break;
        }
      }
      if (found < 0) throw Fail();  // JERR_BAD_COMPONENT_ID
      cur[i] = &comps_[found];
      cur[i]->dc_tbl = (c >> 4) & 15;
      cur[i]->ac_tbl = c & 15;
    }
    for (int i = 0; i < 4; ++i) scan_[i] = cur[i];
    ss_ = byte();
    se_ = byte();
    int a = byte();
    ah_ = (a >> 4) & 15;
    al_ = a & 15;
    next_restart_num_ = 0;
    ++scan_number_;
  }

  void get_dac() {
    long length = u16() - 2L;
    while (length > 0) {
      int index = byte(), val = byte();
      length -= 2;
      if (index < 0 || index >= 32) throw Fail();  // JERR_DAC_INDEX
      if (index < 16 && (val & 15) > (val >> 4)) throw Fail();  // JERR_DAC_VALUE
    }
    if (length != 0) throw Fail();  // JERR_BAD_LENGTH
  }

  void get_dht() {
    long length = u16() - 2L;
    while (length > 16) {
      int index = byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = static_cast<uint8_t>(byte());
        count += bits[i];
      }
      length -= 1 + 16;
      if (count > 256 || count > length) throw Fail();  // JERR_BAD_HUFF_TABLE
      uint8_t val[256] = {0};
      for (int i = 0; i < count; ++i) val[i] = static_cast<uint8_t>(byte());
      length -= count;
      HuffSpec *t;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) throw Fail();  // JERR_DHT_INDEX
        t = &ac_spec_[index];
      } else {
        if (index < 0 || index >= 4) throw Fail();
        t = &dc_spec_[index];
      }
      t->defined = true;
      std::memcpy(t->bits, bits, sizeof(bits));
      std::memcpy(t->val, val, sizeof(val));
    }
    if (length != 0) throw Fail();  // JERR_BAD_LENGTH
  }

  void get_dqt() {
    long length = u16() - 2L;
    while (length > 0) {
      --length;
      int n = byte();
      int prec = n >> 4;
      n &= 15;
      if (n >= 4) throw Fail();  // JERR_DQT_INDEX
      for (int i = 0; i < 64; ++i)
        qspec_[n][kNatural[i]] = static_cast<uint16_t>(prec ? u16() : byte());
      qdefined_[n] = true;
      length -= 64;
      if (prec) length -= 64;
    }
    if (length != 0) throw Fail();  // JERR_BAD_LENGTH
  }

  void get_interesting_appn(int m) {
    long length = u16() - 2L;
    int b[14];
    int n = length >= 14 ? 14 : (length > 0 ? static_cast<int>(length) : 0);
    for (int i = 0; i < n; ++i) b[i] = byte();
    length -= n;
    if (m == kAPP0) {
      if (n >= 14 && b[0] == 0x4A && b[1] == 0x46 && b[2] == 0x49 &&
          b[3] == 0x46 && b[4] == 0)
        saw_jfif_ = true;
    } else if (n >= 12 && b[0] == 0x41 && b[1] == 0x64 && b[2] == 0x6F &&
               b[3] == 0x62 && b[4] == 0x65) {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
    if (length > 0) skip(length);
  }

  // jdinput.c's initial_setup, jdapimin.c's default_decompress_parms and
  // the checks jpeg_start_decompress makes for an RGB output
  void initial_setup() {
    if (height_ > 65500 || width_ > 65500) throw Fail();  // JERR_IMAGE_TOO_BIG
    if (precision_ != 8) throw Fail();                     // JERR_BAD_PRECISION
    const int nc = static_cast<int>(comps_.size());
    if (nc > 10) throw Fail();  // JERR_COMPONENT_COUNT
    max_h_ = max_v_ = 1;
    for (auto &c : comps_) {
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) throw Fail();  // JERR_BAD_SAMPLING
      if (c.h > max_h_) max_h_ = c.h;
      if (c.v > max_v_) max_v_ = c.v;
    }
    for (auto &c : comps_) {
      c.wib = static_cast<int>(
          (static_cast<long>(width_) * c.h + 8L * max_h_ - 1) / (8L * max_h_));
      c.hib = static_cast<int>(
          (static_cast<long>(height_) * c.v + 8L * max_v_ - 1) / (8L * max_v_));
      c.dw = static_cast<int>(
          (static_cast<long>(width_) * c.h + max_h_ - 1) / max_h_);
      c.dh = static_cast<int>(
          (static_cast<long>(height_) * c.v + max_v_ - 1) / max_v_);
      c.bw = (c.wib + c.h - 1) / c.h * c.h;
      c.bh = (c.hib + c.v - 1) / c.v * c.v;
    }
    if (nc == 1) {
      ycc_ = false;
    } else if (nc == 3) {
      if (saw_jfif_) {
        ycc_ = true;
      } else if (saw_adobe_) {
        ycc_ = adobe_transform_ != 0;
      } else {
        ycc_ = !(comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
      }
    } else {
      throw Fail();  // CMYK, YCCK or unknown: JERR_CONVERSION_NOTIMPL
    }
    for (auto &c : comps_) {  // jinit_upsampler: integral ratios only
      if (max_h_ % c.h != 0 || max_v_ % c.v != 0) throw Fail();
    }
    multi_scan_ = comps_in_scan_ < nc || progressive_;
    // jinit_huff_decoder / jinit_phuff_decoder: std_huff_tables
    if (!dc_spec_[0].defined) set_spec(dc_spec_[0], kDcLumBits, kDcVal, 12);
    if (!dc_spec_[1].defined) set_spec(dc_spec_[1], kDcChromBits, kDcVal, 12);
    if (!ac_spec_[0].defined) set_spec(ac_spec_[0], kAcLumBits, kAcLumVal, 162);
    if (!ac_spec_[1].defined) set_spec(ac_spec_[1], kAcChromBits, kAcChromVal, 162);
    for (auto &c : comps_)
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
  }

  static void set_spec(HuffSpec &s, const uint8_t *bits, const uint8_t *val,
                       int n) {
    s.defined = true;
    std::memcpy(s.bits, bits, 17);
    std::memset(s.val, 0, sizeof(s.val));
    std::memcpy(s.val, val, n);
  }

  // jdhuff.c's jpeg_make_d_derived_tbl
  void derive(bool is_dc, int tblno, HuffTable &t) {
    if (tblno < 0 || tblno >= 4) throw Fail();  // JERR_NO_HUFF_TABLE
    const HuffSpec &s = is_dc ? dc_spec_[tblno] : ac_spec_[tblno];
    if (!s.defined) throw Fail();
    uint8_t size[257];
    uint32_t code_of[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      int n = s.bits[l];
      if (p + n > 256) throw Fail();  // JERR_BAD_HUFF_TABLE
      while (n--) size[p++] = static_cast<uint8_t>(l);
    }
    size[p] = 0;
    const int nsym = p;
    uint32_t code = 0;
    int si = size[0];
    p = 0;
    while (size[p]) {
      while (size[p] == si) code_of[p++] = code++;
      if (code >= (uint32_t{1} << si)) throw Fail();  // JERR_BAD_HUFF_TABLE
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (s.bits[l]) {
        t.valoffset[l] = p - static_cast<int32_t>(code_of[p]);
        p += s.bits[l];
        t.maxcode[l] = static_cast<int32_t>(code_of[p - 1]);
      } else {
        t.maxcode[l] = -1;
      }
    }
    t.valoffset[17] = 0;
    t.maxcode[17] = 0xFFFFF;
    std::memcpy(t.val, s.val, 256);
    std::memset(t.look, 0, sizeof(t.look));
    for (int i = 0; i < nsym; ++i) {
      int l = size[i];
      if (l > kLook) break;
      int lo = static_cast<int>(code_of[i]) << (kLook - l);
      for (int k = 0; k < (1 << (kLook - l)); ++k)
        t.look[lo + k] = static_cast<uint16_t>((l << 8) | s.val[i]);
    }
    if (is_dc) {
      for (int i = 0; i < nsym; ++i)
        if (s.val[i] > 15) throw Fail();  // JERR_BAD_HUFF_TABLE
    }
  }

  // ------------------------------------------------------- bit reading
  // jdhuff.c's jpeg_fill_bit_buffer: stops at a marker, which it leaves
  // in unread_marker_; bits needed past it are zeros, and the segment is
  // then out of data
  void fill() {
    while (nbits_ <= 56) {
      if (unread_marker_) return;
      int c = byte();
      if (c == 0xFF) {
        int c2;
        do {
          c2 = byte();
        } while (c2 == 0xFF);
        if (c2 != 0) {
          unread_marker_ = c2;
          return;
        }
      }
      acc_ = (acc_ << 8) | static_cast<uint64_t>(c);
      nbits_ += 8;
    }
  }
  void ensure(int n) {
    if (nbits_ >= n) return;
    fill();
    if (nbits_ >= n) return;
    insufficient_ = true;  // JWRN_HIT_MARKER: zeros from here on
    acc_ <<= (57 - nbits_);
    nbits_ = 57;
  }
  int get_bits(int n) {
    ensure(n);
    nbits_ -= n;
    return static_cast<int>((acc_ >> nbits_) & ((uint64_t{1} << n) - 1));
  }
  int decode(const HuffTable &t) {
    if (nbits_ < kLook) fill();
    int code, l;
    if (nbits_ >= kLook) {
      int look = static_cast<int>((acc_ >> (nbits_ - kLook)) & ((1 << kLook) - 1));
      int e = t.look[look];
      if (e) {
        nbits_ -= e >> 8;
        return e & 0xFF;
      }
      nbits_ -= kLook;
      code = look;
      l = kLook;
    } else {
      code = get_bits(1);
      l = 1;
    }
    while (code > t.maxcode[l]) {
      code = (code << 1) | get_bits(1);
      ++l;
    }
    if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero
    return t.val[(code + t.valoffset[l]) & 0xFF];
  }
  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r + static_cast<int>((~0u << s) + 1) : r;
  }

  // jdmarker.c's read_restart_marker and jpeg_resync_to_restart
  void read_restart_marker() {
    if (unread_marker_ == 0) next_marker();
    if (unread_marker_ == kRST0 + next_restart_num_) {
      unread_marker_ = 0;
    } else {
      int desired = next_restart_num_;
      for (;;) {
        int m = unread_marker_;
        int action;
        if (m < kSOF0)
          action = 2;
        else if (m < kRST0 || m > kRST7)
          action = 3;
        else if (m == kRST0 + ((desired + 1) & 7) ||
                 m == kRST0 + ((desired + 2) & 7))
          action = 3;
        else if (m == kRST0 + ((desired - 1) & 7) ||
                 m == kRST0 + ((desired - 2) & 7))
          action = 2;
        else
          action = 1;
        if (action == 1) {
          unread_marker_ = 0;
          break;
        }
        if (action == 3) break;
        next_marker();
      }
    }
    next_restart_num_ = (next_restart_num_ + 1) & 7;
  }
  void process_restart() {
    nbits_ = 0;
    read_restart_marker();
    for (int &d : last_dc_) d = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (unread_marker_ == 0) insufficient_ = false;
  }

  // ------------------------------------------------------------ scans
  void decode_scan() {
    // jdinput.c: latch the quantization tables at a component's first scan
    for (int i = 0; i < comps_in_scan_; ++i) {
      Component &c = *scan_[i];
      if (c.latched) continue;
      if (c.tq < 0 || c.tq >= 4 || !qdefined_[c.tq]) throw Fail();  // JERR_NO_QUANT_TABLE
      std::memcpy(c.quant, qspec_[c.tq], sizeof(c.quant));
      c.latched = true;
    }
    int blocks_in_mcu = 0;
    if (comps_in_scan_ > 1) {
      for (int i = 0; i < comps_in_scan_; ++i)
        blocks_in_mcu += scan_[i]->h * scan_[i]->v;
      if (blocks_in_mcu > 10) throw Fail();  // JERR_BAD_MCU_SIZE
    }
    acc_ = 0;
    nbits_ = 0;
    insufficient_ = false;
    eobrun_ = 0;
    for (int &d : last_dc_) d = 0;
    restarts_to_go_ = restart_interval_;
    if (progressive_) {
      start_progressive_pass();
    } else {  // Ss, Se, Ah and Al are not read (JWRN_NOT_SEQUENTIAL)
      for (int i = 0; i < comps_in_scan_; ++i) {
        derive(true, scan_[i]->dc_tbl, dc_tbl_[i]);
        derive(false, scan_[i]->ac_tbl, ac_tbl_[i]);
      }
    }
    if (comps_in_scan_ == 1) {
      Component &c = *scan_[0];
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx) {
          int16_t *blk = c.block(by, bx);
          if (!insufficient_) last_good_imcu_row_ = by / c.v;
          decode_mcu(&blk, 1);
        }
    } else {
      const int mcus_x = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
      const int mcus_y = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
      int16_t *blocks[10];
      for (int my = 0; my < mcus_y; ++my)
        for (int mx = 0; mx < mcus_x; ++mx) {
          int n = 0;
          for (int i = 0; i < comps_in_scan_; ++i) {
            Component &c = *scan_[i];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                blocks[n] = c.block(my * c.v + y, mx * c.h + x);
                membership_[n++] = i;
              }
          }
          if (!insufficient_) last_good_imcu_row_ = my;
          decode_mcu(blocks, n);
        }
    }
  }

  // jdphuff.c's start_pass_phuff_decoder
  void start_progressive_pass() {
    const bool dc_band = ss_ == 0;
    bool bad = false;
    if (dc_band) {
      if (se_ != 0) bad = true;
    } else {
      if (ss_ > se_ || se_ >= 64) bad = true;
      if (comps_in_scan_ != 1) bad = true;
    }
    if (ah_ != 0 && al_ != ah_ - 1) bad = true;
    if (al_ > 13) bad = true;
    if (bad) throw Fail();  // JERR_BAD_PROGRESSION
    for (int i = 0; i < comps_in_scan_; ++i) {
      int *bits = scan_[i]->coef_bits;
      int *prev = scan_[i]->prev_coef_bits;
      for (int k = ss_ < 1 ? ss_ : 1; k <= (se_ > 9 ? se_ : 9); ++k)
        prev[k] = scan_number_ > 1 ? bits[k] : 0;
      for (int k = ss_; k <= se_; ++k) bits[k] = al_;
    }
    for (int i = 0; i < comps_in_scan_; ++i) {
      if (dc_band) {
        if (ah_ == 0) derive(true, scan_[i]->dc_tbl, dc_tbl_[i]);
      } else {
        derive(false, scan_[i]->ac_tbl, ac_tbl_[0]);
      }
    }
  }

  void decode_mcu(int16_t **blocks, int n) {
    if (restart_interval_ && restarts_to_go_ == 0) process_restart();
    if (!progressive_) {
      if (!insufficient_) decode_sequential(blocks, n);
    } else if (ss_ == 0) {
      if (ah_ == 0) {
        if (!insufficient_) decode_dc_first(blocks, n);
      } else {
        decode_dc_refine(blocks, n);
      }
    } else if (!insufficient_) {
      if (ah_ == 0)
        decode_ac_first(blocks[0]);
      else
        decode_ac_refine(blocks[0]);
    }
    if (restart_interval_) --restarts_to_go_;
  }

  int block_index(int blkn) const {
    return comps_in_scan_ == 1 ? 0 : membership_[blkn];
  }

  void decode_sequential(int16_t **blocks, int n) {
    for (int b = 0; b < n; ++b) {
      const int ci = block_index(b);
      int16_t *blk = blocks[b];
      int s = decode(dc_tbl_[ci]);
      if (s) s = extend(get_bits(s), s);
      s = static_cast<int>(static_cast<unsigned>(last_dc_[ci]) +
                           static_cast<unsigned>(s));
      last_dc_[ci] = s;
      blk[0] = static_cast<int16_t>(s);
      const HuffTable &ac = ac_tbl_[ci];
      for (int k = 1; k < 64; ++k) {
        int rs = decode(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          s = extend(get_bits(s), s);
          blk[kNatural[k]] = static_cast<int16_t>(s);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  void decode_dc_first(int16_t **blocks, int n) {
    for (int b = 0; b < n; ++b) {
      const int ci = block_index(b);
      int s = decode(dc_tbl_[ci]);
      if (s) s = extend(get_bits(s), s);
      const long sum = static_cast<long>(last_dc_[ci]) + s;
      if (sum > 2147483647L || sum < -2147483647L - 1)
        throw Fail();  // JERR_BAD_DCT_COEF
      last_dc_[ci] = static_cast<int>(sum);
      blocks[b][0] = static_cast<int16_t>(
          static_cast<int>(static_cast<unsigned>(sum) << al_));
    }
  }

  void decode_dc_refine(int16_t **blocks, int n) {
    const int p1 = 1 << al_;
    for (int b = 0; b < n; ++b)
      if (get_bits(1)) blocks[b][0] = static_cast<int16_t>(blocks[b][0] | p1);
  }

  void decode_ac_first(int16_t *blk) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const HuffTable &t = ac_tbl_[0];
    for (int k = ss_; k <= se_; ++k) {
      int rs = decode(t);
      int r = rs >> 4;
      int s = rs & 15;
      if (s) {
        k += r;
        s = extend(get_bits(s), s);
        blk[kNatural[k]] = static_cast<int16_t>(
            static_cast<int>(static_cast<unsigned>(s) << al_));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1u << r;
        if (r) eobrun_ += static_cast<unsigned>(get_bits(r));
        --eobrun_;
        break;
      }
    }
  }

  void decode_ac_refine(int16_t *blk) {
    const int p1 = 1 << al_;
    const int m1 = static_cast<int>(~0u << al_);
    const HuffTable &t = ac_tbl_[0];
    int k = ss_;
    auto correct = [&](int16_t &coef) {
      if (get_bits(1) && (coef & p1) == 0)
        coef = static_cast<int16_t>(coef >= 0 ? coef + p1 : coef + m1);
    };
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int rs = decode(t);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          // s != 1 is JWRN_HUFF_BAD_CODE, a warning
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun_ = 1u << r;
          if (r) eobrun_ += static_cast<unsigned>(get_bits(r));
          break;
        }
        do {
          int16_t &coef = blk[kNatural[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t &coef = blk[kNatural[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun_;
    }
  }

  // ------------------------------------------------------------ output
  // jdcoefct.c's smoothing_ok, with the coef_bits latched as output starts
  bool smoothing_ok() {
    if (!progressive_) return false;
    bool useful = false;
    for (auto &c : comps_) {
      if (!c.latched) return false;
      for (int pos : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.quant[pos] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) {
        c.latch[k] = c.coef_bits[k];
        c.prev_latch[k] = scan_number_ > 1 ? c.prev_coef_bits[k] : -1;
        if (c.coef_bits[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // jdcoefct.c's decompress_smooth_data: the first 9 AC coefficients of a
  // block that are still zero and not known exactly are estimated from the
  // DC values of its 5x5 neighbourhood (all 10 from a Gaussian-like kernel,
  // the DC too, when no AC data has arrived at all)
  void smooth_component(Component &c, uint8_t *plane, int pw) {
    const int total = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    const int last_imcu = total - 1;
    const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8],
                  Q20 = c.quant[16], Q11 = c.quant[9], Q02 = c.quant[2],
                  Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17],
                  Q30 = c.quant[24];
    const int last_col = c.wib - 1;
    for (int r = 0; r < total; ++r) {
      int block_rows;
      if (r < last_imcu) {
        block_rows = c.v;
      } else {
        block_rows = c.hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int *bits = r > last_good_imcu_row_ ? c.prev_latch : c.latch;
      const bool change_dc = bits[1] == -1 && bits[2] == -1 && bits[3] == -1 &&
                             bits[4] == -1 && bits[5] == -1 && bits[6] == -1 &&
                             bits[7] == -1 && bits[8] == -1 && bits[9] == -1;
      for (int br = 0; br < block_rows; ++br) {
        const int row = r * c.v + br;
        // the rows two away come from the iMCU rows in the window: the
        // two before this one, and the two after it
        const int prev = (br > 0 || r > 0) ? row - 1 : row;
        const int prev2 = (br > 1 || r > 1) ? row - 2 : prev;
        const int next = (br < block_rows - 1 || r < last_imcu) ? row + 1 : row;
        const int next2 = (br < block_rows - 2 || r + 1 < last_imcu) ? row + 2 : next;
        const int rows5[5] = {prev2, prev, row, next, next2};
        int dc[5][5];
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 5; ++j) dc[i][j] = c.block(rows5[i], 0)[0];
        for (int bx = 0; bx <= last_col; ++bx) {
          int16_t ws[64];
          std::memcpy(ws, c.block(row, bx), sizeof(ws));
          if (bx == 0 && bx < last_col)
            for (int i = 0; i < 5; ++i) dc[i][3] = c.block(rows5[i], 1)[0];
          if (bx + 1 < last_col)
            for (int i = 0; i < 5; ++i) dc[i][4] = c.block(rows5[i], bx + 2)[0];
          // DC01..DC25, row-major over the 5x5 window
          const int64_t DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2], DC04 = dc[0][3], DC05 = dc[0][4];
          const int64_t DC06 = dc[1][0], DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3], DC10 = dc[1][4];
          const int64_t DC11 = dc[2][0], DC12 = dc[2][1], DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4];
          const int64_t DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2], DC19 = dc[3][3], DC20 = dc[3][4];
          const int64_t DC21 = dc[4][0], DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3], DC25 = dc[4][4];
          auto predict = [](int64_t num, int64_t q, int al) {
            int pred;
            if (num >= 0) {
              pred = static_cast<int>(((q << 7) + num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
              pred = static_cast<int>(((q << 7) - num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
              pred = -pred;
            }
            return static_cast<int16_t>(pred);
          };
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0)
            ws[1] = predict(Q00 * (change_dc ?
                (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                 13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 +
                 3 * DC15 - 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 -
                 DC21 - DC22 + DC24 + DC25) :
                (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), Q01, al);
          if ((al = bits[2]) != 0 && ws[8] == 0)
            ws[8] = predict(Q00 * (change_dc ?
                (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                 13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                 13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
                (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), Q10, al);
          if ((al = bits[3]) != 0 && ws[16] == 0)
            ws[16] = predict(Q00 * (change_dc ?
                (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                 5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
                (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), Q20, al);
          if ((al = bits[4]) != 0 && ws[9] == 0)
            ws[9] = predict(Q00 * (change_dc ?
                (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                 9 * DC19 + DC21 - DC25) :
                (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                 DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)), Q11, al);
          if ((al = bits[5]) != 0 && ws[2] == 0)
            ws[2] = predict(Q00 * (change_dc ?
                (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
                (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), Q02, al);
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0)
              ws[3] = predict(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
            if ((al = bits[7]) != 0 && ws[10] == 0)
              ws[10] = predict(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
            if ((al = bits[8]) != 0 && ws[17] == 0)
              ws[17] = predict(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
            if ((al = bits[9]) != 0 && ws[24] == 0)
              ws[24] = predict(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
            const int64_t num = Q00 *
                (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                 6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                 8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                 6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 -
                 6 * DC24 - 2 * DC25);
            ws[0] = predict(num, Q00, 0);
          }
          idct_islow(ws, c.quant,
                     plane + static_cast<size_t>(row) * 8 * pw + bx * 8, pw);
          for (int i = 0; i < 5; ++i)
            for (int j = 0; j < 4; ++j) dc[i][j] = dc[i][j + 1];
        }
      }
    }
  }

  void output(std::vector<uint8_t> &px) {
    const bool smooth = smoothing_ok();
    const int nc = static_cast<int>(comps_.size());
    std::vector<std::vector<uint8_t>> full(nc);
    for (int ci = 0; ci < nc; ++ci) {
      Component &c = comps_[ci];
      const int pw = c.wib * 8, ph = c.hib * 8;
      std::vector<uint8_t> plane(static_cast<size_t>(pw) * ph);
      const uint16_t zero[64] = {0};
      const uint16_t *qt = c.latched ? c.quant : zero;
      if (smooth) {
        smooth_component(c, plane.data(), pw);
      } else {
        for (int by = 0; by < c.hib; ++by)
          for (int bx = 0; bx < c.wib; ++bx)
            idct_islow(c.block(by, bx), qt,
                       plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8,
                       pw);
      }
      c.coef.clear();
      c.coef.shrink_to_fit();
      full[ci] = upsample(c, plane, pw);
    }
    const size_t n = static_cast<size_t>(width_) * height_;
    px.resize(n * 3);
    uint8_t *o = px.data();
    if (nc == 1) {
      const uint8_t *g = full[0].data();
      for (size_t i = 0; i < n; ++i, o += 3) o[0] = o[1] = o[2] = g[i];
    } else if (!ycc_) {
      const uint8_t *r = full[0].data(), *g = full[1].data(), *b = full[2].data();
      for (size_t i = 0; i < n; ++i, o += 3) {
        o[0] = r[i];
        o[1] = g[i];
        o[2] = b[i];
      }
    } else {
      static const YccTables t;
      const uint8_t *y = full[0].data(), *cb = full[1].data(), *cr = full[2].data();
      for (size_t i = 0; i < n; ++i, o += 3) {
        const int yy = y[i];
        o[0] = clamp255(yy + t.cr_r[cr[i]]);
        o[1] = clamp255(yy + static_cast<int>((t.cb_g[cb[i]] + t.cr_g[cr[i]]) >> 16));
        o[2] = clamp255(yy + t.cb_b[cb[i]]);
      }
    }
  }

  // jdsample.c: the component at the output size, width_ x height_
  std::vector<uint8_t> upsample(const Component &c,
                                const std::vector<uint8_t> &plane, int pw) {
    const int W = width_, H = height_;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    auto in_row = [&](int r) { return plane.data() + static_cast<size_t>(r) * pw; };
    const int hx = max_h_ / c.h, vx = max_v_ / c.v;
    const int dw = c.dw, dh = c.dh;
    std::vector<uint8_t> row(static_cast<size_t>(2) * dw + 2);
    auto clamp_row = [&](int r) { return r < 0 ? 0 : (r >= dh ? dh - 1 : r); };
    if (hx == 1 && vx == 1) {
      for (int y = 0; y < H; ++y)
        std::memcpy(out.data() + static_cast<size_t>(y) * W, in_row(y), W);
    } else if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; ++y) {
        const uint8_t *ip = in_row(y);
        uint8_t *op = row.data();
        int v = ip[0];
        op[0] = static_cast<uint8_t>(v);
        op[1] = static_cast<uint8_t>((v * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          v = ip[x] * 3;
          op[2 * x] = static_cast<uint8_t>((v + ip[x - 1] + 1) >> 2);
          op[2 * x + 1] = static_cast<uint8_t>((v + ip[x + 1] + 2) >> 2);
        }
        v = ip[dw - 1];
        op[2 * dw - 2] = static_cast<uint8_t>((v * 3 + ip[dw - 2] + 1) >> 2);
        op[2 * dw - 1] = static_cast<uint8_t>(v);
        std::memcpy(out.data() + static_cast<size_t>(y) * W, op, W);
      }
    } else if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        const int r = y >> 1;
        const uint8_t *near = in_row(r);
        const bool above = (y & 1) == 0;
        const uint8_t *far = in_row(clamp_row(above ? r - 1 : r + 1));
        const int bias = above ? 1 : 2;
        uint8_t *op = out.data() + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x)
          op[x] = static_cast<uint8_t>((near[x] * 3 + far[x] + bias) >> 2);
      }
    } else if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        const int r = y >> 1;
        const uint8_t *i0 = in_row(r);
        const uint8_t *i1 = in_row(clamp_row((y & 1) ? r + 1 : r - 1));
        uint8_t *op = row.data();
        int this_sum = i0[0] * 3 + i1[0];
        int next_sum = i0[1] * 3 + i1[1];
        op[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
        op[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int x = 1; x < dw - 1; ++x) {
          next_sum = i0[x + 1] * 3 + i1[x + 1];
          op[2 * x] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
          op[2 * x + 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        op[2 * dw - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        op[2 * dw - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
        std::memcpy(out.data() + static_cast<size_t>(y) * W, op, W);
      }
    } else {  // h2v1_upsample, h2v2_upsample, int_upsample: replication
      for (int y = 0; y < H; ++y) {
        const uint8_t *ip = in_row(y / vx);
        uint8_t *op = out.data() + static_cast<size_t>(y) * W;
        for (int x = 0; x < W; ++x) op[x] = ip[x / hx];
      }
    }
    return out;
  }

  const uint8_t *buf_;
  size_t len_;
  size_t pos_ = 0;
  int unread_marker_ = 0;

  bool saw_sof_ = false, saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;
  int precision_ = 8, width_ = 0, height_ = 0;
  bool progressive_ = false, multi_scan_ = false, ycc_ = false;
  int max_h_ = 1, max_v_ = 1;
  std::vector<Component> comps_;
  HuffSpec dc_spec_[4], ac_spec_[4];
  uint16_t qspec_[4][64] = {};
  bool qdefined_[4] = {false, false, false, false};
  int restart_interval_ = 0;

  // the scan in progress
  int comps_in_scan_ = 0;
  Component *scan_[4] = {nullptr, nullptr, nullptr, nullptr};
  int ss_ = 0, se_ = 63, ah_ = 0, al_ = 0;
  int scan_number_ = 0;
  int last_good_imcu_row_ = 0;
  int next_restart_num_ = 0;
  int restarts_to_go_ = 0;
  int membership_[10] = {};
  HuffTable dc_tbl_[4], ac_tbl_[4];
  int last_dc_[4] = {0, 0, 0, 0};
  unsigned eobrun_ = 0;
  uint64_t acc_ = 0;
  int nbits_ = 0;
  bool insufficient_ = false;
};

}  // namespace

bool decode_jpeg_rgb(const uint8_t *buf, size_t len, std::vector<uint8_t> &px,
                     int &w, int &h) {
  try {
    Decoder d(buf, len);
    d.run(px, w, h);
    return true;
  } catch (const Fail &) {
    return false;
  } catch (const std::bad_alloc &) {
    return false;
  }
}

}  // namespace znicz_native
