// A PNG decoder over zlib's inflate whose output is what libpng 1.6's
// simplified API gives for PNG_FORMAT_RGB with no background colour, into a
// zeroed buffer: png_image_read_direct's transforms, done per pixel.
//
// - gray is replicated to RGB, a palette is expanded, 1/2/4-bit samples are
//   scaled to 8 bits (x255, x85, x17);
// - the file gamma is the gAMA chunk's (an sRGB chunk means 1/2.2), else
//   1/2.2 for 8-bit files and 1.0 (linear) for 16-bit ones; the screen is
//   sRGB (2.2), and where the two differ by more than 5 % libpng's gamma
//   tables apply (png_build_8bit_table, png_build_16to8_table);
// - 16-bit samples go to 8 bits through the 16-to-8 gamma table, keyed on
//   the top 11 bits (png_do_gamma, then png_do_scale_16_to_8);
// - an alpha channel (or tRNS) is composited onto the zero buffer:
//   PNG_ALPHA_OPTIMIZED premultiplies non-opaque samples in linear light
//   (png_do_compose), a palette's entries are composited in place
//   (png_init_read_transformations), and png_image_read_composite encodes
//   a partly transparent linear value to sRGB.  libpng does that last step
//   with a 512-entry piecewise-linear table (PNG_sRGB_FROM_LINEAR); this
//   decoder evaluates the sRGB curve itself, which lands within one level
//   of the table and on it for most values.
//
// CRCs are checked as libpng checks them: a bad one on a critical chunk
// fails the file, a bad one on an ancillary chunk drops the chunk.  Like
// the simplified API, the decoder stops after the image data: what follows
// the last IDAT chunk is not read.  The image data is inflated, unfiltered
// and converted a row at a time into the RGB output, as libpng reads it: a
// header that claims more than its data holds fails with no buffer but the
// output allocated.

#include "image_decode.h"

#include <zlib.h>

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <new>
#include <utility>

namespace znicz_native {
namespace {

struct Fail {};  // what libpng reports through png_error

inline uint32_t be32(const uint8_t *p) {
  return (uint32_t{p[0]} << 24) | (uint32_t{p[1]} << 16) |
         (uint32_t{p[2]} << 8) | uint32_t{p[3]};
}

// ---------------------------------------------------------- gamma maths
// png.c's fixed-point helpers (PNG_FLOATING_ARITHMETIC_SUPPORTED routes)
constexpr int32_t kFp1 = 100000;
constexpr int32_t kGammaThreshold = 5000;

bool significant(int32_t g) {
  return g < kFp1 - kGammaThreshold || g > kFp1 + kGammaThreshold;
}
int32_t reciprocal(int32_t a) {
  double r = std::floor(1e10 / a + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int32_t>(r) : 0;
}
int32_t reciprocal2(int32_t a, int32_t b) {
  double r = 1e15 / a;
  r /= b;
  r = std::floor(r + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int32_t>(r) : 0;
}
int32_t product2(int32_t a, int32_t b) {
  double r = a;
  r *= b;
  r *= 1e-5;
  r = std::floor(r + .5);
  return (r <= 2147483647. && r >= -2147483648.) ? static_cast<int32_t>(r) : 0;
}
// png_gamma_threshold: true when the file->screen correction is needed
bool gamma_threshold(int32_t screen, int32_t file) {
  double r = std::floor(static_cast<double>(screen) * file / kFp1 + .5);
  if (r > 2147483647. || r < -2147483648.) return true;
  return significant(static_cast<int32_t>(r));
}
uint8_t gamma_8bit_correct(unsigned value, int32_t g) {
  if (value > 0 && value < 255) {
    double r = std::floor(255 * std::pow(static_cast<int>(value) / 255., g * .00001) + .5);
    return static_cast<uint8_t>(r);
  }
  return static_cast<uint8_t>(value & 0xff);
}
uint16_t gamma_16bit_correct(unsigned value, int32_t g) {
  if (value > 0 && value < 65535) {
    double r = std::floor(
        65535 * std::pow(static_cast<int32_t>(value) / 65535., g * .00001) + .5);
    return static_cast<uint16_t>(r);
  }
  return static_cast<uint16_t>(value);
}

// png_build_8bit_table
void build_8bit_table(uint8_t *t, int32_t g) {
  if (significant(g)) {
    for (unsigned i = 0; i < 256; ++i) t[i] = gamma_8bit_correct(i, g);
  } else {
    for (unsigned i = 0; i < 256; ++i) t[i] = static_cast<uint8_t>(i);
  }
}

// png_build_16bit_table, flattened: index (v >> shift), 16 - shift bits
void build_16bit_table(std::vector<uint16_t> &t, unsigned shift, int32_t g) {
  const unsigned max = (1u << (16 - shift)) - 1u;
  const unsigned max_by_2 = 1u << (15 - shift);
  const double fmax = 1.0 / ((int32_t{1} << (16 - shift)) - 1);
  t.assign(max + 1, 0);
  for (unsigned ig = 0; ig <= max; ++ig) {
    if (significant(g)) {
      t[ig] = static_cast<uint16_t>(std::floor(65535. * std::pow(ig * fmax, g * .00001) + .5));
    } else {
      unsigned v = ig;
      if (shift != 0) v = (v * 65535u + max_by_2) / max;
      t[ig] = static_cast<uint16_t>(v);
    }
  }
}

// png_build_16to8_table, flattened the same way
void build_16to8_table(std::vector<uint16_t> &t, unsigned shift, int32_t g) {
  const unsigned n = 1u << (16 - shift);
  const unsigned max = n - 1u;
  t.assign(n, 65535);
  unsigned last = 0;
  for (unsigned i = 0; i < 255; ++i) {
    const uint16_t out = static_cast<uint16_t>(i * 257u);
    uint32_t bound = gamma_16bit_correct(out + 128u, g);
    bound = (bound * max + 32768u) / 65535u + 1u;
    while (last < bound && last < n) t[last++] = out;
  }
}

// png_composite / png_composite_16 with a zero background
inline uint8_t composite8(unsigned fg, unsigned alpha) {
  const unsigned temp = fg * alpha + 128;
  return static_cast<uint8_t>(((temp + (temp >> 8)) >> 8) & 0xff);
}
inline uint16_t composite16(uint32_t fg, uint32_t alpha) {
  const uint32_t temp = fg * alpha + 32768;
  return static_cast<uint16_t>(0xffff & ((temp + (temp >> 16)) >> 16));
}
// png_do_scale_16_to_8
inline uint8_t scale16(unsigned v) {
  const int hi = static_cast<int>(v >> 8), lo = static_cast<int>(v & 0xff);
  return static_cast<uint8_t>(hi + (((lo - hi + 128) * 65535) >> 24));
}

// png_image_read_composite's encoding of an 8-bit linear value (alpha 1..254)
struct SrgbFromLinear8 {
  uint8_t t[256];
  SrgbFromLinear8() {
    for (int i = 0; i < 256; ++i) {
      double l = i / 255.;
      double s = l <= 0.0031308 ? l * 12.92 : 1.055 * std::pow(l, 1 / 2.4) - 0.055;
      t[i] = static_cast<uint8_t>(std::nearbyint(255 * s));
    }
  }
};

// ----------------------------------------------------------------- decode
struct Png {
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = 0, interlace = 0;
  int channels = 0;  // samples a pixel in the file
  uint8_t palette[256][3] = {};
  int num_palette = 0;
  bool have_plte = false;
  uint8_t trans_alpha[256];
  int num_trans = 0;
  uint16_t trans[3] = {0, 0, 0};  // tRNS key for gray (trans[0]) or RGB
  int32_t file_gamma = 0;         // 0: none in the file
  int sig_bit = 0;                // sBIT (the channels' largest), 0: none
};

bool crc_ok(const uint8_t *type_and_data, uint32_t len, uint32_t want) {
  uLong c = crc32(0L, Z_NULL, 0);
  c = crc32(c, type_and_data, len + 4);
  return static_cast<uint32_t>(c) == want;
}

// An IDAT chunk as the file holds it: `avail` < `length` when the file
// ends inside it.
struct Idat {
  const uint8_t *data;
  size_t length, avail;
  bool crc_good;
};

// png_read_IDAT_data and png_read_finish_IDAT: the IDAT chunks inflated a
// row at a time, read in 8192-byte pieces (PNG_IDAT_READ_SIZE), then the
// zlib stream finished.  A zlib error, too little data, a read past the
// end of the file or a bad CRC on a chunk read fails the file; an error
// found only while finishing the stream, or data left over, does not.
class IdatStream {
 public:
  explicit IdatStream(const std::vector<Idat> &idat) : idat_(idat) {
    std::memset(&s_, 0, sizeof(s_));
    if (inflateInit2(&s_, 0) != Z_OK) throw Fail();
  }
  ~IdatStream() { inflateEnd(&s_); }
  IdatStream(const IdatStream &) = delete;
  IdatStream &operator=(const IdatStream &) = delete;

  // Exactly `n` bytes (one filtered row, at most 8 MB) into `dst`.
  void read(uint8_t *dst, size_t n) {
    s_.next_out = dst;
    s_.avail_out = static_cast<uInt>(n);
    while (s_.avail_out > 0) {
      if (ended_) throw Fail();  // "Not enough image data"
      if (s_.avail_in == 0) refill();
      const int rc = inflate(&s_, Z_NO_FLUSH);
      if (rc == Z_STREAM_END) ended_ = true;
      else if (rc != Z_OK) throw Fail();
    }
  }

  void finish() {
    uint8_t scratch[1024];
    while (!ended_) {
      if (s_.avail_in == 0) refill();
      s_.next_out = scratch;
      s_.avail_out = sizeof(scratch);
      if (inflate(&s_, Z_NO_FLUSH) != Z_OK) break;  // the end, or benign
    }
    // png_crc_finish on the chunk the stream ended in
    if (idat_[ci_].avail < idat_[ci_].length || !idat_[ci_].crc_good)
      throw Fail();
  }

 private:
  void refill() {
    while (ci_ < idat_.size() && off_ == idat_[ci_].length) {
      if (!idat_[ci_].crc_good) throw Fail();  // "CRC error"
      ++ci_;
      off_ = 0;
    }
    if (ci_ == idat_.size()) throw Fail();  // "Not enough image data"
    const size_t w = std::min<size_t>(8192, idat_[ci_].length - off_);
    if (off_ + w > idat_[ci_].avail) throw Fail();  // "read beyond end of data"
    s_.next_in = const_cast<Bytef *>(idat_[ci_].data + off_);
    s_.avail_in = static_cast<uInt>(w);
    off_ += w;
  }

  const std::vector<Idat> &idat_;
  z_stream s_;
  size_t ci_ = 0, off_ = 0;
  bool ended_ = false;
};

// Undo row `o`'s filter `f` in place (`rowbytes` bytes, `bpp` bytes a
// pixel) against the row above, `prev` (zeros above a pass's first row).
void unfilter_row(int f, uint8_t *o, const uint8_t *prev, size_t rowbytes,
                  int bpp) {
  const size_t b = static_cast<size_t>(bpp);
  switch (f) {
    case 0:
      break;
    case 1:
      for (size_t i = b; i < rowbytes; ++i)
        o[i] = static_cast<uint8_t>(o[i] + o[i - b]);
      break;
    case 2:
      for (size_t i = 0; i < rowbytes; ++i) o[i] = static_cast<uint8_t>(o[i] + prev[i]);
      break;
    case 3:
      for (size_t i = 0; i < rowbytes; ++i) {
        const int a = i >= b ? o[i - b] : 0;
        o[i] = static_cast<uint8_t>(o[i] + ((a + prev[i]) >> 1));
      }
      break;
    case 4:
      for (size_t i = 0; i < rowbytes; ++i) {
        const int a = i >= b ? o[i - b] : 0;
        const int bb = prev[i];
        const int c = i >= b ? prev[i - b] : 0;
        const int p = a + bb - c;
        const int pa = std::abs(p - a), pb = std::abs(p - bb), pc = std::abs(p - c);
        const int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? bb : c);
        o[i] = static_cast<uint8_t>(o[i] + pred);
      }
      break;
    default:
      throw Fail();  // "bad adaptive filter value"
  }
}

// Adam7: each pass's first column and row, and its steps
constexpr int kStartX[7] = {0, 4, 0, 2, 0, 1, 0};
constexpr int kStartY[7] = {0, 0, 4, 0, 2, 0, 1};
constexpr int kStepX[7] = {8, 8, 4, 4, 2, 2, 1};
constexpr int kStepY[7] = {8, 8, 8, 4, 4, 2, 2};

// One sample of a decoded row (bit depths 1..16).
inline unsigned sample(const uint8_t *row, size_t index, int depth) {
  switch (depth) {
    case 16:
      return (unsigned{row[2 * index]} << 8) | row[2 * index + 1];
    case 8:
      return row[index];
    default: {
      const size_t bit = index * depth;
      const unsigned byte = row[bit >> 3];
      const int shift = 8 - depth - static_cast<int>(bit & 7);
      return (byte >> shift) & ((1u << depth) - 1u);
    }
  }
}

class Decoder {
 public:
  Decoder(const uint8_t *buf, size_t len) : buf_(buf), len_(len) {}

  void run(std::vector<uint8_t> &px, int &w, int &h) {
    static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    if (len_ < 8 || std::memcmp(buf_, kSig, 8) != 0) throw Fail();
    read_chunks();
    prepare();
    // the one image-sized buffer, the RGB output libpng's caller allocates
    px.assign(static_cast<size_t>(p_.width) * p_.height * 3, 0);
    decode_rows(px.data());
    if (p_.depth == 16 && p_.interlace && !has_alpha_) overwrite_even_rows(px);
    w = static_cast<int>(p_.width);
    h = static_cast<int>(p_.height);
  }

 private:
  void read_chunks() {
    size_t pos = 8;
    bool first = true;
    for (;;) {
      const bool in_idat = !idat_.empty();
      if (pos + 8 > len_) {
        if (in_idat) return;  // libpng reads on only if it needs more
        throw Fail();         // "read beyond end of data"
      }
      const uint32_t length = be32(buf_ + pos);
      const uint8_t *type = buf_ + pos + 4;
      const uint8_t *data = type + 4;
      const bool is_idat = std::memcmp(type, "IDAT", 4) == 0;
      if (in_idat && !is_idat) return;  // the image data is complete
      if (length > 0x7fffffffu) throw Fail();
      if (pos + 12 + static_cast<size_t>(length) > len_) {
        if (!in_idat && !is_idat) throw Fail();
        if (p_.ctype == 3 && !p_.have_plte) throw Fail();
        idat_.push_back({data, length, len_ - std::min(len_, pos + 8), false});
        return;
      }
      const bool crc_good = crc_ok(type, length, be32(data + length));
      const bool critical = (type[0] & 0x20) == 0;
      pos += 12 + static_cast<size_t>(length);
      if (is_idat) {
        if (first) throw Fail();  // "missing IHDR"
        if (p_.ctype == 3 && !p_.have_plte) throw Fail();  // "Missing PLTE"
        idat_.push_back({data, length, length, crc_good});
        continue;
      }
      if (!crc_good) {
        if (critical) throw Fail();  // "CRC error"
        continue;                    // an ancillary chunk is dropped
      }
      if (first) {
        if (std::memcmp(type, "IHDR", 4) != 0) throw Fail();  // "missing IHDR"
        ihdr(data, length);
        first = false;
      } else if (std::memcmp(type, "IHDR", 4) == 0) {
        throw Fail();
      } else if (std::memcmp(type, "PLTE", 4) == 0) {
        plte(data, length);
      } else if (std::memcmp(type, "IEND", 4) == 0) {
        throw Fail();  // no image data
      } else if (std::memcmp(type, "tRNS", 4) == 0) {
        trns(data, length);
      } else if (std::memcmp(type, "gAMA", 4) == 0) {
        if (length == 4 && !saw_srgb_ && !saw_plte_) {
          const int32_t g = static_cast<int32_t>(be32(data));
          if (g >= 16 && g <= 625000000 && !saw_gama_) {
            p_.file_gamma = g;
            saw_gama_ = true;
          }
        }
      } else if (std::memcmp(type, "sRGB", 4) == 0) {
        if (length == 1 && !saw_srgb_ && !saw_plte_) {
          p_.file_gamma = 45455;  // PNG_GAMMA_sRGB_INVERSE
          saw_srgb_ = true;
        }
      } else if (std::memcmp(type, "sBIT", 4) == 0) {
        if (!saw_plte_) sbit(data, length);
      } else if (critical) {
        throw Fail();  // an unknown critical chunk
      }
    }
  }

  void ihdr(const uint8_t *d, uint32_t length) {
    if (length != 13) throw Fail();
    p_.width = be32(d);
    p_.height = be32(d + 4);
    p_.depth = d[8];
    p_.ctype = d[9];
    const int compression = d[10], filter = d[11];
    p_.interlace = d[12];
    // png_check_IHDR, with the default user limits of 1,000,000
    if (p_.width == 0 || p_.height == 0 || p_.width > 1000000u ||
        p_.height > 1000000u)
      throw Fail();
    const int dep = p_.depth;
    switch (p_.ctype) {
      case 0:
        if (dep != 1 && dep != 2 && dep != 4 && dep != 8 && dep != 16) throw Fail();
        p_.channels = 1;
        break;
      case 2:
        if (dep != 8 && dep != 16) throw Fail();
        p_.channels = 3;
        break;
      case 3:
        if (dep != 1 && dep != 2 && dep != 4 && dep != 8) throw Fail();
        p_.channels = 1;
        break;
      case 4:
        if (dep != 8 && dep != 16) throw Fail();
        p_.channels = 2;
        break;
      case 6:
        if (dep != 8 && dep != 16) throw Fail();
        p_.channels = 4;
        break;
      default:
        throw Fail();
    }
    if (compression != 0 || filter != 0 || p_.interlace > 1) throw Fail();
    // png_image_finish_read: the RGB buffer's size must fit in 32 bits
    if (p_.width > 0x7fffffffu / 3 ||
        p_.height > 0xffffffffu / (p_.width * 3u))
      throw Fail();
  }

  void plte(const uint8_t *d, uint32_t length) {
    if (saw_plte_) throw Fail();  // "duplicate"
    saw_plte_ = true;
    if (p_.ctype == 0 || p_.ctype == 4) return;  // ignored
    if (length > 3 * 256 || length % 3) {
      if (p_.ctype == 3) throw Fail();  // "invalid"
      return;
    }
    int num = static_cast<int>(length / 3);
    const int max = p_.ctype == 3 ? (1 << p_.depth) : 256;
    if (num > max) num = max;
    for (int i = 0; i < num; ++i)
      for (int c = 0; c < 3; ++c) p_.palette[i][c] = d[3 * i + c];
    p_.num_palette = num;
    p_.have_plte = true;
  }

  void trns(const uint8_t *d, uint32_t length) {
    if (p_.num_trans > 0) return;  // a duplicate is ignored
    if (p_.ctype == 0) {
      if (length != 2) return;
      p_.trans[0] = static_cast<uint16_t>((d[0] << 8) | d[1]);
      p_.num_trans = 1;
    } else if (p_.ctype == 2) {
      if (length != 6) return;
      for (int c = 0; c < 3; ++c)
        p_.trans[c] = static_cast<uint16_t>((d[2 * c] << 8) | d[2 * c + 1]);
      p_.num_trans = 1;
    } else if (p_.ctype == 3) {
      if (!p_.have_plte) return;  // out of place
      if (length > static_cast<uint32_t>(p_.num_palette) || length > 256 ||
          length == 0)
        return;  // invalid
      std::memset(p_.trans_alpha, 0xff, sizeof(p_.trans_alpha));
      std::memcpy(p_.trans_alpha, d, length);
      p_.num_trans = static_cast<int>(length);
    }
    // colour types 4 and 6 ignore tRNS
  }

  void sbit(const uint8_t *d, uint32_t length) {
    const int sample_depth = p_.ctype == 3 ? 8 : p_.depth;
    uint32_t want;
    switch (p_.ctype) {
      case 0: want = 1; break;
      case 2: case 3: want = 3; break;
      case 4: want = 2; break;
      default: want = 4; break;
    }
    if (length != want || saw_sbit_) return;
    for (uint32_t i = 0; i < length; ++i)
      if (d[i] == 0 || d[i] > sample_depth) return;
    p_.sig_bit = (p_.ctype & 2) ? std::max(d[0], std::max(d[1], d[2])) : d[0];
    saw_sbit_ = true;
  }

  size_t row_bytes(uint32_t w) const {
    return (static_cast<size_t>(w) * p_.channels * p_.depth + 7) / 8;
  }

  // Each pass's rows inflated, unfiltered and converted one at a time
  // straight into the RGB output, as libpng reads them.
  void decode_rows(uint8_t *px) {
    const int bpp = std::max(1, p_.channels * p_.depth / 8);
    const int passes = p_.interlace ? 7 : 1;
    const size_t nch = static_cast<size_t>(p_.channels);
    IdatStream z(idat_);
    std::vector<uint8_t> row_a, row_b;
    unsigned v[4];
    for (int pass = 0; pass < passes; ++pass) {
      uint32_t pw = p_.width, ph = p_.height;
      if (p_.interlace) {
        pw = p_.width > static_cast<uint32_t>(kStartX[pass])
                 ? (p_.width - kStartX[pass] + kStepX[pass] - 1) / kStepX[pass] : 0;
        ph = p_.height > static_cast<uint32_t>(kStartY[pass])
                 ? (p_.height - kStartY[pass] + kStepY[pass] - 1) / kStepY[pass] : 0;
      }
      if (!pw || !ph) continue;
      const size_t rb = row_bytes(pw);
      // a filter byte, then the row; the row above starts as zeros
      row_a.assign(rb + 1, 0);
      row_b.assign(rb + 1, 0);
      uint8_t *cur = row_a.data(), *prev = row_b.data();
      for (uint32_t y = 0; y < ph; ++y) {
        z.read(cur, rb + 1);
        const uint8_t *row = cur + 1;
        unfilter_row(cur[0], cur + 1, prev + 1, rb, bpp);
        const size_t oy = p_.interlace ? kStartY[pass] + static_cast<size_t>(y) * kStepY[pass] : y;
        for (uint32_t x = 0; x < pw; ++x) {
          const size_t ox = p_.interlace ? kStartX[pass] + static_cast<size_t>(x) * kStepX[pass] : x;
          for (size_t c = 0; c < nch; ++c) v[c] = sample(row, x * nch + c, p_.depth);
          uint8_t *out = px + (oy * p_.width + ox) * 3;
          if (p_.depth == 16) put16(v, out);
          else put8(v, out);
        }
        std::swap(cur, prev);
      }
    }
    z.finish();
  }

  // png_image_read_direct's transforms: png_set_alpha_mode's defaults,
  // then png_init_read_transformations' tables
  void prepare() {
    const bool sixteen = p_.depth == 16;
    has_alpha_ = (p_.ctype & 4) != 0 || p_.num_trans > 0;
    const int32_t file_gamma =
        p_.file_gamma ? p_.file_gamma : reciprocal(sixteen ? kFp1 : 220000);
    const int32_t screen = 220000;
    gamma_on_ = gamma_threshold(screen, file_gamma);
    tables_ = gamma_on_ || (has_alpha_ && (significant(file_gamma) ||
                                           significant(screen)));
    if (sixteen) {
      // 16-bit samples: png_do_gamma / png_do_compose at 16 bits, keyed on
      // the top (16 - shift) bits, then png_do_scale_16_to_8
      unsigned shift = (p_.sig_bit > 0 && p_.sig_bit < 16) ? 16u - p_.sig_bit : 0u;
      if (shift < 5) shift = 5;  // 16 - PNG_MAX_GAMMA_8
      if (shift > 8) shift = 8;
      shift_ = shift;
      if (tables_) {
        build_16to8_table(g16_, shift, product2(file_gamma, screen));
        build_16bit_table(to1_16_, shift, reciprocal(file_gamma));
      }
      return;
    }
    for (int i = 0; i < 256; ++i) gamma_table_[i] = to1_[i] = static_cast<uint8_t>(i);
    if (tables_) {
      build_8bit_table(gamma_table_, reciprocal2(file_gamma, screen));
      build_8bit_table(to1_, reciprocal(file_gamma));
    }
    uint8_t from1[256];
    build_8bit_table(from1, reciprocal(screen));
    const int dep = p_.depth;
    scale_ = dep == 1 ? 255 : dep == 2 ? 85 : dep == 4 ? 17 : 1;
    mask_ = (1u << dep) - 1u;
    if (p_.ctype != 3) return;
    // png_init_read_transformations composites a palette in place, and
    // its entries come out of png_image_read_composite as they are
    for (int i = 0; i < 256; ++i) {
      const unsigned a = i < p_.num_trans ? p_.trans_alpha[i] : 255;
      for (int c = 0; c < 3; ++c) {
        const uint8_t v = p_.palette[i][c];
        if (!has_alpha_ || a == 255)
          pal_[i][c] = (gamma_on_ || has_alpha_) ? gamma_table_[v] : v;
        else if (a == 0)
          pal_[i][c] = 0;
        else
          pal_[i][c] = from1[(to1_[v] * a + 128) / 255];
      }
    }
  }

  // One pixel of a file of 1-8 bits a sample: its samples `s` to RGB
  void put8(const unsigned *s, uint8_t *out) const {
    static const SrgbFromLinear8 srgb;
    if (p_.ctype == 3) {
      std::memcpy(out, pal_[s[0]], 3);
      return;
    }
    const bool color = (p_.ctype & 2) != 0;
    unsigned v[3];
    for (int c = 0; c < 3; ++c) v[c] = s[color ? c : 0];
    unsigned a = 255;
    if (p_.ctype & 4) {
      a = s[p_.channels - 1];
    } else if (p_.num_trans > 0) {
      const bool key = color
          ? (v[0] == (p_.trans[0] & mask_) && v[1] == (p_.trans[1] & mask_) &&
             v[2] == (p_.trans[2] & mask_))
          : v[0] == (p_.trans[0] & mask_);
      a = key ? 0 : 255;
    }
    for (int c = 0; c < 3; ++c) {
      const unsigned x = v[c] * scale_;  // png_do_expand to 8 bits
      uint8_t r;
      if (!has_alpha_) {
        r = gamma_on_ ? gamma_table_[x] : static_cast<uint8_t>(x);
      } else if (a == 255) {
        r = tables_ ? gamma_table_[x] : static_cast<uint8_t>(x);
      } else if (a == 0) {
        r = 0;
      } else {
        // PNG_ALPHA_OPTIMIZED: premultiplied in linear light, then
        // encoded by png_image_read_composite
        r = srgb.t[composite8(tables_ ? to1_[x] : x, a)];
      }
      out[c] = r;
    }
  }

  // One pixel of a 16-bit file
  void put16(const unsigned *s, uint8_t *out) const {
    static const SrgbFromLinear8 srgb;
    const bool color = (p_.ctype & 2) != 0;
    unsigned v[3];
    for (int c = 0; c < 3; ++c) v[c] = s[color ? c : 0];
    unsigned a = 65535;
    if (p_.ctype & 4) {
      a = s[p_.channels - 1];
    } else if (p_.num_trans > 0) {
      const bool key = color ? (v[0] == p_.trans[0] && v[1] == p_.trans[1] &&
                                v[2] == p_.trans[2])
                             : v[0] == p_.trans[0];
      a = key ? 0 : 65535;
    }
    const uint8_t a8 = scale16(a);
    for (int c = 0; c < 3; ++c) {
      unsigned w16;
      if (!tables_) {
        w16 = (!has_alpha_ || a == 65535) ? v[c] : (a == 0 ? 0 : composite16(v[c], a));
      } else if (!has_alpha_ || a == 65535) {
        w16 = g16_[v[c] >> shift_];
      } else if (a == 0) {
        w16 = 0;
      } else {
        w16 = composite16(to1_16_[v[c] >> shift_], a);
      }
      const uint8_t c8 = scale16(w16);
      uint8_t r;
      if (!has_alpha_ || a8 == 255) {
        r = c8;
      } else if (a8 == 0) {
        r = 0;
      } else {
        r = srgb.t[c8];
      }
      out[c] = r;
    }
  }

  // libpng's simplified API, reading a 16-bit image with no alpha through
  // its Adam7 handling into 8 bits, leaves each even row as the last pass
  // finds its one-row buffer: that row's pixels from the last row each
  // earlier pass wrote there (the previous odd row, for all but row 0).
  // Passes 0-5 only read rows, and pass 6 reads odd rows and writes even
  // ones, so the rows are read as decoded.
  void overwrite_even_rows(std::vector<uint8_t> &px) const {
    const size_t w = p_.width, rb = w * 3;
    std::vector<uint8_t> canvas(rb, 0);
    for (int pass = 0; pass < 7; ++pass) {
      const bool has_cols = w > static_cast<size_t>(kStartX[pass]);
      for (uint32_t r = 0; r < p_.height; ++r) {
        const bool member = has_cols && r >= static_cast<uint32_t>(kStartY[pass]) &&
                            (r - kStartY[pass]) % kStepY[pass] == 0;
        if (member) {
          for (size_t x = kStartX[pass]; x < w; x += kStepX[pass])
            std::memcpy(&canvas[3 * x], &px[r * rb + 3 * x], 3);
        } else if (pass == 6) {
          std::memcpy(&px[r * rb], canvas.data(), rb);
        }
      }
    }
  }

  const uint8_t *buf_;
  size_t len_;
  Png p_;
  bool saw_gama_ = false, saw_srgb_ = false, saw_sbit_ = false;
  bool saw_plte_ = false;
  std::vector<Idat> idat_;
  // prepare()'s transforms
  bool has_alpha_ = false, gamma_on_ = false, tables_ = false;
  unsigned scale_ = 1, mask_ = 0xff, shift_ = 0;
  uint8_t gamma_table_[256], to1_[256];
  uint8_t pal_[256][3] = {};
  std::vector<uint16_t> g16_, to1_16_;
};

}  // namespace

bool decode_png_rgb(const uint8_t *buf, size_t len, std::vector<uint8_t> &px,
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
