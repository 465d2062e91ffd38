// znicz_tpu_torch native image pipeline (a copy of the JAX package's
// znicz_tpu/native/pipeline.cpp; the C entry points are the same).
//
// The host-side image decode path of the image loaders: a C++ worker
// pool doing JPEG (libjpeg) / PNG (libpng) decode, bilinear resize,
// crop, horizontal flip and affine normalization straight into the
// loader's minibatch buffer (float32 or raw uint8 NHWC).
//
// Exposed as a plain C ABI consumed via ctypes
// (znicz_tpu_torch/native/__init__.py) — one asynchronous batch in
// flight per pool, which is exactly the double-buffering the loader
// needs: submit batch N+1, let the device work on batch N, wait, swap.

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <csetjmp>
#include <jpeglib.h>
#include <png.h>

namespace {

// ---------------------------------------------------------------- rng
// splitmix64: cheap, seedable per-sample stream for crop/flip draws
static inline uint64_t splitmix64(uint64_t &state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

// ------------------------------------------------------------- decode
struct Image {
  std::vector<uint8_t> px;  // RGB interleaved
  int w = 0, h = 0;
};

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

static void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr *err = reinterpret_cast<JpegErr *>(cinfo->err);
  longjmp(err->jb, 1);
}

static bool decode_jpeg(const uint8_t *buf, size_t len, Image &out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t *>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out.w = static_cast<int>(cinfo.output_width);
  out.h = static_cast<int>(cinfo.output_height);
  out.px.resize(static_cast<size_t>(out.w) * out.h * 3);
  const size_t stride = static_cast<size_t>(out.w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t *row = out.px.data() + cinfo.output_scanline * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

static bool decode_png(const uint8_t *buf, size_t len, Image &out) {
  png_image img;
  std::memset(&img, 0, sizeof(img));
  img.version = PNG_IMAGE_VERSION;
  if (!png_image_begin_read_from_memory(&img, buf, len)) return false;
  img.format = PNG_FORMAT_RGB;
  out.w = static_cast<int>(img.width);
  out.h = static_cast<int>(img.height);
  out.px.resize(PNG_IMAGE_SIZE(img));
  if (!png_image_finish_read(&img, nullptr, out.px.data(), 0, nullptr)) {
    png_image_free(&img);
    return false;
  }
  return true;
}

static bool read_file(const char *path, std::vector<uint8_t> &buf) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size <= 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return got == buf.size();
}

static bool decode_any(const char *path, Image &out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, buf) || buf.size() < 8) return false;
  if (buf[0] == 0xFF && buf[1] == 0xD8) return decode_jpeg(buf.data(), buf.size(), out);
  if (buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' && buf[3] == 'G')
    return decode_png(buf.data(), buf.size(), out);
  return false;
}

// ------------------------------------------------------- resize (u8)
// Bilinear, pixel-center convention: src = (dst + 0.5) * scale - 0.5
// (matches numpy/OpenCV INTER_LINEAR and the Python oracle in tests).
static void resize_bilinear(const Image &src, int dst_w, int dst_h,
                            std::vector<uint8_t> &dst) {
  dst.resize(static_cast<size_t>(dst_w) * dst_h * 3);
  if (src.w == dst_w && src.h == dst_h) {
    std::memcpy(dst.data(), src.px.data(), dst.size());
    return;
  }
  const float sx = static_cast<float>(src.w) / dst_w;
  const float sy = static_cast<float>(src.h) / dst_h;
  for (int y = 0; y < dst_h; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    int y0 = static_cast<int>(fy);
    if (y0 > src.h - 2) y0 = src.h - 2;
    if (y0 < 0) y0 = 0;
    float wy = fy - y0;
    if (src.h == 1) { y0 = 0; wy = 0; }
    for (int x = 0; x < dst_w; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      int x0 = static_cast<int>(fx);
      if (x0 > src.w - 2) x0 = src.w - 2;
      if (x0 < 0) x0 = 0;
      float wx = fx - x0;
      if (src.w == 1) { x0 = 0; wx = 0; }
      const uint8_t *p00 = &src.px[(static_cast<size_t>(y0) * src.w + x0) * 3];
      const uint8_t *p01 = p00 + (src.w > 1 ? 3 : 0);
      const uint8_t *p10 = p00 + (src.h > 1 ? static_cast<size_t>(src.w) * 3 : 0);
      const uint8_t *p11 = p10 + (src.w > 1 ? 3 : 0);
      uint8_t *d = &dst[(static_cast<size_t>(y) * dst_w + x) * 3];
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] + (p01[c] - p00[c]) * wx;
        float bot = p10[c] + (p11[c] - p10[c]) * wx;
        float v = top + (bot - top) * wy;
        d[c] = static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
}

// ------------------------------------------------------------ job/pool
struct Job {
  const char *const *paths = nullptr;
  int n = 0;
  int resize_h = 0, resize_w = 0;  // 0 → keep decoded size
  int out_h = 0, out_w = 0;
  int channels = 3;    // 3 = RGB, 1 = luma
  int random_crop = 0; // 0 = center crop
  int random_flip = 0; // 1 = coin-flip horizontal mirror (train aug)
  float scale = 1.0f, bias = 0.0f;
  uint64_t seed = 0;
  void *out = nullptr;
  int out_u8 = 0;  // 1 → raw uint8 output, scale/bias ignored
                   // (device-side normalize: 4× smaller upload)
};

struct Pool {
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  Job job;                      // stable while busy (claims imply busy)
  uint64_t generation = 0;      // bumps per submitted batch
  int next_i = 0;               // sample cursor (guarded by mu)
  std::atomic<int> done{0};
  std::atomic<int> failed{0};
  bool busy = false;
  bool stopping = false;

  explicit Pool(int n_threads) {
    if (n_threads <= 0) {
      n_threads = static_cast<int>(std::thread::hardware_concurrency());
      if (n_threads <= 0) n_threads = 1;
    }
    for (int i = 0; i < n_threads; ++i)
      workers.emplace_back([this] { worker_loop(); });
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv_work.notify_all();
    for (auto &t : workers) t.join();
  }

  void process(int i) {
    const Job &j = job;
    const size_t sample_sz =
        static_cast<size_t>(j.out_h) * j.out_w * j.channels;
    const size_t elem = j.out_u8 ? sizeof(uint8_t) : sizeof(float);
    uint8_t *dst_raw = static_cast<uint8_t *>(j.out) +
                       sample_sz * elem * i;
    float *dst = reinterpret_cast<float *>(dst_raw);
    uint8_t *dst8 = dst_raw;
    Image img;
    if (!decode_any(j.paths[i], img) || img.w < 1 || img.h < 1) {
      std::memset(dst_raw, 0, sample_sz * elem);
      failed.fetch_add(1);
      return;
    }
    std::vector<uint8_t> resized;
    const uint8_t *base;
    int bw, bh;
    int rh = j.resize_h > 0 ? j.resize_h : img.h;
    int rw = j.resize_w > 0 ? j.resize_w : img.w;
    if (rh != img.h || rw != img.w) {
      resize_bilinear(img, rw, rh, resized);
      base = resized.data();
      bw = rw;
      bh = rh;
    } else {
      base = img.px.data();
      bw = img.w;
      bh = img.h;
    }
    // crop window
    int max_dx = bw - j.out_w, max_dy = bh - j.out_h;
    if (max_dx < 0 || max_dy < 0) {  // undersized source: refuse
      std::memset(dst_raw, 0, sample_sz * elem);
      failed.fetch_add(1);
      return;
    }
    uint64_t rng = j.seed ^ (0x5851f42d4c957f2dULL * (i + 1));
    int dx, dy;
    bool flip = false;
    if (j.random_crop) {
      dx = max_dx ? static_cast<int>(splitmix64(rng) % (max_dx + 1)) : 0;
      dy = max_dy ? static_cast<int>(splitmix64(rng) % (max_dy + 1)) : 0;
    } else {
      dx = max_dx / 2;
      dy = max_dy / 2;
    }
    if (j.random_flip) flip = (splitmix64(rng) & 1) != 0;
    // crop + (flip) + store: normalized float32 NHWC, or raw uint8
    // NHWC when out_u8 (the normalize then happens on-device)
    for (int y = 0; y < j.out_h; ++y) {
      const uint8_t *row =
          base + (static_cast<size_t>(dy + y) * bw + dx) * 3;
      const size_t row_off = static_cast<size_t>(y) * j.out_w * j.channels;
      float *drow = dst + row_off;
      uint8_t *drow8 = dst8 + row_off;
      for (int x = 0; x < j.out_w; ++x) {
        int sxp = flip ? (j.out_w - 1 - x) : x;
        const uint8_t *p = row + static_cast<size_t>(sxp) * 3;
        if (j.channels == 1) {
          float luma = 0.299f * p[0] + 0.587f * p[1] + 0.114f * p[2];
          if (j.out_u8)
            // round-half-to-even to match the PIL oracle's np.rint —
            // truncating luma+0.5 disagreed by one level at .5 ties
            drow8[x] = static_cast<uint8_t>(std::lrintf(luma));
          else
            drow[x] = luma * j.scale + j.bias;
        } else if (j.out_u8) {
          uint8_t *d = drow8 + static_cast<size_t>(x) * 3;
          d[0] = p[0];
          d[1] = p[1];
          d[2] = p[2];
        } else {
          float *d = drow + static_cast<size_t>(x) * 3;
          d[0] = p[0] * j.scale + j.bias;
          d[1] = p[1] * j.scale + j.bias;
          d[2] = p[2] * j.scale + j.bias;
        }
      }
    }
  }

  void worker_loop() {
    uint64_t seen = 0;
    for (;;) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stopping || generation != seen; });
        if (stopping) return;
        seen = generation;
      }
      for (;;) {
        int i, n;
        {
          // claim under the lock: a straggler waking after its batch
          // completed (or after a NEW batch was submitted) must not
          // touch the possibly-mid-assignment job fields
          std::lock_guard<std::mutex> lk(mu);
          if (generation != seen || !busy || next_i >= job.n) break;
          i = next_i++;
          n = job.n;
        }
        // job is stable here: busy stays true until done == n, which
        // cannot happen before this claimed item is processed
        process(i);
        if (done.fetch_add(1) + 1 == n) {
          std::lock_guard<std::mutex> lk(mu);
          busy = false;
          cv_done.notify_all();
        }
      }
    }
  }

  int submit(const Job &j) {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return !busy; });  // one batch in flight
    job = j;
    next_i = 0;
    done.store(0);
    failed.store(0);
    if (j.n == 0) return 0;
    busy = true;
    ++generation;
    cv_work.notify_all();
    return 0;
  }

  int wait() {
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return !busy; });
    return failed.load();
  }
};

}  // namespace

extern "C" {

void *zp_create(int n_threads) { return new Pool(n_threads); }

void zp_destroy(void *pool) { delete static_cast<Pool *>(pool); }

int zp_submit(void *pool, const char *const *paths, int n, int resize_h,
              int resize_w, int out_h, int out_w, int channels,
              int random_crop, int random_flip, float scale, float bias,
              uint64_t seed, void *out, int out_u8) {
  if (!pool || n < 0 || out_h <= 0 || out_w <= 0 ||
      (channels != 1 && channels != 3))
    return -1;
  Job j;
  j.paths = paths;
  j.n = n;
  j.resize_h = resize_h;
  j.resize_w = resize_w;
  j.out_h = out_h;
  j.out_w = out_w;
  j.channels = channels;
  j.random_crop = random_crop;
  j.random_flip = random_flip;
  j.scale = scale;
  j.bias = bias;
  j.seed = seed;
  j.out = out;
  j.out_u8 = out_u8;
  return static_cast<Pool *>(pool)->submit(j);
}

int zp_wait(void *pool) {
  if (!pool) return -1;
  return static_cast<Pool *>(pool)->wait();
}

}  // extern "C"
