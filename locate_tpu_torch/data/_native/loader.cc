// Native host-side image batch loader of the PyTorch port of locate-tpu
// (a copy of the JAX package's locate_tpu/data/_native/loader.cc, with
// the same C ABI, version 2).
//
// Host code, not a device kernel: a host JPEG decode and resize at
// 256^2/512^2 can starve the card, and Python/PIL serializes on the GIL.
// This library decodes (libjpeg with DCT scaling, libpng), center-crops,
// bilinear-resizes, flips and collates a whole batch in a C++ thread pool;
// the ctypes call releases the GIL so the producer thread scales across
// the host's cores.
//
// C ABI only (loaded via ctypes).
//
// Build: g++ -O3 -shared -fPIC loader.cc -ljpeg -lpng -o libloader.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <string>
#include <thread>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB8, row-major
  int w = 0, h = 0;
};

// ---------------------------------------------------------------------------
// JPEG decode (in-memory source, DCT scaling for cheap downscale)
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(const uint8_t* buf, size_t len, int target, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT scaling: pick the largest denominator that keeps the short side
  // >= target, so we never upscale afterwards and decode ~denom^2x faster.
  int short_side = cinfo.image_width < cinfo.image_height
                       ? cinfo.image_width
                       : cinfo.image_height;
  int denom = 1;
  while (denom < 8 && short_side / (denom * 2) >= target) denom *= 2;
  cinfo.scale_num = 1;
  cinfo.scale_denom = denom;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->data.resize(size_t(out->w) * out->h * 3);
  int stride = out->w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data.data() + size_t(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ---------------------------------------------------------------------------
// PNG decode (in-memory source)
// ---------------------------------------------------------------------------

struct PngReadState {
  const uint8_t* buf;
  size_t len, pos;
};

void png_read_fn(png_structp png, png_bytep dst, png_size_t n) {
  auto* st = static_cast<PngReadState*>(png_get_io_ptr(png));
  if (st->pos + n > st->len) {
    png_error(png, "png: read past end");
  }
  memcpy(dst, st->buf + st->pos, n);
  st->pos += n;
}

bool decode_png(const uint8_t* buf, size_t len, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  PngReadState st{buf, len, 0};
  png_set_read_fn(png, &st, png_read_fn);
  png_read_info(png, info);
  png_set_expand(png);          // palette/low-bit -> 8-bit
  png_set_strip_16(png);        // 16-bit -> 8-bit
  png_set_strip_alpha(png);     // drop alpha
  png_set_gray_to_rgb(png);     // grayscale -> RGB
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->data.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->data.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

// ---------------------------------------------------------------------------
// center-crop + bilinear resize + optional hflip, RGB8 -> res x res
// ---------------------------------------------------------------------------

void crop_resize_flip(const Image& src, int res, bool flip, uint8_t* dst) {
  int s = src.w < src.h ? src.w : src.h;
  int x0 = (src.w - s) / 2, y0 = (src.h - s) / 2;
  float scale = float(s) / float(res);
  int sw3 = src.w * 3;
  // sample coordinates clamp to the CROP window, not the full image —
  // otherwise upscaling bleeds pixels from outside the crop and diverges
  // from the PIL fallback (crop-then-resize).
  const float fy_lo = float(y0), fy_hi = float(y0 + s - 1);
  const float fx_lo = float(x0), fx_hi = float(x0 + s - 1);
  for (int y = 0; y < res; ++y) {
    float fy = (y + 0.5f) * scale - 0.5f + y0;
    if (fy < fy_lo) fy = fy_lo;
    if (fy > fy_hi) fy = fy_hi;
    int iy = int(fy);
    int iy1 = iy + 1 <= int(fy_hi) ? iy + 1 : iy;
    float wy = fy - iy;
    uint8_t* drow = dst + size_t(y) * res * 3;
    for (int x = 0; x < res; ++x) {
      float fx = (x + 0.5f) * scale - 0.5f + x0;
      if (fx < fx_lo) fx = fx_lo;
      if (fx > fx_hi) fx = fx_hi;
      int ix = int(fx);
      int ix1 = ix + 1 <= int(fx_hi) ? ix + 1 : ix;
      float wx = fx - ix;
      const uint8_t* p00 = src.data.data() + size_t(iy) * sw3 + ix * 3;
      const uint8_t* p01 = src.data.data() + size_t(iy) * sw3 + ix1 * 3;
      const uint8_t* p10 = src.data.data() + size_t(iy1) * sw3 + ix * 3;
      const uint8_t* p11 = src.data.data() + size_t(iy1) * sw3 + ix1 * 3;
      int xo = flip ? (res - 1 - x) : x;
      uint8_t* d = drow + xo * 3;
      for (int c = 0; c < 3; ++c) {
        float top = p00[c] * (1 - wx) + p01[c] * wx;
        float bot = p10[c] * (1 - wx) + p11[c] * wx;
        float v = top * (1 - wy) + bot * wy;
        d[c] = uint8_t(v + 0.5f);
      }
    }
  }
}

bool decode_any(const uint8_t* buf, size_t len, int target, Image* img) {
  if (len >= 2 && buf[0] == 0xFF && buf[1] == 0xD8)
    return decode_jpeg(buf, len, target, img);
  if (len >= 4 && buf[0] == 0x89 && buf[1] == 'P' && buf[2] == 'N' && buf[3] == 'G')
    return decode_png(buf, len, img);
  return false;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    fclose(f);
    return false;
  }
  out->resize(size_t(n));
  size_t rd = fread(out->data(), 1, size_t(n), f);
  fclose(f);
  return rd == size_t(n);
}

}  // namespace

extern "C" {

// Decode `n` image files, center-crop square, bilinear-resize to res x res
// RGB8, optional per-image horizontal flip, collate into `out`
// (n * res * res * 3 bytes, NHWC). Runs on `threads` worker threads.
// Returns 0 on success; on failure returns 1 + index of the first bad file
// in *bad_index.
int ltpu_decode_batch(const char** paths, int n, int res,
                      const uint8_t* flips, uint8_t* out, int threads,
                      int* bad_index) {
  std::atomic<int> next(0);
  std::atomic<int> bad(-1);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n || bad.load() >= 0) return;
      std::vector<uint8_t> buf;
      Image img;
      if (!read_file(paths[i], &buf) ||
          !decode_any(buf.data(), buf.size(), res, &img)) {
        int expect = -1;
        bad.compare_exchange_strong(expect, i);
        return;
      }
      crop_resize_flip(img, res, flips && flips[i],
                       out + size_t(i) * res * res * 3);
    }
  };
  int k = threads > 0 ? threads : 1;
  if (k > n) k = n;
  std::vector<std::thread> pool;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  if (bad.load() >= 0) {
    if (bad_index) *bad_index = bad.load();
    return 1;
  }
  return 0;
}

// Resize+flip a batch of pre-decoded uint8 RGB images that share one
// (h, w) shape (e.g. CIFAR batches or synthetic data) — collated resize
// without any decode.
int ltpu_resize_batch(const uint8_t* src, int n, int h, int w, int res,
                      const uint8_t* flips, uint8_t* out, int threads) {
  std::atomic<int> next(0);
  auto work = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      Image img;
      img.w = w;
      img.h = h;
      img.data.assign(src + size_t(i) * h * w * 3,
                      src + size_t(i + 1) * h * w * 3);
      crop_resize_flip(img, res, flips && flips[i],
                       out + size_t(i) * res * res * 3);
    }
  };
  int k = threads > 0 ? threads : 1;
  if (k > n) k = n;
  std::vector<std::thread> pool;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return 0;
}

// In-place horizontal flip of selected images in a collated uint8 RGB batch
// (n, h, w, 3). flips[i] != 0 selects image i. Pixel swap from both row
// ends — numpy's negative-stride itemsize-3 copy measured ~6ms for 64
// flips @128^2 on this host; this loop is memory-bound instead.
int ltpu_flip_horizontal(uint8_t* data, long n, int h, int w,
                         const uint8_t* flips, int threads) {
  std::atomic<long> next(0);
  const size_t img_sz = size_t(h) * w * 3;
  auto work = [&]() {
    for (;;) {
      long i = next.fetch_add(1);
      if (i >= n) return;
      if (!flips[i]) continue;
      uint8_t* img = data + size_t(i) * img_sz;
      for (int y = 0; y < h; ++y) {
        uint8_t* row = img + size_t(y) * w * 3;
        for (int a = 0, b = w - 1; a < b; ++a, --b) {
          uint8_t* pa = row + a * 3;
          uint8_t* pb = row + b * 3;
          for (int c = 0; c < 3; ++c) {
            uint8_t t = pa[c];
            pa[c] = pb[c];
            pb[c] = t;
          }
        }
      }
    }
  };
  int k = threads > 0 ? threads : 1;
  if (k > n) k = int(n);
  std::vector<std::thread> pool;
  pool.reserve(k);
  for (int t = 0; t < k; ++t) pool.emplace_back(work);
  for (auto& th : pool) th.join();
  return 0;
}

int ltpu_version() { return 2; }

}  // extern "C"
