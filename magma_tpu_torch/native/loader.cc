// Native image loader: JPEG/PNG decode + antialiased bicubic resize +
// center crop + CLIP normalization, exposed through a minimal C ABI.
//
// The port's own copy of magma_tpu/native/loader.cc.  Each call decodes
// and preprocesses ONE image entirely in native code and is thread-safe,
// so the Python worker threads of data/loader.py run in parallel: ctypes
// releases the GIL for the duration of the call.
//
// Resize matches PIL's convolution resampling (Keys bicubic, a = -0.5,
// support window scaled by 1/scale when downsampling => antialiased),
// so outputs agree with the PIL pipeline to within rounding.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 loader.cc -o _loader.so -ljpeg -lpng
// (magma_tpu_torch/native/__init__.py builds it lazily into build/native/).

#include <csetjmp>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>

namespace {

// reject absurd header dimensions before allocating (a corrupt 65k x 65k
// JPEG header would ask for tens of GB)
constexpr long kMaxPixels = 64L * 1024 * 1024;  // 64 MP

// ---------------------------------------------------------------------
// Decoders -> RGB8 (h, w, 3)
// ---------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* e = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(e->jb, 1);
}

bool decode_jpeg(FILE* f, std::vector<uint8_t>& rgb, int& w, int& h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  w = cinfo.output_width;
  h = cinfo.output_height;
  if (w <= 0 || h <= 0 || cinfo.output_components != 3 ||
      long(w) * h > kMaxPixels) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  try {
    rgb.resize(size_t(w) * h * 3);
  } catch (...) {  // bad_alloc must not unwind past the C state teardown
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = rgb.data() + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_png(FILE* f, std::vector<uint8_t>& rgb, int& w, int& h) {
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
  png_init_io(png, f);
  png_read_info(png, info);
  w = png_get_image_width(png, info);
  h = png_get_image_height(png, info);
  png_byte color = png_get_color_type(png, info);
  png_byte depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  bool trns = png_get_valid(png, info, PNG_INFO_tRNS);
  if (trns) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  // drop alpha: PIL convert("RGB") drops it too.  tRNS_to_alpha ADDS an
  // alpha channel to formats whose color_type has no alpha bit, so gate
  // on either source
  if ((color & PNG_COLOR_MASK_ALPHA) || trns) png_set_strip_alpha(png);
  png_read_update_info(png, info);
  if (png_get_channels(png, info) != 3 || w <= 0 || h <= 0) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  if (long(w) * h > kMaxPixels) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  try {
    rgb.resize(size_t(w) * h * 3);
  } catch (...) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  std::vector<png_bytep> rows(h);
  for (int y = 0; y < h; ++y) rows[y] = rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

bool decode_file(const char* path, std::vector<uint8_t>& rgb, int& w, int& h) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  bool ok = false;
  try {
    if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) {
      ok = decode_jpeg(f, rgb, w, h);
    } else if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0) {
      ok = decode_png(f, rgb, w, h);
    }
  } catch (...) {
    ok = false;  // fclose below must still run
  }
  fclose(f);
  if (ok && (long(w) * h > kMaxPixels)) ok = false;
  return ok;
}

// ---------------------------------------------------------------------
// PIL-style antialiased bicubic resampling (separable)
// ---------------------------------------------------------------------

double keys_cubic(double x) {  // Keys kernel, a = -0.5 (PIL's BICUBIC)
  const double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Taps {
  std::vector<int> lo;        // first source index per output coord
  std::vector<float> w;       // (out, ksize) weights, normalized
  int ksize;
};

Taps make_taps(int src, int dst) {
  Taps t;
  double scale = double(src) / dst;
  double support = 2.0 * std::max(1.0, scale);  // antialias on downscale
  t.ksize = int(std::ceil(support)) * 2 + 1;
  t.lo.resize(dst);
  t.w.assign(size_t(dst) * t.ksize, 0.0f);
  for (int i = 0; i < dst; ++i) {
    double center = (i + 0.5) * scale;
    int lo = std::max(0, int(center - support + 0.5));
    int hi = std::min(src, int(center + support + 0.5));
    t.lo[i] = lo;
    double sum = 0.0;
    std::vector<double> ws(hi - lo);
    for (int j = lo; j < hi; ++j) {
      double wgt = keys_cubic((j + 0.5 - center) / std::max(1.0, scale));
      ws[j - lo] = wgt;
      sum += wgt;
    }
    for (int j = 0; j < hi - lo; ++j)
      t.w[size_t(i) * t.ksize + j] = float(ws[j] / (sum ? sum : 1.0));
  }
  return t;
}

// resize (h, w, 3) f32 -> (oh, ow, 3) f32
void resize_bicubic(const float* src, int h, int w, float* dst, int oh,
                    int ow) {
  Taps tx = make_taps(w, ow), ty = make_taps(h, oh);
  // horizontal pass: (h, w, 3) -> (h, ow, 3)
  std::vector<float> mid(size_t(h) * ow * 3);
  for (int y = 0; y < h; ++y) {
    const float* row = src + size_t(y) * w * 3;
    float* orow = mid.data() + size_t(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const float* wv = &tx.w[size_t(x) * tx.ksize];
      int lo = tx.lo[x];
      float r = 0, g = 0, b = 0;
      for (int k = 0; k < tx.ksize && lo + k < w; ++k) {
        float ww = wv[k];
        if (ww == 0.0f) continue;
        const float* p = row + size_t(lo + k) * 3;
        r += ww * p[0];
        g += ww * p[1];
        b += ww * p[2];
      }
      orow[x * 3 + 0] = r;
      orow[x * 3 + 1] = g;
      orow[x * 3 + 2] = b;
    }
  }
  // vertical pass: (h, ow, 3) -> (oh, ow, 3)
  for (int y = 0; y < oh; ++y) {
    const float* wv = &ty.w[size_t(y) * ty.ksize];
    int lo = ty.lo[y];
    float* orow = dst + size_t(y) * ow * 3;
    std::memset(orow, 0, size_t(ow) * 3 * sizeof(float));
    for (int k = 0; k < ty.ksize && lo + k < h; ++k) {
      float ww = wv[k];
      if (ww == 0.0f) continue;
      const float* irow = mid.data() + size_t(lo + k) * ow * 3;
      for (int x = 0; x < ow * 3; ++x) orow[x] += ww * irow[x];
    }
  }
}

}  // namespace

extern "C" {

// Decode + short-side bicubic resize + center crop to (size, size) +
// per-channel normalize; writes CHW float32 into out (3*size*size).
// mean/stdv: 3 floats each (pass 0/1-style values to skip normalize).
// Returns 0 on success, -1 unreadable/undecodable, -2 bad args.
int mtl_load_clip(const char* path, int size, const float* mean,
                  const float* stdv, float* out) try {
  if (!path || size <= 0 || !out || !mean || !stdv) return -2;
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_file(path, rgb, w, h)) return -1;

  // short side -> size, preserving aspect (PIL Resize(int) semantics)
  int ow, oh;
  if (w <= h) {
    ow = size;
    oh = std::max(size, int(std::lround(double(size) * h / w)));
  } else {
    oh = size;
    ow = std::max(size, int(std::lround(double(size) * w / h)));
  }

  std::vector<float> srcf(rgb.size());
  for (size_t i = 0; i < rgb.size(); ++i) srcf[i] = float(rgb[i]);
  std::vector<float> res(size_t(oh) * ow * 3);
  resize_bicubic(srcf.data(), h, w, res.data(), oh, ow);

  // center crop + normalize + HWC->CHW
  int x0 = (ow - size) / 2, y0 = (oh - size) / 2;
  float m[3] = {mean[0], mean[1], mean[2]};
  float sinv[3];
  for (int c = 0; c < 3; ++c) sinv[c] = 1.0f / (stdv[c] ? stdv[c] : 1.0f);
  for (int y = 0; y < size; ++y) {
    const float* row = res.data() + (size_t(y0 + y) * ow + x0) * 3;
    for (int x = 0; x < size; ++x) {
      for (int c = 0; c < 3; ++c) {
        float v = row[x * 3 + c] * (1.0f / 255.0f);
        v = std::min(1.0f, std::max(0.0f, v));
        out[(size_t(c) * size + y) * size + x] = (v - m[c]) * sinv[c];
      }
    }
  }
  return 0;
} catch (...) {  // never let C++ exceptions cross the C ABI (std::terminate)
  return -1;
}

// Decode only: writes RGB8 into out if its capacity (cap bytes) suffices.
// Returns needed byte count (w*h*3) and fills *w_out/*h_out; negative on
// error.  Call once with cap=0 to query the size.
long mtl_decode(const char* path, uint8_t* out, long cap, int* w_out,
                int* h_out) try {
  if (!path || !w_out || !h_out) return -2;
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_file(path, rgb, w, h)) return -1;
  *w_out = w;
  *h_out = h;
  long need = long(rgb.size());
  if (out && cap >= need) std::memcpy(out, rgb.data(), need);
  return need;
} catch (...) {
  return -1;
}

}  // extern "C"
