// Native host preprocessing: fused JPEG decode -> antialiased bicubic resize
// -> crop -> hflip -> normalize, single pass, no Python in the loop.
//
// The data tier's host decoding, a copy of the JAX package's
// masterthesis_tpu/native/preproc.cc kept in the port's own tree so that the
// port builds and loads its own library. One C call does the whole per-image
// pipeline with the GIL released (called through ctypes from the loader's
// thread), using libjpeg's DCT-domain downscaling (1/2, 1/4, 1/8) to skip
// decoding pixels that the resize would throw away.
//
// Resampling matches PIL's convolution resampling: bicubic filter
// (Catmull-Rom, a = -0.5) with support scaled by the downscale ratio
// (antialiasing), separable horizontal+vertical passes, clamped edges.
//
// Build (masterthesis_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -march=native -shared -fPIC preproc.cc -ljpeg -o libmtpreproc.so

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG buffer to RGB8. Picks the largest libjpeg DCT scale
// (1/1..1/8) whose output is still >= (min_h, min_w).
bool decode_jpeg(const uint8_t* buf, size_t len, int min_h, int min_w,
                 std::vector<uint8_t>* out, int* out_h, int* out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(buf), len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  // DCT-domain downscale: keep the smallest image that still covers the
  // resize target (with a 1x safety margin for the antialias kernel).
  cinfo.scale_num = 1;
  cinfo.scale_denom = 1;
  for (int denom = 8; denom >= 1; denom >>= 1) {
    if (static_cast<int>(cinfo.image_height) / denom >= min_h &&
        static_cast<int>(cinfo.image_width) / denom >= min_w) {
      cinfo.scale_denom = denom;
      break;
    }
  }
  jpeg_start_decompress(&cinfo);
  const int h = cinfo.output_height;
  const int w = cinfo.output_width;
  const int ch = cinfo.output_components;  // 3 for RGB
  if (ch != 3) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  out->resize(static_cast<size_t>(h) * w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  *out_h = h;
  *out_w = w;
  return true;
}

// PIL-style bicubic filter (a = -0.5), support 2.
inline double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct ResampleCoeffs {
  std::vector<int> bounds_lo;   // first source index per output pixel
  std::vector<int> counts;      // taps per output pixel
  std::vector<double> weights;  // ksize weights per output pixel
  int ksize;
};

// Precompute per-output-pixel weights like PIL's precompute_coeffs:
// filter support is scaled by the downscale ratio (antialias).
ResampleCoeffs precompute(int in_size, int out_size) {
  ResampleCoeffs rc;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = 2.0 * filterscale;
  rc.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  rc.bounds_lo.resize(out_size);
  rc.counts.resize(out_size);
  rc.weights.assign(static_cast<size_t>(out_size) * rc.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int lo = static_cast<int>(center - support + 0.5);
    if (lo < 0) lo = 0;
    int hi = static_cast<int>(center + support + 0.5);
    if (hi > in_size) hi = in_size;
    const int n = hi - lo;
    double* w = &rc.weights[static_cast<size_t>(xx) * rc.ksize];
    double total = 0.0;
    for (int i = 0; i < n; ++i) {
      w[i] = bicubic((lo + i - center + 0.5) / filterscale);
      total += w[i];
    }
    if (total != 0.0) {
      for (int i = 0; i < n; ++i) w[i] /= total;
    }
    rc.bounds_lo[xx] = lo;
    rc.counts[xx] = n;
  }
  return rc;
}

inline uint8_t clamp_u8(double v) {
  const int iv = static_cast<int>(v + 0.5);
  return static_cast<uint8_t>(std::min(255, std::max(0, iv)));
}

// Separable resize u8 RGB (h, w) -> (out_h, out_w), uint8 rounding per pass
// (PIL resamples in its I;8 pipeline with per-pass clipping).
void resize_bicubic(const uint8_t* src, int h, int w, int out_h, int out_w,
                    std::vector<uint8_t>* dst) {
  const ResampleCoeffs rcx = precompute(w, out_w);
  const ResampleCoeffs rcy = precompute(h, out_h);
  // horizontal pass: (h, w) -> (h, out_w)
  std::vector<uint8_t> tmp(static_cast<size_t>(h) * out_w * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w * 3;
    uint8_t* orow = tmp.data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w; ++x) {
      const double* wts = &rcx.weights[static_cast<size_t>(x) * rcx.ksize];
      const int lo = rcx.bounds_lo[x];
      const int n = rcx.counts[x];
      double acc[3] = {0, 0, 0};
      for (int i = 0; i < n; ++i) {
        const uint8_t* p = row + static_cast<size_t>(lo + i) * 3;
        acc[0] += wts[i] * p[0];
        acc[1] += wts[i] * p[1];
        acc[2] += wts[i] * p[2];
      }
      orow[x * 3 + 0] = clamp_u8(acc[0]);
      orow[x * 3 + 1] = clamp_u8(acc[1]);
      orow[x * 3 + 2] = clamp_u8(acc[2]);
    }
  }
  // vertical pass: (h, out_w) -> (out_h, out_w)
  dst->resize(static_cast<size_t>(out_h) * out_w * 3);
  for (int y = 0; y < out_h; ++y) {
    const double* wts = &rcy.weights[static_cast<size_t>(y) * rcy.ksize];
    const int lo = rcy.bounds_lo[y];
    const int n = rcy.counts[y];
    uint8_t* orow = dst->data() + static_cast<size_t>(y) * out_w * 3;
    for (int x = 0; x < out_w * 3; ++x) {
      double acc = 0;
      for (int i = 0; i < n; ++i) {
        acc += wts[i] * tmp[static_cast<size_t>(lo + i) * out_w * 3 + x];
      }
      orow[x] = clamp_u8(acc);
    }
  }
}

}  // namespace

extern "C" {

// Full fused pipeline. Returns 0 on success.
//   jpeg/len      : encoded JPEG buffer
//   load_h/load_w : resize target (reference: (load_size, load_size))
//   crop_top/left : crop origin inside the resized image
//   crop_size     : square crop side
//   flip          : 1 to mirror horizontally
//   normalize     : 1 -> out float32 in [-1, 1]; 0 -> out is uint8 [0,255]
//   out           : crop_size*crop_size*3 floats (or bytes if !normalize)
int mt_preprocess(const uint8_t* jpeg, size_t len, int load_h, int load_w,
                  int crop_top, int crop_left, int crop_size, int flip,
                  int normalize, void* out) {
  std::vector<uint8_t> decoded;
  int h = 0, w = 0;
  if (!decode_jpeg(jpeg, len, load_h, load_w, &decoded, &h, &w)) return 1;
  std::vector<uint8_t> resized;
  const uint8_t* img = decoded.data();
  if (h != load_h || w != load_w) {
    resize_bicubic(decoded.data(), h, w, load_h, load_w, &resized);
    img = resized.data();
  }
  if (crop_top < 0 || crop_left < 0 || crop_top + crop_size > load_h ||
      crop_left + crop_size > load_w) {
    return 2;
  }
  float* fout = static_cast<float*>(out);
  uint8_t* uout = static_cast<uint8_t*>(out);
  for (int y = 0; y < crop_size; ++y) {
    const uint8_t* row =
        img + (static_cast<size_t>(crop_top + y) * load_w + crop_left) * 3;
    for (int x = 0; x < crop_size; ++x) {
      const int sx = flip ? (crop_size - 1 - x) : x;
      const uint8_t* p = row + static_cast<size_t>(sx) * 3;
      const size_t o = (static_cast<size_t>(y) * crop_size + x) * 3;
      if (normalize) {
        fout[o + 0] = p[0] * (2.0f / 255.0f) - 1.0f;
        fout[o + 1] = p[1] * (2.0f / 255.0f) - 1.0f;
        fout[o + 2] = p[2] * (2.0f / 255.0f) - 1.0f;
      } else {
        uout[o + 0] = p[0];
        uout[o + 1] = p[1];
        uout[o + 2] = p[2];
      }
    }
  }
  return 0;
}

// Decode + resize only (no crop): out is load_h*load_w*3 uint8.
int mt_decode_resize(const uint8_t* jpeg, size_t len, int load_h, int load_w,
                     uint8_t* out) {
  std::vector<uint8_t> decoded;
  int h = 0, w = 0;
  if (!decode_jpeg(jpeg, len, load_h, load_w, &decoded, &h, &w)) return 1;
  if (h == load_h && w == load_w) {
    std::memcpy(out, decoded.data(), static_cast<size_t>(load_h) * load_w * 3);
    return 0;
  }
  std::vector<uint8_t> resized;
  resize_bicubic(decoded.data(), h, w, load_h, load_w, &resized);
  std::memcpy(out, resized.data(), resized.size());
  return 0;
}

}  // extern "C"
