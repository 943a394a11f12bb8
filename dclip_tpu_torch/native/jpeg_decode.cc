// Native JPEG decode + preprocess for the host input pipeline: the port's
// own copy of the JAX package's decoder (dclip_tpu/native/jpeg_decode.cc),
// built by dclip_tpu_torch/native/__init__.py with the same flags, so the
// two give the same bits on one host.
//
// One C call takes raw JPEG bytes and emits BOTH pipeline tensors
// (dclip_tpu_torch/data/pipeline.py::_load_item):
//   - student: shortest-side bicubic resize + center crop to [S, S, 3],
//     rescaled 1/255 and CLIP mean/std normalized (float32),
//   - teacher: full-frame bilinear squash to [T, T, 3] in [0, 1] (float32),
// plus the ORIGINAL frame size (the caller rescales detection boxes with
// it). Replaces, per image: PIL decode -> convert("RGB") -> two PIL
// resizes -> three numpy float passes. ctypes releases the GIL around the
// call, and libjpeg's scaled DCT decode (the `fast` flag) emits a 1/2 /
// 1/4 / 1/8-scale frame directly from the coefficients, like PIL's
// Image.draft.
//
// Resampling follows PIL's convention (separable convolution with the
// filter support scaled by the downscale ratio, i.e. antialiased), with
// bicubic a = -0.5, so outputs track the PIL path within ~1 LSB; exact
// bit-parity with PIL is NOT a goal. On a machine without PIL this is the
// only file route of the training CLIs.
//
// Built as its own .so (libdclip_jpeg.so) so the KV-store/topk library
// never grows a libjpeg dependency.

#include <algorithm>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void on_message(j_common_ptr) {}  // silence warnings entirely

// -- PIL-convention separable resampling -------------------------------------

inline double bicubic_filter(double x) {
  // PIL's bicubic kernel, a = -0.5, support 2.
  constexpr double a = -0.5;
  x = std::fabs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

inline double bilinear_filter(double x) {
  x = std::fabs(x);
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Coeffs {
  // For each output index: input window [start, start+n) and n weights.
  std::vector<int> start;
  std::vector<int> count;
  std::vector<float> weights;  // stride = max window size
  int stride = 0;
};

// Weights for mapping `in_size` samples onto `out_size` samples over the
// output range [out0, out0 + out_n) — out0 > 0 implements the center crop
// without resizing pixels that the crop discards.
Coeffs make_coeffs(int in_size, int out_size, int out0, int out_n,
                   bool bicubic) {
  const double support0 = bicubic ? 2.0 : 1.0;
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = support0 * filterscale;
  const int max_w = static_cast<int>(std::ceil(support)) * 2 + 1;
  Coeffs c;
  c.stride = max_w;
  c.start.resize(out_n);
  c.count.resize(out_n);
  c.weights.assign(static_cast<size_t>(out_n) * max_w, 0.0f);
  for (int i = 0; i < out_n; ++i) {
    const double center = (out0 + i + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    int xmax = static_cast<int>(center + support + 0.5);
    xmin = std::max(xmin, 0);
    xmax = std::min(xmax, in_size);
    double total = 0.0;
    std::vector<double> w(xmax - xmin);
    for (int x = xmin; x < xmax; ++x) {
      const double v = bicubic
          ? bicubic_filter((x - center + 0.5) / filterscale)
          : bilinear_filter((x - center + 0.5) / filterscale);
      w[x - xmin] = v;
      total += v;
    }
    if (total <= 0.0) total = 1.0;
    c.start[i] = xmin;
    c.count[i] = xmax - xmin;
    for (int x = 0; x < xmax - xmin; ++x)
      c.weights[static_cast<size_t>(i) * max_w + x] =
          static_cast<float>(w[x] / total);
  }
  return c;
}

// Horizontal pass: [h, in_w, 3] u8 -> [h, out_n, 3] f32.
void resample_h(const uint8_t* in, int h, int in_w, const Coeffs& cx,
                float* out, int out_n) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + static_cast<size_t>(y) * in_w * 3;
    float* orow = out + static_cast<size_t>(y) * out_n * 3;
    for (int i = 0; i < out_n; ++i) {
      const float* w = &cx.weights[static_cast<size_t>(i) * cx.stride];
      const int s = cx.start[i], n = cx.count[i];
      float r = 0.f, g = 0.f, b = 0.f;
      for (int k = 0; k < n; ++k) {
        const uint8_t* px = row + (s + k) * 3;
        r += w[k] * px[0];
        g += w[k] * px[1];
        b += w[k] * px[2];
      }
      orow[i * 3 + 0] = r;
      orow[i * 3 + 1] = g;
      orow[i * 3 + 2] = b;
    }
  }
}

// Vertical pass: [in_h, w, 3] f32 -> [out_n, w, 3] f32.
void resample_v(const float* in, int in_h, int w, const Coeffs& cy,
                float* out, int out_n) {
  for (int i = 0; i < out_n; ++i) {
    const float* wt = &cy.weights[static_cast<size_t>(i) * cy.stride];
    const int s = cy.start[i], n = cy.count[i];
    float* orow = out + static_cast<size_t>(i) * w * 3;
    std::memset(orow, 0, sizeof(float) * w * 3);
    for (int k = 0; k < n; ++k) {
      const float* irow = in + static_cast<size_t>(s + k) * w * 3;
      const float f = wt[k];
      for (int x = 0; x < w * 3; ++x) orow[x] += f * irow[x];
    }
  }
}

// PIL rounds resampled values to uint8 between the resize and the numpy
// float conversion; mirror that so outputs track the Python path.
inline float clamp_u8(float v) {
  return std::min(255.0f, std::max(0.0f, std::nearbyint(v)));
}

}  // namespace

extern "C" {

// Decode + preprocess one JPEG. Returns 0 on success; nonzero on any
// decode error (caller falls back to PIL). `mean`/`stdv` are per-channel
// [3] normalization constants for the student tensor; pass NULL to skip
// (student then comes out in [0, 1] like the teacher tensor).
int dcj_decode_preprocess(const uint8_t* data, size_t len, int student_size,
                          int teacher_size, int fast, const float* mean,
                          const float* stdv, float* student_out,
                          float* teacher_out, int* orig_wh) {
  if (!data || len < 4 || student_size <= 0 || teacher_size <= 0) return 1;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = on_error;
  jerr.pub.output_message = on_message;
  // The frame buffer is a malloc'd pointer declared VOLATILE and BEFORE
  // the setjmp: a libjpeg error inside the scanline loop longjmps back
  // here, which both skips destructors (a std::vector constructed after
  // the setjmp would leak w*h*3 bytes per corrupt image, every epoch)
  // and leaves non-volatile locals modified since setjmp indeterminate.
  uint8_t* volatile frame = nullptr;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    std::free(frame);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  const int orig_w = static_cast<int>(cinfo.image_width);
  const int orig_h = static_cast<int>(cinfo.image_height);
  if (orig_w <= 0 || orig_h <= 0) {
    jpeg_destroy_decompress(&cinfo);
    return 4;
  }
  cinfo.out_color_space = JCS_RGB;  // grayscale/YCbCr -> RGB in-decoder
  if (fast) {
    // Same contract as PIL's Image.draft: the largest 1/2^k shrink whose
    // shortest side still covers every consumer.
    const int target = std::max(student_size, teacher_size);
    int denom = 1;
    while (denom < 8 &&
           std::min(orig_w, orig_h) / (denom * 2) >= target)
      denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = static_cast<unsigned>(denom);
  }
  jpeg_start_decompress(&cinfo);
  const int w = static_cast<int>(cinfo.output_width);
  const int h = static_cast<int>(cinfo.output_height);
  if (w <= 0 || h <= 0 || cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 5;
  }
  frame = static_cast<uint8_t*>(std::malloc(static_cast<size_t>(w) * h * 3));
  if (!frame) {
    jpeg_destroy_decompress(&cinfo);
    return 6;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* rowp = frame + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &rowp, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  // No libjpeg calls (hence no longjmp) past this point: RAII owns the
  // frame for the resample stages below.
  std::unique_ptr<uint8_t, void (*)(void*)> frame_guard(frame, &std::free);

  // ---- student: shortest-side bicubic resize + center crop --------------
  // HF geometry (pipeline.resize_crop_uint8): shortest edge -> S, long
  // side int()-truncated.
  const int S = student_size;
  int nw, nh;
  if (w <= h) {
    nw = S;
    nh = static_cast<int>(static_cast<int64_t>(S) * h / w);
  } else {
    nw = static_cast<int>(static_cast<int64_t>(S) * w / h);
    nh = S;
  }
  const int left = (nw - S) / 2;
  const int top = (nh - S) / 2;
  {
    Coeffs cx = make_coeffs(w, nw, left, S, /*bicubic=*/true);
    Coeffs cy = make_coeffs(h, nh, top, S, /*bicubic=*/true);
    std::vector<float> tmp(static_cast<size_t>(h) * S * 3);
    resample_h(frame_guard.get(), h, w, cx, tmp.data(), S);
    std::vector<float> res(static_cast<size_t>(S) * S * 3);
    resample_v(tmp.data(), h, S, cy, res.data(), S);
    const float m0 = mean ? mean[0] : 0.f, m1 = mean ? mean[1] : 0.f,
                m2 = mean ? mean[2] : 0.f;
    const float d0 = stdv ? stdv[0] : 1.f, d1 = stdv ? stdv[1] : 1.f,
                d2 = stdv ? stdv[2] : 1.f;
    for (size_t i = 0; i < static_cast<size_t>(S) * S; ++i) {
      student_out[i * 3 + 0] =
          (clamp_u8(res[i * 3 + 0]) / 255.0f - m0) / d0;
      student_out[i * 3 + 1] =
          (clamp_u8(res[i * 3 + 1]) / 255.0f - m1) / d1;
      student_out[i * 3 + 2] =
          (clamp_u8(res[i * 3 + 2]) / 255.0f - m2) / d2;
    }
  }

  // ---- teacher: full-frame bilinear squash to [T, T], in [0, 1] ----------
  {
    const int T = teacher_size;
    Coeffs cx = make_coeffs(w, T, 0, T, /*bicubic=*/false);
    Coeffs cy = make_coeffs(h, T, 0, T, /*bicubic=*/false);
    std::vector<float> tmp(static_cast<size_t>(h) * T * 3);
    resample_h(frame_guard.get(), h, w, cx, tmp.data(), T);
    std::vector<float> res(static_cast<size_t>(T) * T * 3);
    resample_v(tmp.data(), h, T, cy, res.data(), T);
    for (size_t i = 0; i < static_cast<size_t>(T) * T * 3; ++i)
      teacher_out[i] = clamp_u8(res[i]) / 255.0f;
  }

  if (orig_wh) {
    orig_wh[0] = orig_w;
    orig_wh[1] = orig_h;
  }
  return 0;
}

}  // extern "C"
