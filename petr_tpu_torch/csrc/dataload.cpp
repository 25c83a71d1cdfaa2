// petr_tpu_torch native data-loader core (the same code as petr_tpu's
// native/dataload/dataload.cpp).
//
// Replaces the Python/PIL per-image hot path of the training input pipeline
// (JPEG decode -> antialiased bicubic resize -> crop -> horizontal flip ->
// BGR channel swap -> per-channel normalize -> zero-pad) with a single fused
// C++ call, multithreaded across the camera images of a batch.
//
// Resize matches PIL's convolution resampling (separable bicubic kernel,
// a = -0.5, with support scaling on downscale) so the native and PIL paths
// produce the same pixels to within rounding.
//
// C ABI (ctypes-friendly); see petr_tpu_torch/data/native.py for the binding
// and the build (g++, libjpeg).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

// Decode a JPEG buffer to RGB8. Returns true on success.
bool decode_jpeg(const uint8_t* buf, size_t len, std::vector<uint8_t>* out,
                 int* w, int* h) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(size_t(*w) * (*h) * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->data() + size_t(cinfo.output_scanline) * (*w) * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// PIL-style bicubic kernel (Catmull-Rom, a = -0.5).
inline double bicubic(double x) {
  constexpr double a = -0.5;
  x = std::abs(x);
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// Precompute one axis' resampling weights, PIL-style: support scales with
// the downscale ratio (antialiasing); weights normalized to sum 1.
struct AxisFilter {
  int ksize;
  std::vector<int> bounds;    // per output index: start
  std::vector<int> counts;    // per output index: number of taps
  std::vector<float> weights; // ksize per output index
};

AxisFilter make_filter(int in_size, int out_size) {
  constexpr double support_base = 2.0;  // bicubic support
  double scale = double(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = support_base * filterscale;
  int ksize = int(std::ceil(support)) * 2 + 1;

  AxisFilter f;
  f.ksize = ksize;
  f.bounds.resize(out_size);
  f.counts.resize(out_size);
  f.weights.assign(size_t(out_size) * ksize, 0.0f);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    int xmin = std::max(0, int(center - support + 0.5));
    int xmax = std::min(in_size, int(center + support + 0.5));
    float* w = &f.weights[size_t(xx) * ksize];
    double ss = 0.0;
    int n = xmax - xmin;
    for (int x = 0; x < n; ++x) {
      double val = bicubic((x + xmin - center + 0.5) / filterscale);
      w[x] = float(val);
      ss += val;
    }
    if (ss != 0.0)
      for (int x = 0; x < n; ++x) w[x] = float(w[x] / ss);
    f.bounds[xx] = xmin;
    f.counts[xx] = n;
  }
  return f;
}

}  // namespace

extern "C" {

// Per-image parameters for the fused pipeline.
struct ImageJob {
  const uint8_t* jpeg;   // encoded buffer
  int64_t jpeg_len;
  int resize_w, resize_h;       // resize target (full image)
  int crop_x, crop_y;           // crop top-left in resized coords
  int crop_w, crop_h;           // crop size
  int flip;                     // horizontal flip after crop
  int out_h, out_w;             // padded output (>= crop_h/crop_w)
  float mean[3], std[3];        // BGR-order normalization
  int to_bgr;                   // swap RGB->BGR before normalize
  float* out;                   // (out_h, out_w, 3) float32, zero-padded
};

// Process one image; returns 0 on success.
int petr_process_image(const ImageJob* job) {
  std::vector<uint8_t> rgb;
  int w = 0, h = 0;
  if (!decode_jpeg(job->jpeg, size_t(job->jpeg_len), &rgb, &w, &h)) return 1;

  // separable resize: horizontal then vertical, fp32 intermediate
  AxisFilter fx = make_filter(w, job->resize_w);
  AxisFilter fy = make_filter(h, job->resize_h);

  // horizontal pass restricted to the source rows the cropped vertical
  // pass will read (crop happens before rotate, so the row window is exact)
  int ry_lo = std::max(0, job->crop_y);
  int ry_hi = std::min(job->resize_h, job->crop_y + job->crop_h);
  int y_lo = h, y_hi = 0;
  for (int ry = ry_lo; ry < ry_hi; ++ry) {
    y_lo = std::min(y_lo, fy.bounds[ry]);
    y_hi = std::max(y_hi, fy.bounds[ry] + fy.counts[ry]);
  }
  y_lo = std::max(0, std::min(y_lo, h));
  y_hi = std::max(y_lo, std::min(y_hi, h));

  // also restrict columns to the crop window's taps
  int rx_lo = std::max(0, job->crop_x);
  int rx_hi = std::min(job->resize_w, job->crop_x + job->crop_w);

  std::vector<float> tmp(size_t(h) * job->resize_w * 3);
  for (int y = y_lo; y < y_hi; ++y) {
    const uint8_t* src = rgb.data() + size_t(y) * w * 3;
    float* dst = tmp.data() + size_t(y) * job->resize_w * 3;
    for (int xx = rx_lo; xx < rx_hi; ++xx) {
      const float* wgt = &fx.weights[size_t(xx) * fx.ksize];
      int x0 = fx.bounds[xx], n = fx.counts[xx];
      float acc0 = 0, acc1 = 0, acc2 = 0;
      const uint8_t* p = src + size_t(x0) * 3;
      for (int k = 0; k < n; ++k, p += 3) {
        acc0 += wgt[k] * p[0];
        acc1 += wgt[k] * p[1];
        acc2 += wgt[k] * p[2];
      }
      dst[xx * 3 + 0] = acc0;
      dst[xx * 3 + 1] = acc1;
      dst[xx * 3 + 2] = acc2;
    }
  }

  // zero output (padding)
  std::memset(job->out, 0, size_t(job->out_h) * job->out_w * 3 * sizeof(float));

  // vertical pass fused with crop/flip/normalize/pad: row-major axpy over
  // the crop window (sequential reads of tmp, vectorizable inner loops)
  int row_px = rx_hi - rx_lo;
  std::vector<float> acc_row(std::max(row_px, 0) * 3);
  for (int yy = 0; yy < job->crop_h; ++yy) {
    int out_y = yy;
    if (out_y >= job->out_h) break;
    int ry = yy + job->crop_y;  // row in resized image
    if (ry < 0 || ry >= job->resize_h || row_px <= 0) continue;
    const float* wgt = &fy.weights[size_t(ry) * fy.ksize];
    int y0 = fy.bounds[ry], n = fy.counts[ry];
    std::fill(acc_row.begin(), acc_row.end(), 0.0f);
    for (int k = 0; k < n; ++k) {
      const float wk = wgt[k];
      const float* src = tmp.data() + (size_t(y0 + k) * job->resize_w + rx_lo) * 3;
      float* a = acc_row.data();
      for (int i = 0; i < row_px * 3; ++i) a[i] += wk * src[i];
    }
    float* dst = job->out + size_t(out_y) * job->out_w * 3;
    const float m0 = job->mean[0], m1 = job->mean[1], m2 = job->mean[2];
    const float is0 = 1.0f / job->std[0], is1 = 1.0f / job->std[1],
                is2 = 1.0f / job->std[2];
    for (int xx = 0; xx < row_px; ++xx) {
      float r = std::min(255.0f, std::max(0.0f, acc_row[xx * 3 + 0]));
      float g = std::min(255.0f, std::max(0.0f, acc_row[xx * 3 + 1]));
      float b = std::min(255.0f, std::max(0.0f, acc_row[xx * 3 + 2]));
      int cx = (rx_lo - job->crop_x) + xx;  // x within the crop
      int out_x = job->flip ? (job->crop_w - 1 - cx) : cx;
      if (out_x < 0 || out_x >= job->out_w) continue;
      float* q = dst + size_t(out_x) * 3;
      if (job->to_bgr) {
        q[0] = (b - m0) * is0;
        q[1] = (g - m1) * is1;
        q[2] = (r - m2) * is2;
      } else {
        q[0] = (r - m0) * is0;
        q[1] = (g - m1) * is1;
        q[2] = (b - m2) * is2;
      }
    }
  }
  return 0;
}

// Process a batch of images across a thread pool; returns number of failures.
int petr_process_batch(const ImageJob* jobs, int n_jobs, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_jobs) return;
      if (petr_process_image(&jobs[i]) != 0) failures.fetch_add(1);
    }
  };
  std::vector<std::thread> threads;
  int nt = std::min(n_threads, n_jobs);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
