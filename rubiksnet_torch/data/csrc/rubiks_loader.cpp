// Native data-loading pipeline of rubiksnet_torch (the port's copy of
// native/rubiks_loader.cpp, which rubiksnet_tpu builds; same code).
//
// The reference's input pipeline decodes JPEG frames with PIL in Python
// DataLoader workers and spends most of its CPU time in decode + the
// HWC->CHW transpose (rubiksnet/transforms.py:361 notes the transpose alone
// is "80% of the loading time"). This native pipeline replaces it with:
//
//   * libjpeg decode straight to RGB
//   * separable triangle-filter (PIL-style antialiased bilinear) shorter-side
//     resize
//   * crop + normalize fused into a single write of channel-last float32
//     (the models' layout — no transpose exists at all)
//   * a std::thread worker pool decoding frames of a batch in parallel
//
// Exposed as a C API consumed via ctypes (rubiksnet_torch/data/native_loader.py).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
  JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode a JPEG file into an RGB8 buffer. Returns true on success.
bool decode_jpeg_file(const char* path, std::vector<uint8_t>* out, int* w,
                      int* h) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  *w = cinfo.output_width;
  *h = cinfo.output_height;
  out->resize(static_cast<size_t>(*w) * *h * 3);
  JSAMPROW row;
  while (cinfo.output_scanline < cinfo.output_height) {
    row = out->data() + static_cast<size_t>(cinfo.output_scanline) * *w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

// PIL-style separable triangle-filter resampling coefficients for one axis.
// Mirrors Pillow's precompute_coeffs with the BILINEAR (triangle) filter:
// support is scaled by the downscale factor, giving antialiased downsizing.
struct ResampleCoeffs {
  std::vector<int> bounds_lo;   // first source index per output pixel
  std::vector<int> counts;      // number of taps per output pixel
  std::vector<double> weights;  // ksize weights per output pixel
  int ksize;
};

ResampleCoeffs triangle_coeffs(int in_size, int out_size) {
  ResampleCoeffs c;
  double scale = static_cast<double>(in_size) / out_size;
  double filterscale = std::max(scale, 1.0);
  double support = 1.0 * filterscale;  // triangle filter support = 1
  c.ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  c.bounds_lo.resize(out_size);
  c.counts.resize(out_size);
  c.weights.assign(static_cast<size_t>(out_size) * c.ksize, 0.0);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0;
    double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(std::max(center - support + 0.5, 0.0));
    int xmax =
        static_cast<int>(std::min(center + support + 0.5, (double)in_size)) -
        xmin;
    double* k = &c.weights[static_cast<size_t>(xx) * c.ksize];
    for (int x = 0; x < xmax; ++x) {
      double arg = (x + xmin - center + 0.5) * ss;
      double weight = arg < 0 ? -arg : arg;  // |arg|
      weight = weight < 1.0 ? 1.0 - weight : 0.0;  // triangle
      k[x] = weight;
      ww += weight;
    }
    if (ww != 0.0)
      for (int x = 0; x < xmax; ++x) k[x] /= ww;
    c.bounds_lo[xx] = xmin;
    c.counts[xx] = xmax;
  }
  return c;
}

// Resize RGB8 (h, w, 3) -> RGB8 (oh, ow, 3) with the triangle filter.
void resize_rgb(const uint8_t* src, int w, int h, uint8_t* dst, int ow,
                int oh) {
  ResampleCoeffs cx = triangle_coeffs(w, ow);
  ResampleCoeffs cy = triangle_coeffs(h, oh);
  // horizontal pass into a temp (h, ow, 3) float buffer
  std::vector<float> tmp(static_cast<size_t>(h) * ow * 3);
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * w * 3;
    float* trow = tmp.data() + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow; ++x) {
      const double* k = &cx.weights[static_cast<size_t>(x) * cx.ksize];
      int lo = cx.bounds_lo[x], n = cx.counts[x];
      double r = 0, g = 0, b = 0;
      for (int i = 0; i < n; ++i) {
        const uint8_t* p = srow + static_cast<size_t>(lo + i) * 3;
        r += k[i] * p[0];
        g += k[i] * p[1];
        b += k[i] * p[2];
      }
      trow[x * 3 + 0] = static_cast<float>(r);
      trow[x * 3 + 1] = static_cast<float>(g);
      trow[x * 3 + 2] = static_cast<float>(b);
    }
  }
  // vertical pass
  for (int y = 0; y < oh; ++y) {
    const double* k = &cy.weights[static_cast<size_t>(y) * cy.ksize];
    int lo = cy.bounds_lo[y], n = cy.counts[y];
    uint8_t* drow = dst + static_cast<size_t>(y) * ow * 3;
    for (int x = 0; x < ow * 3; ++x) {
      double acc = 0;
      for (int i = 0; i < n; ++i)
        acc += k[i] * tmp[static_cast<size_t>(lo + i) * ow * 3 + x];
      int v = static_cast<int>(acc + 0.5);
      drow[x] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    }
  }
}

// Decode + (optional) shorter-side resize. On success, *img points either
// into *rgb or *resized and (*rw, *rh) hold its dims.
bool decode_resized(const char* path, int scale_size, std::vector<uint8_t>* rgb,
                    std::vector<uint8_t>* resized, const uint8_t** img,
                    int* rw, int* rh) {
  int w = 0, h = 0;
  if (!decode_jpeg_file(path, rgb, &w, &h)) return false;
  *img = rgb->data();
  *rw = w;
  *rh = h;
  if (scale_size > 0 && std::min(w, h) != scale_size) {
    // shorter-side resize (GroupScale semantics, transforms.py:82-95)
    if (w < h) {
      *rw = scale_size;
      *rh = static_cast<int>(static_cast<double>(scale_size) * h / w);
    } else {
      *rh = scale_size;
      *rw = static_cast<int>(static_cast<double>(scale_size) * w / h);
    }
    resized->resize(static_cast<size_t>(*rw) * *rh * 3);
    resize_rgb(rgb->data(), w, h, resized->data(), *rw, *rh);
    *img = resized->data();
  }
  return true;
}

// Crop + normalize one window of a resized RGB8 image into float32
// channel-last: ((v/255) - mean) / std.
bool write_crop(const uint8_t* img, int rw, int rh, int crop_x, int crop_y,
                int crop_w, int crop_h, const float* mean, const float* std_,
                float* out) {
  if (crop_x < 0) crop_x = (rw - crop_w) / 2;  // -1 => center crop
  if (crop_y < 0) crop_y = (rh - crop_h) / 2;
  if (crop_x + crop_w > rw || crop_y + crop_h > rh) return false;

  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < crop_h; ++y) {
    const uint8_t* srow =
        img + (static_cast<size_t>(crop_y + y) * rw + crop_x) * 3;
    float* drow = out + static_cast<size_t>(y) * crop_w * 3;
    for (int x = 0; x < crop_w; ++x) {
      for (int ch = 0; ch < 3; ++ch) {
        drow[x * 3 + ch] =
            (srow[x * 3 + ch] * inv255 - mean[ch]) / std_[ch];
      }
    }
  }
  return true;
}

// Crop one window of a resized RGB8 image into raw uint8 channel-last —
// a row-wise memcpy. Used by the device-normalize input path: shipping
// uint8 over the host->device link is 4x fewer bytes than normalized f32;
// the ((v/255) - mean) / std math runs inside the eval step instead.
bool write_crop_u8(const uint8_t* img, int rw, int rh, int crop_x, int crop_y,
                   int crop_w, int crop_h, uint8_t* out) {
  if (crop_x < 0) crop_x = (rw - crop_w) / 2;  // -1 => center crop
  if (crop_y < 0) crop_y = (rh - crop_h) / 2;
  if (crop_x + crop_w > rw || crop_y + crop_h > rh) return false;
  for (int y = 0; y < crop_h; ++y) {
    const uint8_t* srow =
        img + (static_cast<size_t>(crop_y + y) * rw + crop_x) * 3;
    std::memcpy(out + static_cast<size_t>(y) * crop_w * 3, srow,
                static_cast<size_t>(crop_w) * 3);
  }
  return true;
}

// Process one frame end to end. Writes (crop_h, crop_w, 3) float32
// channel-last, normalized as ((v/255) - mean) / std.
bool process_frame(const char* path, int scale_size, int crop_x, int crop_y,
                   int crop_w, int crop_h, const float* mean, const float* std_,
                   float* out) {
  std::vector<uint8_t> rgb, resized;
  const uint8_t* img = nullptr;
  int rw = 0, rh = 0;
  if (!decode_resized(path, scale_size, &rgb, &resized, &img, &rw, &rh))
    return false;
  return write_crop(img, rw, rh, crop_x, crop_y, crop_w, crop_h, mean, std_,
                    out);
}

}  // namespace

extern "C" {

// Load a batch of frames in parallel. paths: n null-terminated strings.
// Each output frame is (crop_h, crop_w, 3) float32 at out + i*frame_stride.
// crop offsets: per-frame (crop_x[i], crop_y[i]); -1 means centered.
// Returns the number of frames that failed.
int rl_load_frames(const char** paths, int n, int scale_size,
                   const int* crop_x, const int* crop_y, int crop_w,
                   int crop_h, const float* mean, const float* std_,
                   float* out, long frame_stride, int num_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      if (!process_frame(paths[i], scale_size, crop_x[i], crop_y[i], crop_w,
                         crop_h, mean, std_,
                         out + static_cast<size_t>(i) * frame_stride)) {
        failures.fetch_add(1);
      }
    }
  };
  int nt = std::max(1, num_threads);
  if (nt == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < std::min(nt, n); ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failures.load();
}

// Like rl_load_frames, but each frame is decoded + resized ONCE and then
// n_crops crop windows are written — the multi-view eval protocols
// (GroupFullResSample's 3 crops, transforms.py:164-167) crop the same
// resized frame several times, and re-decoding per crop wastes most of the
// pipeline. Crop offsets are shared across frames (crop_x/crop_y have
// n_crops entries; -1 means centered). Frame i's crop c lands at
// out + c * crop_block_stride + i * frame_stride. Returns failure count.
int rl_load_frames_mc(const char** paths, int n, int scale_size,
                      const int* crop_x, const int* crop_y, int n_crops,
                      int crop_w, int crop_h, const float* mean,
                      const float* std_, float* out, long frame_stride,
                      long crop_block_stride, int num_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb, resized;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* img = nullptr;
      int rw = 0, rh = 0;
      if (!decode_resized(paths[i], scale_size, &rgb, &resized, &img, &rw,
                          &rh)) {
        failures.fetch_add(1);
        continue;
      }
      for (int c = 0; c < n_crops; ++c) {
        if (!write_crop(img, rw, rh, crop_x[c], crop_y[c], crop_w, crop_h,
                        mean, std_,
                        out + static_cast<size_t>(c) * crop_block_stride +
                            static_cast<size_t>(i) * frame_stride)) {
          failures.fetch_add(1);
        }
      }
    }
  };
  int nt = std::max(1, num_threads);
  if (nt == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < std::min(nt, n); ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failures.load();
}

// uint8 variants of the two batch loaders: decode + resize + crop with NO
// normalization, writing raw uint8 channel-last. Shipping uint8 to the
// device and normalizing inside the eval step cuts host->device bytes 4x
// vs normalized float32 (the dominant eval cost on transfer-bound links).

int rl_load_frames_u8(const char** paths, int n, int scale_size,
                      const int* crop_x, const int* crop_y, int crop_w,
                      int crop_h, uint8_t* out, long frame_stride,
                      int num_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb, resized;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* img = nullptr;
      int rw = 0, rh = 0;
      if (!decode_resized(paths[i], scale_size, &rgb, &resized, &img, &rw,
                          &rh) ||
          !write_crop_u8(img, rw, rh, crop_x[i], crop_y[i], crop_w, crop_h,
                         out + static_cast<size_t>(i) * frame_stride)) {
        failures.fetch_add(1);
      }
    }
  };
  int nt = std::max(1, num_threads);
  if (nt == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < std::min(nt, n); ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failures.load();
}

int rl_load_frames_mc_u8(const char** paths, int n, int scale_size,
                         const int* crop_x, const int* crop_y, int n_crops,
                         int crop_w, int crop_h, uint8_t* out,
                         long frame_stride, long crop_block_stride,
                         int num_threads) {
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> rgb, resized;
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      const uint8_t* img = nullptr;
      int rw = 0, rh = 0;
      if (!decode_resized(paths[i], scale_size, &rgb, &resized, &img, &rw,
                          &rh)) {
        failures.fetch_add(1);
        continue;
      }
      for (int c = 0; c < n_crops; ++c) {
        if (!write_crop_u8(img, rw, rh, crop_x[c], crop_y[c], crop_w, crop_h,
                           out + static_cast<size_t>(c) * crop_block_stride +
                               static_cast<size_t>(i) * frame_stride)) {
          failures.fetch_add(1);
        }
      }
    }
  };
  int nt = std::max(1, num_threads);
  if (nt == 1 || n == 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < std::min(nt, n); ++t) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  return failures.load();
}

// Decode + resize + crop a single frame (uint8 output, for tests/tools).
int rl_decode_frame_u8(const char* path, int scale_size, int crop_x,
                       int crop_y, int crop_w, int crop_h, uint8_t* out) {
  float mean[3] = {0, 0, 0};
  float std_[3] = {1.0f / 255.0f, 1.0f / 255.0f, 1.0f / 255.0f};
  std::vector<float> tmp(static_cast<size_t>(crop_w) * crop_h * 3);
  if (!process_frame(path, scale_size, crop_x, crop_y, crop_w, crop_h, mean,
                     std_, tmp.data()))
    return 1;
  for (size_t i = 0; i < tmp.size(); ++i) {
    int v = static_cast<int>(tmp[i] + 0.5f);
    out[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
  return 0;
}

int rl_version() { return 3; }

}  // extern "C"
