// Frame decode, resize and crop on the card: the counterpart of the native
// loader (rubiks_loader.cpp, the JAX package's native/rubiks_loader.cpp) on
// a machine that has CUDA's nvjpeg but no libjpeg.
//
// It replaces no TPU kernel: the JAX package decodes, resizes and crops on
// the host, in C++ (decode_jpeg_file :45-73, triangle_coeffs and resize_rgb
// :87-158, write_crop_u8 :210-227, the thread pool of the u8 batch entries
// :328-396). Here:
//
//   * rdl_decode: one batch of JPEG byte strings into one device buffer of
//     interleaved RGB (NVJPEG_OUTPUT_RGBI), each frame at a caller-given
//     offset. Frames the hardware JPEG engines take (NVJPEG_BACKEND_HARDWARE,
//     nvjpegDecodeBatchedSupported) are decoded in one batched call there;
//     the others in one batched call of GPU_HYBRID, whose batched call
//     decodes Huffman on the GPU from about 100 frames a batch (the default
//     backend decodes it on the host). The frames a route took are
//     returned. The handles are created with
//     NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION: nvjpeg's default
//     replicates chroma, where libjpeg (and so the C++ loader and Pillow)
//     interpolates ("fancy" upsampling), and differs from it by tens of
//     levels at sharp chroma edges.
//   * resize_crop_u8: the shorter-side triangle-filter resize (PIL's
//     BILINEAR) and the crop of a batch of frames, 1 or 3 crops a frame,
//     to uint8 channel-last. One block a row of an output crop, one thread
//     an output channel-pixel: only the pixels inside the crop windows are
//     computed, each from its taps, which equals resizing the whole frame,
//     then cropping. It equals resize_rgb +
//     write_crop_u8 bit for bit on the same RGB: the coefficients are
//     triangle_coeffs' (double, computed on the host, uploaded), the
//     horizontal pass is summed in double in tap order and rounded to
//     float, the vertical pass summed in double over those floats, plus
//     0.5, truncated and clamped. Every product and sum is spelled with
//     __dmul_rn / __dadd_rn, so no multiply-add is contracted into an FMA
//     (g++ on x86-64 rounds each step); the file is also built with
//     -fmad=false.
//
// Bound: bytes. A frame is read inside its crop windows' footprint and each
// output byte written once; the taps are a few double multiply-adds an
// output byte (3 x 3 at the evaluator's scales). The kernel reads its taps
// from device memory and its source pixels through L1; staging source rows
// in shared memory is later work.
//
// The C interface is loaded with ctypes (rubiksnet_torch/data/
// device_loader.py). Errors: a CUDA error code as is, an nvjpeg status s
// as 1000 + s (rdl_error_string names both).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdio>
#include <vector>

#ifndef NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION
#error "this nvjpeg has no NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION: its \
replicated chroma misses the loader's bound against libjpeg's decode"
#endif

namespace {

constexpr int kNvjpegBase = 1000;
constexpr nvjpegBackend_t kFallback = NVJPEG_BACKEND_GPU_HYBRID;
constexpr unsigned int kFlags = NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION;

#define NVJ(call)                                              \
  do {                                                         \
    nvjpegStatus_t st_ = (call);                               \
    if (st_ != NVJPEG_STATUS_SUCCESS) return kNvjpegBase + st_; \
  } while (0)

struct Route {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
  int batch = -1;  // the batch size of the last DecodeBatchedInitialize
};

struct State {
  Route hw;        // the hardware engines; handle null where refused
  Route fallback;  // the backend of the frames the hardware does not take
  nvjpegJpegStream_t parsed = nullptr;  // for nvjpegDecodeBatchedSupported
  int hw_status = 0;                    // nvjpegCreateEx(HARDWARE)'s status
};

// One batched decode of `idx`'s frames on `route` into `out`.
int decode_batched(Route* route, const std::vector<int>& idx,
                   const unsigned char* const* data, const size_t* lengths,
                   const int* widths, const long long* offsets,
                   unsigned char* out, cudaStream_t stream) {
  const int b = static_cast<int>(idx.size());
  if (b == 0) return 0;
  if (route->batch != b) {
    NVJ(nvjpegDecodeBatchedInitialize(route->handle, route->state, b, 1,
                                      NVJPEG_OUTPUT_RGBI));
    route->batch = b;
  }
  std::vector<const unsigned char*> ptrs(b);
  std::vector<size_t> lens(b);
  std::vector<nvjpegImage_t> images(b);
  for (int j = 0; j < b; ++j) {
    const int i = idx[j];
    ptrs[j] = data[i];
    lens[j] = lengths[i];
    for (int c = 0; c < NVJPEG_MAX_COMPONENT; ++c) {
      images[j].channel[c] = nullptr;
      images[j].pitch[c] = 0;
    }
    images[j].channel[0] = out + offsets[i];
    images[j].pitch[0] = static_cast<size_t>(widths[i]) * 3;
  }
  NVJ(nvjpegDecodeBatched(route->handle, route->state, ptrs.data(),
                          lens.data(), images.data(), stream));
  return 0;
}

// Per frame: where its RGB starts in the decode buffer, its decoded size,
// its resized size, and where its coefficients are (cx, cy: rows of the
// (lo, count) table; wx, wy: first weight; kx, ky: weights a row). cx < 0:
// no resize (the shorter side already equals the scale, or scale 0).
struct FrameDesc {
  long long src_off;
  int w, h, rw, rh;
  int cx, cy, wx, wy, kx, ky;
};
static_assert(sizeof(FrameDesc) == 48, "FrameDesc layout is fixed by "
              "device_loader.py");

// Block (y, o) writes row y of output crop o = (g * k + kc) * group + f:
// group g's frames are crop-major (crop kc of all its `group` frames, then
// crop kc + 1), frame g * group + f of the batch; its threads walk the
// row's crop * 3 bytes, one channel-pixel each, in 32-bit index math.
__global__ void resize_crop_u8_kernel(
    const uint8_t* __restrict__ src, const FrameDesc* __restrict__ frames,
    const int* __restrict__ origins, const int* __restrict__ taps,
    const double* __restrict__ weights, int k, int group, int crop,
    uint8_t* __restrict__ out) {
  const int y = blockIdx.x;
  const int o = blockIdx.y;
  const int r = o % (k * group);
  const int kc = r / group;
  const int i = (o / (k * group)) * group + r % group;
  const FrameDesc d = frames[i];
  const int ox = origins[(i * k + kc) * 2];
  const int fy = origins[(i * k + kc) * 2 + 1] + y;
  const uint8_t* s = src + d.src_off;
  uint8_t* dst = out + (static_cast<long long>(o) * crop + y) * crop * 3;
  const int ylo = d.cx < 0 ? 0 : taps[2 * (d.cy + fy)];
  const int yn = d.cx < 0 ? 0 : taps[2 * (d.cy + fy) + 1];
  const double* ky = weights + d.wy + static_cast<long long>(fy) * d.ky;
  for (int e = threadIdx.x; e < crop * 3; e += blockDim.x) {
    const int ch = e % 3;
    const int fx = ox + e / 3;
    int v;
    if (d.cx < 0) {
      v = s[(static_cast<long long>(fy) * d.w + fx) * 3 + ch];
    } else {
      const int xlo = taps[2 * (d.cx + fx)], xn = taps[2 * (d.cx + fx) + 1];
      const double* kx = weights + d.wx + static_cast<long long>(fx) * d.kx;
      double acc = 0.0;
      for (int a = 0; a < yn; ++a) {
        const uint8_t* row =
            s + (static_cast<long long>(ylo + a) * d.w + xlo) * 3 + ch;
        double hsum = 0.0;  // resize_rgb's horizontal pass at (ylo + a, fx)
        for (int b = 0; b < xn; ++b)
          hsum = __dadd_rn(hsum, __dmul_rn(kx[b],
                                           static_cast<double>(row[b * 3])));
        const float t = __double2float_rn(hsum);
        acc = __dadd_rn(acc, __dmul_rn(ky[a], static_cast<double>(t)));
      }
      v = __double2int_rz(__dadd_rn(acc, 0.5));
      v = v < 0 ? 0 : (v > 255 ? 255 : v);
    }
    dst[e] = static_cast<uint8_t>(v);
  }
}

}  // namespace

extern "C" {

// A decode state on the current device, both handles created with kFlags:
// the hardware backend where nvjpegCreateEx takes it (its status in
// *hw_status either way) and the fallback backend, which must start.
int rdl_create(int* hw_status, void** out) {
  State* s = new State();
  *out = nullptr;
  s->hw_status = nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr,
                                kFlags, &s->hw.handle);
  *hw_status = s->hw_status;
  if (s->hw_status == NVJPEG_STATUS_SUCCESS) {
    nvjpegStatus_t st = nvjpegJpegStateCreate(s->hw.handle, &s->hw.state);
    if (st == NVJPEG_STATUS_SUCCESS)
      st = nvjpegJpegStreamCreate(s->hw.handle, &s->parsed);
    if (st != NVJPEG_STATUS_SUCCESS) {
      delete s;
      return kNvjpegBase + st;
    }
  } else {
    s->hw.handle = nullptr;
  }
  nvjpegStatus_t st = nvjpegCreateEx(kFallback, nullptr, nullptr, kFlags,
                                     &s->fallback.handle);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegJpegStateCreate(s->fallback.handle, &s->fallback.state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    delete s;
    return kNvjpegBase + st;
  }
  *out = s;
  return 0;
}

void rdl_destroy(void* state) {
  State* s = static_cast<State*>(state);
  if (s == nullptr) return;
  if (s->parsed) nvjpegJpegStreamDestroy(s->parsed);
  if (s->hw.state) nvjpegJpegStateDestroy(s->hw.state);
  if (s->hw.handle) nvjpegDestroy(s->hw.handle);
  if (s->fallback.state) nvjpegJpegStateDestroy(s->fallback.state);
  if (s->fallback.handle) nvjpegDestroy(s->fallback.handle);
  delete s;
}

// Width and height of each frame, from its header alone
// (nvjpegGetImageInfo). *failed: the first frame that did not parse, -1.
int rdl_image_info(void* state, const unsigned char* const* data,
                   const size_t* lengths, int n, int* widths, int* heights,
                   int* failed) {
  State* s = static_cast<State*>(state);
  *failed = -1;
  for (int i = 0; i < n; ++i) {
    int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT], components;
    nvjpegChromaSubsampling_t sub;
    nvjpegStatus_t st = nvjpegGetImageInfo(s->fallback.handle, data[i],
                                           lengths[i], &components, &sub, w,
                                           h);
    if (st != NVJPEG_STATUS_SUCCESS) {
      *failed = i;
      return kNvjpegBase + st;
    }
    widths[i] = w[0];
    heights[i] = h[0];
  }
  return 0;
}

// Decode n frames into `out` (device), frame i at out + offsets[i] with
// pitch widths[i] * 3, on `stream`. *hw_frames, *fallback_frames: how many
// each route decoded.
int rdl_decode(void* state, const unsigned char* const* data,
               const size_t* lengths, int n, const int* widths,
               const long long* offsets, unsigned char* out, void* stream,
               int* hw_frames, int* fallback_frames) {
  State* s = static_cast<State*>(state);
  std::vector<int> hw, rest;
  for (int i = 0; i < n; ++i) {
    int unsupported = 1;
    if (s->hw.handle != nullptr &&
        nvjpegJpegStreamParse(s->hw.handle, data[i], lengths[i], 0, 0,
                              s->parsed) == NVJPEG_STATUS_SUCCESS &&
        nvjpegDecodeBatchedSupported(s->hw.handle, s->parsed,
                                     &unsupported) == NVJPEG_STATUS_SUCCESS &&
        unsupported == 0) {
      hw.push_back(i);
    } else {
      rest.push_back(i);
    }
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = decode_batched(&s->hw, hw, data, lengths, widths, offsets, out, st);
  if (rc) return rc;
  rc = decode_batched(&s->fallback, rest, data, lengths, widths, offsets, out,
                      st);
  if (rc) return rc;
  *hw_frames = static_cast<int>(hw.size());
  *fallback_frames = static_cast<int>(rest.size());
  return static_cast<int>(cudaGetLastError());
}

// resize_crop_u8 over n frames (FrameDesc each, device), k crops a frame
// (origins: n x k x (x, y), device, in resized coordinates), frames grouped
// `group` at a time (crop-major inside a group), into out (device, n * k x
// crop x crop x 3), on `stream`: one block a row of an output crop, so at
// most 65535 output crops a launch.
int rdl_resize_crop_u8(const void* src, const void* frames,
                       const void* origins, const void* taps,
                       const void* weights, int n, int k, int group,
                       int crop, void* out, void* stream) {
  if (n == 0 || k == 0 || crop == 0) return 0;
  if (static_cast<long long>(n) * k > 65535) return cudaErrorInvalidValue;
  const dim3 grid(crop, n * k);
  resize_crop_u8_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src),
      static_cast<const FrameDesc*>(frames),
      static_cast<const int*>(origins), static_cast<const int*>(taps),
      static_cast<const double*>(weights), k, group, crop,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* rdl_error_string(int code) {
  static thread_local char buf[96];
  if (code >= kNvjpegBase) {
    std::snprintf(buf, sizeof(buf), "nvjpeg status %d", code - kNvjpegBase);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
