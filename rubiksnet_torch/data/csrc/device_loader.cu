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
//     to uint8 channel-last. Only the pixels inside the crop windows are
//     computed, each from its taps, which equals resizing the whole frame,
//     then cropping. It equals resize_rgb + write_crop_u8 bit for bit on
//     the same RGB: the coefficients are triangle_coeffs' (double, computed
//     on the host), the horizontal pass is summed in double in tap order
//     and rounded to float, the vertical pass summed in double over those
//     floats, plus 0.5, truncated and clamped. Every product and sum is
//     spelled with __dmul_rn / __dadd_rn, so no multiply-add is contracted
//     into an FMA (g++ on x86-64 rounds each step); the file is also built
//     with -fmad=false. Two kernels:
//       - resize_crop_u8_staged (the default route): a block a band of
//         output rows of one crop (a launch plan in device_loader.py,
//         resize_crop_plan). A resized frame's block stages its column and
//         row taps, then the source rows its taps reach (only the columns
//         the crop's taps reach, as the aligned 16-byte words that cover
//         them, by cp.async), computes the horizontal pass once per staged
//         row, column and channel into floats in shared memory (the float
//         resize_rgb keeps between its passes, so sharing it across output
//         rows is exact), then the vertical pass, four output bytes a
//         thread. A block walks a run of bands: its taps are staged once,
//         and the next band's source rows are copied in while this band
//         computes. A frame only cropped is copied: 16-byte stores, each
//         from the two aligned 16-byte loads that cover it, shifted into
//         place.
//       - resize_crop_u8_kernel (route "previous", the first form): a block
//         a row of an output crop, a thread an output byte, its taps read
//         from device memory and its source bytes through L1, the
//         horizontal pass recomputed for each vertical tap.
//
// Bound: bytes at the evaluator's shapes (each source byte the crops reach
// read once, each output byte written once). Copying, the staged kernel
// comes near it. Resizing, it is held by the float64 arithmetic and its
// latency, not by bytes: about ten unfused float64 operations an output
// byte (the vertical taps, the horizontal pass shared by about 1.06 output
// rows at 240 -> 256, the rounding), each thread's chain of shared loads
// and dependent steps, and two block barriers a band. Its design answers
// what it can: a block stages its taps once for a run of bands and copies
// the next band's rows in while this one computes (a block a band waited
// on both), its loops walk their items without a division, a byte becomes
// a double by 2^52 + v - 2^52 and the final truncation is an add of 2^52
// rounded toward zero (no conversion pipe), four output bytes pack into
// one 32-bit store, and the plan's rows, run and threads are read off
// utils/resize_crop_probe.py --sweep (--phases times the kernel with a
// phase taken out).
//
// The C interface is loaded with ctypes (rubiksnet_torch/data/
// device_loader.py). Errors: a CUDA error code as is, an nvjpeg status s
// as 1000 + s (rdl_error_string names both).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
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

// ------------------------------------------------------- the staged route

constexpr int kMaxSmem = 232448;  // bytes of shared memory a block can use
constexpr int kPlanLen = 20;      // ints of a plan (device_loader.py)
constexpr int kMaxThreads = 512;  // threads a block, at most (two an SM)
constexpr double kTwo52 = 4503599627370496.0;

// Per frame of the staged route: its RGB, and for a resized frame its axis
// tables on the card (a (first tap, count) pair and kx or ky weights an
// output column or row). xt null: the frame is only cropped.
struct StagedFrame {
  long long src_off;
  const int2* xt;
  const double* xw;
  const int2* yt;
  const double* yw;
  int w, h, kx, ky;
};
static_assert(sizeof(StagedFrame) == 56, "StagedFrame layout is fixed by "
              "device_loader.py");

// resize_crop_plan's numbers, in its order: a crop is `bands` bands of
// `rows` output rows by `tiles` tiles of `tile` output columns, and a
// block walks `run` bands of one tile (`runs` x `tiles` blocks a crop); at
// most `smax` staged source rows of `pitch` bytes a band (two buffers), the
// horizontal pass `hp_pitch` floats a row; kx, ky: the most weights a
// column or row of the batch has; the byte offsets of the shared-memory
// arrays; `vec`: the copy may store 16 bytes at a time.
struct StagedPlan {
  int rows, tile, bands, tiles, run, runs, threads, smax, pitch, hp_pitch;
  int kx, ky, off_cw, off_rw, off_hp, off_src, off_ct, off_rt, vec;
};

// v (a byte) as a double, exactly, on the float64 pipe: 2^52 + v - 2^52.
__device__ __forceinline__ double byte_to_double(unsigned v) {
  return __dsub_rn(__hiloint2double(0x43300000, static_cast<int>(v)),
                   kTwo52);
}

// trunc(acc + 0.5) clamped to a byte, for acc >= 0: the add of 2^52
// rounded toward zero leaves floor(t) in the low word.
__device__ __forceinline__ unsigned round_byte(double acc) {
  const double t = __dadd_rn(acc, 0.5);
  const int v = __double2loint(__dadd_rz(t, kTwo52));
  return static_cast<unsigned>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The items tid, tid + nt, ... of a grid `cols` wide as (row r, column c),
// a step without a division.
struct Walk {
  int r, c, dr, dc, cols;
  __device__ Walk(int tid, int nt, int cols_)
      : r(tid / cols_), c(tid % cols_), dr(nt / cols_), dc(nt % cols_),
        cols(cols_) {}
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// The 16 bytes at p, from the aligned 16-byte words that cover them (one,
// or two shifted into place). A word that holds a byte of the frame lies
// in the frame's page, so reading all of it is safe.
__device__ __forceinline__ uint4 load_shifted(const uint8_t* p) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  const uint4* a = reinterpret_cast<const uint4*>(addr & ~uintptr_t(15));
  const unsigned sh = static_cast<unsigned>(addr & 15);
  const uint4 lo = __ldg(a);
  if (sh == 0) return lo;
  const uint4 hi = __ldg(a + 1);
  const unsigned q = sh >> 2, r = (sh & 3) * 8;
  // Words q .. q + 4 of lo:hi, by selects (no indexed array).
  const uint32_t s0 = q == 0 ? lo.x : q == 1 ? lo.y : q == 2 ? lo.z : lo.w;
  const uint32_t s1 = q == 0 ? lo.y : q == 1 ? lo.z : q == 2 ? lo.w : hi.x;
  const uint32_t s2 = q == 0 ? lo.z : q == 1 ? lo.w : q == 2 ? hi.x : hi.y;
  const uint32_t s3 = q == 0 ? lo.w : q == 1 ? hi.x : q == 2 ? hi.y : hi.z;
  const uint32_t s4 = q == 0 ? hi.x : q == 1 ? hi.y : q == 2 ? hi.z : hi.w;
  return make_uint4(__funnelshift_r(s0, s1, r), __funnelshift_r(s1, s2, r),
                    __funnelshift_r(s2, s3, r), __funnelshift_r(s3, s4, r));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
               "l"(gmem)
               : "memory");
}

// A frame only cropped: rows [y0, y0 + rows) x columns [x0, x0 + cols) of
// the crop at (fx, fy) of the frame, into dst (the band's first row).
__device__ void copy_band(const uint8_t* s, int w, int fx, int fy, int rows,
                          int cols, int crop, bool vec, uint8_t* dst) {
  const int rowb = crop * 3;
  const uint8_t* from = s + (static_cast<long long>(fy) * w + fx) * 3;
  const long long pitch_g = static_cast<long long>(w) * 3;
  const int nb = vec ? rowb / 16 : cols * 3;  // vec: cols == crop
  for (Walk it(threadIdx.x, blockDim.x, nb); it.r < rows; it.next()) {
    if (vec) {
      *reinterpret_cast<uint4*>(dst + it.r * rowb + 16 * it.c) =
          load_shifted(from + it.r * pitch_g + 16 * it.c);
    } else {
      dst[it.r * rowb + it.c] = from[it.r * pitch_g + it.c];
    }
  }
}

// Block (run * tiles + tile, o): a run of `run` bands of `rows` output rows
// and columns [tile * tile_w, +tile_w) of output crop o (o as in the
// previous kernel: group-major, crop-major inside a group). Its taps are
// staged once; the source rows of band j + 1 are copied in (cp.async, two
// buffers) while band j computes.
__global__ void __launch_bounds__(kMaxThreads, 2) resize_crop_u8_staged(
    const uint8_t* __restrict__ src, const StagedFrame* __restrict__ frames,
    const int* __restrict__ origins, int k, int group, int crop,
    StagedPlan p, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int run = blockIdx.x / p.tiles, tile = blockIdx.x - run * p.tiles;
  const int o = blockIdx.y;
  const int r = o % (k * group);
  const int kc = r / group;
  const int i = (o / (k * group)) * group + r % group;
  const StagedFrame d = frames[i];
  const int nband = min(p.run, p.bands - run * p.run);
  const int y0 = run * p.run * p.rows, yrows = min(nband * p.rows, crop - y0);
  const int x0 = tile * p.tile, cols = min(p.tile, crop - x0);
  const int fx0 = origins[(i * k + kc) * 2] + x0;
  const int fy0 = origins[(i * k + kc) * 2 + 1] + y0;
  const int rowb = crop * 3;
  const uint8_t* s = src + d.src_off;
  uint8_t* dst = out + (static_cast<long long>(o) * crop + y0) * rowb + x0 * 3;
  if (d.xt == nullptr) {
    copy_band(s, d.w, fx0, fy0, yrows, cols, crop, p.vec != 0, dst);
    return;
  }
  double* cw = reinterpret_cast<double*>(smem + p.off_cw);  // [kx][tile]
  double* rw = reinterpret_cast<double*>(smem + p.off_rw);  // [run rows][ky]
  float* hp = reinterpret_cast<float*>(smem + p.off_hp);    // [smax][hp_pitch]
  int2* ct = reinterpret_cast<int2*>(smem + p.off_ct);      // [tile]
  int2* rt = reinterpret_cast<int2*>(smem + p.off_rt);      // [run rows]
  // 1. The taps, once: the tile's columns (weights tap-major, so a warp
  // reads consecutive doubles) and the run's rows.
  for (int x = tid; x < cols; x += nt) ct[x] = d.xt[fx0 + x];
  for (Walk it(tid, nt, d.kx); it.r < cols; it.next())
    cw[it.c * p.tile + it.r] =
        d.xw[static_cast<long long>(fx0 + it.r) * d.kx + it.c];
  for (int y = tid; y < yrows; y += nt) rt[y] = d.yt[fy0 + y];
  for (int e = tid; e < yrows * d.ky; e += nt)
    rw[e] = d.yw[static_cast<long long>(fy0) * d.ky + e];
  __syncthreads();
  // Both axes' first taps and ends grow with the output coordinate.
  const int c0 = ct[0].x, nb = (ct[cols - 1].x + ct[cols - 1].y - c0) * 3;
  if (nb + 15 > p.pitch) __trap();  // the plan is wrong
  const uint8_t* col0 = s + c0 * 3;
  const long long pitch_g = static_cast<long long>(d.w) * 3;
  // 2. Band j's source rows: the aligned 16-byte words that cover each
  // row's span (the span of source row q starts at byte
  // (col0 + q * pitch_g) & 15 of its staged row), into buffer j & 1.
  auto stage = [&](int j) {
    const int yb = j * p.rows, last = min(yb + p.rows, yrows) - 1;
    const int q0 = rt[yb].x, S = rt[last].x + rt[last].y - q0;
    if (S > p.smax) __trap();
    uint8_t* sv = smem + p.off_src + (j & 1) * p.smax * p.pitch;
    for (Walk it(tid, nt, p.pitch / 16); it.r < S; it.next()) {
      const uintptr_t g =
          reinterpret_cast<uintptr_t>(col0 + (q0 + it.r) * pitch_g);
      if (it.c * 16 < static_cast<int>(g & 15) + nb)
        cp_async16(sv + it.r * p.pitch + it.c * 16,
                   reinterpret_cast<const void*>((g & ~uintptr_t(15)) +
                                                 it.c * 16));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  stage(0);
  const int nq = (cols * 3 + 3) / 4;
  for (int j = 0; j < nband; ++j) {
    if (j + 1 < nband) {
      stage(j + 1);  // its buffer's last reader, band j - 1, is done
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    }
    __syncthreads();  // band j's rows are in; band j - 1's reads are done
    const int yb = j * p.rows, brows = min(p.rows, yrows - yb);
    const int q0 = rt[yb].x;
    const int S = rt[yb + brows - 1].x + rt[yb + brows - 1].y - q0;
    const uint8_t* sv = smem + p.off_src + (j & 1) * p.smax * p.pitch;
    // 3. The horizontal pass, once per (staged row, column), three
    // channels, each rounded to float as resize_rgb keeps it. A sum starts
    // at its first product (0.0 + p == p for p >= +0), so the first tap is
    // peeled off the loop.
    for (Walk it(tid, nt, cols); it.r < S; it.next()) {
      const int sh = static_cast<int>(
          reinterpret_cast<uintptr_t>(col0 + (q0 + it.r) * pitch_g) & 15);
      const int2 t = ct[it.c];
      const uint8_t* q = sv + it.r * p.pitch + sh + (t.x - c0) * 3;
      const double* wc = cw + it.c;
      double h0 = 0.0, h1 = 0.0, h2 = 0.0;
      if (t.y > 0) {
        h0 = __dmul_rn(wc[0], byte_to_double(q[0]));
        h1 = __dmul_rn(wc[0], byte_to_double(q[1]));
        h2 = __dmul_rn(wc[0], byte_to_double(q[2]));
      }
      for (int b = 1; b < t.y; ++b) {
        const double wb = wc[b * p.tile];
        h0 = __dadd_rn(h0, __dmul_rn(wb, byte_to_double(q[3 * b])));
        h1 = __dadd_rn(h1, __dmul_rn(wb, byte_to_double(q[3 * b + 1])));
        h2 = __dadd_rn(h2, __dmul_rn(wb, byte_to_double(q[3 * b + 2])));
      }
      float* hr = hp + it.r * p.hp_pitch + 3 * it.c;
      hr[0] = __double2float_rn(h0);
      hr[1] = __double2float_rn(h1);
      hr[2] = __double2float_rn(h2);
    }
    __syncthreads();
    // 4. The vertical pass, four output bytes a thread (a float4 of each
    // staged row: a warp reads 512 consecutive bytes, no bank conflict),
    // stored as one 32-bit word where aligned.
    for (Walk it(tid, nt, nq); it.r < brows; it.next()) {
      const int2 t = rt[yb + it.r];
      const float* col = hp + (t.x - q0) * p.hp_pitch + 4 * it.c;
      const double* wy = rw + (yb + it.r) * d.ky;
      double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
      if (t.y > 0) {
        const float4 f = *reinterpret_cast<const float4*>(col);
        a0 = __dmul_rn(wy[0], static_cast<double>(f.x));
        a1 = __dmul_rn(wy[0], static_cast<double>(f.y));
        a2 = __dmul_rn(wy[0], static_cast<double>(f.z));
        a3 = __dmul_rn(wy[0], static_cast<double>(f.w));
      }
      for (int a = 1; a < t.y; ++a) {
        const float4 f =
            *reinterpret_cast<const float4*>(col + a * p.hp_pitch);
        const double wa = wy[a];
        a0 = __dadd_rn(a0, __dmul_rn(wa, static_cast<double>(f.x)));
        a1 = __dadd_rn(a1, __dmul_rn(wa, static_cast<double>(f.y)));
        a2 = __dadd_rn(a2, __dmul_rn(wa, static_cast<double>(f.z)));
        a3 = __dadd_rn(a3, __dmul_rn(wa, static_cast<double>(f.w)));
      }
      const unsigned v = __byte_perm(
          __byte_perm(round_byte(a0), round_byte(a1), 0x0040),
          __byte_perm(round_byte(a2), round_byte(a3), 0x0040), 0x5410);
      uint8_t* o8 = dst + (yb + it.r) * rowb + 4 * it.c;
      const int valid = min(4, cols * 3 - 4 * it.c);
      if (valid == 4 && (reinterpret_cast<uintptr_t>(o8) & 3) == 0) {
        *reinterpret_cast<unsigned*>(o8) = v;
      } else {
        for (int e = 0; e < valid; ++e)
          o8[e] = static_cast<uint8_t>(v >> (8 * e));
      }
    }
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

// resize_crop_u8_staged over n frames (StagedFrame each, device), k crops
// a frame (origins as above), in groups of `group`, into out, under `plan`
// (host, kPlanLen ints: StagedPlan's fields, then the dynamic shared
// memory in bytes), on `stream`: a grid of runs x tiles blocks a crop,
// at most 65535 output crops a launch.
int rdl_resize_crop_staged(const void* src, const void* frames,
                           const void* origins, int n, int k, int group,
                           int crop, const int* plan, int plan_len,
                           void* out, void* stream) {
  if (n == 0 || k == 0 || crop == 0) return 0;
  if (plan_len != kPlanLen) return cudaErrorInvalidValue;
  if (static_cast<long long>(n) * k > 65535) return cudaErrorInvalidValue;
  StagedPlan p;
  static_assert(sizeof(StagedPlan) == (kPlanLen - 1) * sizeof(int),
                "StagedPlan is the plan's ints but the last");
  std::memcpy(&p, plan, sizeof(p));
  const int smem = plan[kPlanLen - 1];
  if (p.rows < 1 || p.tile < 1 || p.threads < 32 ||
      p.threads > kMaxThreads || p.threads % 32 || smem < 0 ||
      smem > kMaxSmem ||
      p.run < 1 || static_cast<long long>(p.bands) * p.rows < crop ||
      static_cast<long long>(p.runs) * p.run < p.bands ||
      static_cast<long long>(p.tiles) * p.tile < crop)
    return cudaErrorInvalidValue;
  // Once a device: allow the largest dynamic shared memory (a repeated set
  // from two threads is harmless).
  static bool attribute_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !attribute_set[dev]) {
    err = cudaFuncSetAttribute(resize_crop_u8_staged,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) attribute_set[dev] = true;
  }
  const dim3 grid(p.runs * p.tiles, n * k);
  resize_crop_u8_staged<<<grid, p.threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src),
      static_cast<const StagedFrame*>(frames),
      static_cast<const int*>(origins), k, group, crop, p,
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
