// The serving stem, a kernel of its own for the H100 (counter stem_conv):
// the bias-free 3x3 stride-2 pad-1 convolution of (frames, H, W, 3) to
// (frames, Ho, Wo, C), Ho = ceil(H / 2), Wo = ceil(W / 2), in the input's
// dtype, sums in f32 and one rounding.
//
// It replaces no TPU kernel: the JAX package's stem is XLA's nn.Conv
// (rubiksnet_tpu/nn/backbone.py:222). The fused executor ran it as cuDNN's
// implicit GEMM (cutlass ... s16816fprop), which first pads the 3 channels
// to 8 in a pass of its own (nhwcAddPaddingKernel, a 411 MB copy written and
// read again at batch 64), after a cast of the float32 weight on every call:
// 2.2 ms a call at batch 64, 8 frames of 224 x 224, against a bound of 0.32.
//
// What bounds it on the card: bytes. At 224 px and C = 72 an output pixel is
// 144 bytes written against 12 read (925 MB and 154 MB at batch 64), and its
// 27 x 72 multiply-adds on the tensor cores take a tenth of the time the
// write stream needs at 3.35 TB/s. So the design keeps the write stream
// full, reads each input byte about once and makes no other pass:
//
// * A block walks bands of R output rows of one frame (a persistent grid, as
//   many blocks as fit the SMs; the rows of a band are ops/stem.py's rule).
//   A band reads 2R + 1 input lines, each one contiguous run of W x 3 values,
//   staged in shared memory by 16-byte cp.async where the lines allow it
//   (4-byte cp.async, or 2-byte plain loads, where W x 3 x the item size or
//   the input's address is not a multiple of 16: odd sizes, Tiny's tests),
//   into one of two stages: the next band's lines land while this one is
//   computed. A staged line has a zero pixel on either side and a line
//   outside the frame is zero, so the gather has no predicate.
// * The products are an implicit GEMM on the tensor cores: a pixel is a row
//   whose 27 taps, in (kh, kw, c) order, are 9 contiguous values in each of
//   three staged lines. A lane's 16 A values of a 16-pixel tile are 2-byte
//   shared loads at offsets fixed per lane; K is padded to 32 by zero weight
//   rows and zeroed A halves: two mma.sync m16n8k16 per 16 x 8 tile.
// * The weight, (32, C) bf16 packed once by the executor (rows (kh, kw, c),
//   zero past 27), stays in shared memory; a column tile's fragments come by
//   one ldmatrix.trans. A warp's 16 x C tile is made one 8-column tile at a
//   time (4 accumulators), rounded once to bf16 into the warp's own slice of
//   shared memory, which the warp then stores as 16-byte pieces: 16
//   consecutive pixels are 32 x C contiguous bytes of the output.
// * float32 (the executor's checks in f32): the same function as exact SIMT
//   FMAs, one output value a thread, taps in (kh, kw, c) order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "staging.cuh"
#include "tc_core.cuh"

namespace rubiks {
namespace {

constexpr int kStemK = 32;     // the 27 taps, padded to two k16 steps
constexpr int kStemTaps = 27;
constexpr int kStemLead = 8;   // values before a staged line's pixel 0
constexpr int kStemThreads = 128;
constexpr int kStemWarps = kStemThreads / 32;
constexpr int kStemStages = 2;
constexpr int kStemMaxC = 256;
constexpr int kStemF32Threads = 256;

struct StemArgs {
  const void* x;  // (frames, H, W, 3)
  const void* w;  // (32, C): rows (kh, kw, c), zero past 27
  void* y;        // (frames, Ho, Wo, C)
  int frames, H, W, C, Ho, Wo;
  int rows;   // output rows a band
  int bands;  // bands a frame
  int pitch;  // values from one staged line to the next
  int ws;     // values from one weight row to the next in shared memory
  int cpad;   // C rounded up to 8
};

// The shared-memory layout of a bf16 block, in values: the weight, the
// stages, then each warp's 16-pixel output slice.
__host__ __device__ inline int stem_weight_elems(const StemArgs& p) {
  return kStemK * p.ws;
}
__host__ __device__ inline int stem_stage_elems(const StemArgs& p) {
  return (2 * p.rows + 1) * p.pitch;
}
__host__ __device__ inline int stem_smem_bytes(const StemArgs& p) {
  const int out = (kStemWarps * 16 * p.C * 2 + 15) & ~15;
  return 2 * (stem_weight_elems(p) + kStemStages * stem_stage_elems(p)) + out;
}

template <int CB>
__device__ __forceinline__ void zero_piece(char* d) {
  if constexpr (CB == 16)
    *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (CB == 4)
    *reinterpret_cast<uint32_t*>(d) = 0u;
  else
    *reinterpret_cast<uint16_t*>(d) = 0;
}

// The input lines of band `item` into stage `s`: lines 2 oh0 - 1 ... of the
// band's frame, zero outside it, in CB-byte pieces; one commit group.
template <int CB>
__device__ __forceinline__ void stem_fill(const StemArgs& p, bf16* stage,
                                          int item) {
  const int f = item / p.bands, b = item - f * p.bands;
  const int oh0 = b * p.rows, nrows = min(p.rows, p.Ho - oh0);
  const int ih0 = 2 * oh0 - 1, used = 2 * nrows + 1;
  const int line_bytes = 3 * p.W * 2, per = line_bytes / CB;
  const char* src = static_cast<const char*>(p.x) +
                    (int64_t)f * p.H * line_bytes;
  for (int i = threadIdx.x; i < used * per; i += blockDim.x) {
    const int l = i / per, k = (i - l * per) * CB;
    const int ih = ih0 + l;
    char* d = reinterpret_cast<char*>(stage + l * p.pitch + kStemLead) + k;
    if (ih >= 0 && ih < p.H)
      copy_in<CB>(d, src + (int64_t)ih * line_bytes + k);
    else
      zero_piece<CB>(d);
  }
  cp_commit();
}

// The warp's `np` pixels of its slice (16 x C values) to `dst`, in the
// widest pieces both ends allow.
__device__ __forceinline__ void stem_store(char* dst, const char* src,
                                           int bytes, int lane) {
  const unsigned at = (unsigned)(uintptr_t)dst | (unsigned)bytes;
  if ((at & 15) == 0) {
    for (int i = lane * 16; i < bytes; i += 32 * 16)
      *reinterpret_cast<uint4*>(dst + i) =
          *reinterpret_cast<const uint4*>(src + i);
  } else if ((at & 3) == 0) {
    for (int i = lane * 4; i < bytes; i += 32 * 4)
      *reinterpret_cast<uint32_t*>(dst + i) =
          *reinterpret_cast<const uint32_t*>(src + i);
  } else {
    for (int i = lane * 2; i < bytes; i += 32 * 2)
      *reinterpret_cast<uint16_t*>(dst + i) =
          *reinterpret_cast<const uint16_t*>(src + i);
  }
}

template <int CB>
__global__ void __launch_bounds__(kStemThreads)
    rubiks_stem_kernel(const StemArgs p) {
  extern __shared__ __align__(16) unsigned char stem_smem[];
  bf16* Ws = reinterpret_cast<bf16*>(stem_smem);
  bf16* stages = Ws + stem_weight_elems(p);
  const int stage_elems = stem_stage_elems(p);
  bf16* outs = stages + kStemStages * stage_elems;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;

  // The weight, zero past C; both stages zeroed once: the copies write only
  // a line's pixels, so the pads stay zero.
  const bf16* w = static_cast<const bf16*>(p.w);
  for (int i = tid; i < kStemK * p.ws; i += blockDim.x) {
    const int k = i / p.ws, n = i - k * p.ws;
    Ws[i] = n < p.C ? w[k * p.C + n] : __float2bfloat16(0.f);
  }
  for (int i = tid; i < kStemStages * stage_elems / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(stages)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // This lane's taps k = 2t + 8j + e (j < 4, e < 2) as offsets from a
  // pixel's first tap; past 27 they read tap 0 under a zero mask.
  int off[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int k = 2 * t + 8 * j + e, kk = k < kStemTaps ? k : 0;
      off[2 * j + e] = (kk / 9) * p.pitch + kk % 9;
    }
  const uint32_t keep3 = (2 * t + 24 < kStemTaps ? 0x0000ffffu : 0u) |
                         (2 * t + 25 < kStemTaps ? 0xffff0000u : 0u);

  const int items = p.frames * p.bands;
  int item = blockIdx.x, s = 0;
  if (item < items) stem_fill<CB>(p, stages, item);
  bf16* slice = outs + warp * 16 * p.C;
  const int row_bytes = p.C * 2;
  for (; item < items; item += gridDim.x, s ^= 1) {
    const int next = item + gridDim.x;
    if (next < items) stem_fill<CB>(p, stages + (s ^ 1) * stage_elems, next);
    cp_wait(next < items ? 1 : 0);
    __syncthreads();

    const uint16_t* L = reinterpret_cast<const uint16_t*>(
        stages + s * stage_elems);
    const int f = item / p.bands, b = item - f * p.bands;
    const int oh0 = b * p.rows, nrows = min(p.rows, p.Ho - oh0);
    const int npix = nrows * p.Wo, tiles = (npix + 15) >> 4;
    char* yband = static_cast<char*>(p.y) +
                  ((int64_t)f * p.Ho + oh0) * p.Wo * row_bytes;
    for (int tile = warp; tile < tiles; tile += kStemWarps) {
      const int q0 = tile << 4;
      // Rows past the band are computed on its last pixel, not stored.
      int base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = min(q0 + g + 8 * h, npix - 1);
        const int r = q / p.Wo, ow = q - r * p.Wo;
        base[h] = 2 * r * p.pitch + kStemLead - 3 + 6 * ow;
      }
      uint32_t a[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v = (uint32_t)L[base[h] + off[2 * j]] |
                       ((uint32_t)L[base[h] + off[2 * j + 1]] << 16);
          if (j == 3) v &= keep3;
          a[j >> 1][(j & 1) * 2 + h] = v;
        }
      for (int nt = 0; nt < (p.cpad >> 3); ++nt) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, Ws + lane * p.ws + nt * 8);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(acc, a[0], bfr[0], bfr[1]);
        mma_bf16(acc, a[1], bfr[2], bfr[3]);
        const int col = nt * 8 + 2 * t;
        if (col >= p.C) continue;
        if ((p.C & 1) == 0) {
          *reinterpret_cast<uint32_t*>(slice + g * p.C + col) =
              pack2(acc[0], acc[1]);
          *reinterpret_cast<uint32_t*>(slice + (g + 8) * p.C + col) =
              pack2(acc[2], acc[3]);
        } else {
          slice[g * p.C + col] = __float2bfloat16(acc[0]);
          slice[(g + 8) * p.C + col] = __float2bfloat16(acc[2]);
          if (col + 1 < p.C) {
            slice[g * p.C + col + 1] = __float2bfloat16(acc[1]);
            slice[(g + 8) * p.C + col + 1] = __float2bfloat16(acc[3]);
          }
        }
      }
      __syncwarp();
      stem_store(yband + (int64_t)q0 * row_bytes,
                 reinterpret_cast<const char*>(slice),
                 min(16, npix - q0) * row_bytes, lane);
      __syncwarp();
    }
    __syncthreads();  // the stage is refilled next
  }
}

// float32: one output value a thread, exact FMAs over the taps in (kh, kw,
// c) order; no staging (the executor's f32 checks, not a served path).
__global__ void __launch_bounds__(kStemF32Threads)
    rubiks_stem_f32_kernel(const StemArgs p) {
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);
  float* y = static_cast<float*>(p.y);
  const int64_t total = (int64_t)p.frames * p.Ho * p.Wo * p.C;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int n = (int)(i % p.C);
    const int64_t pix = i / p.C;
    const int ow = (int)(pix % p.Wo);
    const int64_t fr = pix / p.Wo;
    const int oh = (int)(fr % p.Ho);
    const int64_t f = fr / p.Ho;
    float acc = 0.f;
    for (int kh = 0; kh < 3; ++kh) {
      const int ih = 2 * oh - 1 + kh;
      if (ih < 0 || ih >= p.H) continue;
      for (int kw = 0; kw < 3; ++kw) {
        const int iw = 2 * ow - 1 + kw;
        if (iw < 0 || iw >= p.W) continue;
        const float* px = x + ((f * p.H + ih) * p.W + iw) * 3;
        const float* wk = w + (kh * 9 + kw * 3) * p.C + n;
#pragma unroll
        for (int c = 0; c < 3; ++c) acc = fmaf(px[c], __ldg(wk + c * p.C), acc);
      }
    }
    y[i] = acc;
  }
}

int stem_sm_count() {
  static int sms[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && sms[dev]) return sms[dev];
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) sms[dev] = n;
  return n;
}

template <int CB>
int stem_launch(const StemArgs& p, int smem_bytes, cudaStream_t stream) {
  auto kernel = rubiks_stem_kernel<CB>;
  // Raise the kernel's shared-memory limit once per device, and ask once per
  // shared-memory size how many blocks an SM holds.
  static bool raised[64] = {};
  static int occ_smem[64] = {}, occ_blocks[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  int blocks = dev < 64 && occ_smem[dev] == smem_bytes ? occ_blocks[dev] : 0;
  if (blocks == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, kStemThreads, smem_bytes);
    if (err != cudaSuccess) return (int)err;
    blocks = max(blocks, 1);
    if (dev < 64) occ_smem[dev] = smem_bytes, occ_blocks[dev] = blocks;
  }
  const int items = p.frames * p.bands;
  const int grid = min(items, blocks * stem_sm_count());
  kernel<<<grid, kStemThreads, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace rubiks

extern "C" {

// x (frames, H, W, 3) and y (frames, ceil(H / 2), ceil(W / 2), C)
// contiguous, of dtype (0 float32, 1 bfloat16); w (32, C) contiguous, of the
// same dtype, rows (kh, kw, c) and zero past 27 (ops/stem.py::
// pack_stem_weight). bfloat16 takes the wrapper's plan (ops/stem.py::
// stem_plan): output rows a band, bytes per input copy, dynamic shared
// memory; float32 ignores it.
int rubiks_stem_conv(const void* x, const void* w, void* y, int dtype,
                     int frames, int H, int W, int C, int rows,
                     int copy_bytes, int smem_bytes, void* stream) {
  using namespace rubiks;
  if (frames == 0 || H == 0 || W == 0 || C == 0) return 0;
  StemArgs p = {x, w, y, frames, H, W, C, (H + 1) / 2, (W + 1) / 2,
                rows, 0, 0, 0, 0};
  auto s = static_cast<cudaStream_t>(stream);
  if ((int64_t)p.Ho * p.Wo * C > 2147483647LL / 2 ||
      (int64_t)H * W * 3 > 2147483647LL / 4 || C > kStemMaxC)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32) {
    const int64_t total = (int64_t)frames * p.Ho * p.Wo * C;
    const int64_t need = (total + kStemF32Threads - 1) / kStemF32Threads;
    const int64_t cap = 16LL * stem_sm_count();
    const int grid = (int)(need < cap ? need : cap);
    rubiks_stem_f32_kernel<<<grid, kStemF32Threads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (dtype != kBF16 || rows < 1) return (int)cudaErrorInvalidValue;
  p.bands = (p.Ho + rows - 1) / rows;
  p.pitch = (kStemLead + 3 * (W + 1) + 7) & ~7;
  p.cpad = (C + 7) & ~7;
  p.ws = (p.cpad / 8) % 2 ? p.cpad : p.cpad + 8;  // ldmatrix: odd 16-B rows
  const int need = stem_smem_bytes(p);
  if (smem_bytes != need || need > kMaxSmem ||
      (int64_t)frames * p.bands > 2147483647LL || (6 * W) % copy_bytes != 0)
    return (int)cudaErrorInvalidValue;
  if (copy_bytes == 16) return stem_launch<16>(p, need, s);
  if (copy_bytes == 4) return stem_launch<4>(p, need, s);
  if (copy_bytes == 2) return stem_launch<2>(p, need, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
