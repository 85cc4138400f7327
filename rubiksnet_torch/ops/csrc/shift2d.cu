// The fractional 2D shift forward and its input gradient, kernels of their
// own for the H100 (counters shift2d and shift2d_inverse).
//
// They replace rubiksnet_tpu/ops/pallas/shift_kernel.py::rubiks_shift3d_pallas
// as rubiksnet_tpu/ops/shift2d.py reaches it (one frame, a zero T row;
// forward :86-100, input gradient :129-146), and the XLA inverse shift of the
// strided 2D case. Forward: out[n, h', w', c] is the bilinear interpolation
// of x (N, H, W, C) at (h'*sH - pH + shiftH[c], w'*sW - pW + shiftW[c]), zero
// outside x; quantize reads the one cell at the coordinate rounded half away
// from zero. Input gradient: gx[n, h, w, c] sums, over the 2x2 corners of the
// negated shift, og at output position j / stride per axis, where j = i + pad
// + floor(-s) + {0, 1} is a non-negative multiple of the stride; quantize
// reads the quantized tap of the negated shift. At stride 1 the gradient is
// the forward with the shift negated, so both are one device body: per axis a
// destination position p reads raw coordinates q = p*mul + off + floor(s) +
// {0, 1} and the source cell q / div where div divides q (forward: mul =
// stride, div = 1, off = -pad; gradient: mul = 1, div = stride, off = pad, s
// negated).
//
// What bounds it on the card. The one-pass 3D kernel run on a one-frame
// view (shift3d.cu, this function's first form) was bound by its operation
// count: about 300 per 2-byte element (64-bit divisions to unflatten the
// index, the taps of both axes recomputed per element). The function itself
// is bound by bytes: 4 multiply-adds per element against 2 bytes read and 2
// written. The design, so that the operation count falls below what the
// memory rate allows:
//
// * Grid = (frame, band of destination rows) x channel group. n, rows,
//   columns and channels come from blockIdx, threadIdx and loop counters;
//   one 32-bit division per block and one per thread, none per element.
//   64-bit arithmetic only for the frame's base pointer.
// * A thread owns ONE channel of the group and a run of consecutive columns;
//   a warp's lanes are consecutive channels. The channel's floor, remainder
//   and weights are computed once per thread, the row taps once per thread
//   and row, and the columns are walked with adds. At stride 1 the vertical
//   lerp of a source column is carried from one column to the next, so an
//   element costs two shared-memory loads, not four. The column loop has no
//   branch and the same trip count in every lane (a cell outside the row is
//   read at column 0 and dropped by a select; the second row tap is a
//   predicated load): per-lane interior/border loops measured 1.6x slower,
//   because the lanes of a warp then disagree on every trip count. Columns
//   go in batches of four whose loads all start before the first store.
// * The source rows a band needs are staged in shared memory with coalesced
//   16-byte cp.async copies (a whole row of a group is one contiguous run
//   when the group is all of C, the usual case) into a ring of D rows: while
//   row r is computed, the rows of as many following rows as the ring has
//   room for are in flight, and one barrier per row orders both the landing
//   of row r and the reuse of the slots below it. Each row is read from
//   device memory once per band. Consecutive lanes read consecutive 2- or
//   4-byte cells of a staged row (channels differ in their offset by whole
//   pixels or rows only).
// * The destination is written straight from the registers, one element per
//   lane: a warp's 32 consecutive channels are 64 contiguous bytes (two full
//   sectors). Assembling the row in shared memory for 16-byte stores was
//   measured too: a second barrier per row and 2 x Wd x G more bytes of
//   shared memory per block, 3% slower over Large-AQ's shapes, so it went.
// * Gradient at stride 2: of the raw coordinates q and q + 1 exactly one is
//   even, so the one cell is (q + 1) >> 1 with weight 1 - r for an even q
//   and r for an odd one: og is read once per axis, without a branch
//   (general stride: at most one of the two, kept by a walker of q mod
//   stride). Forward at stride 2: every source row feeds some destination
//   row of a fractional shift (rows 2r + f and 2r + f + 1), so whole rows
//   are staged as at stride 1; only every second pair of columns is read
//   from them.
// * The halo is the range of floor(shift) over the block's channels, which
//   the host cannot know without a synchronising read: the block computes it.
//   Where the live rows exceed the ring (large integer parts) the block reads
//   the source directly from device memory with the same body: right, not
//   fast. Channel groups decide independently.
// * Widths that are not a multiple of the vector (C = 54, 108) use 4-byte
//   copies, odd bf16 widths 2-byte ones (the copy width is a template
//   argument the wrapper's plan selects).
//
// What is left (NVIDIA H100, bf16, 64 frames): at 112x112x72 and 56x56x72
// the kernel runs at 1.6-2x its byte bound, with cuDNN's depthwise
// convolution; from 28x28 down its time stops falling with the size (11-13
// us at 14x14x288 and 7x7x576 against bounds of 4 and 2 us): a block's chain
// of shift load, floor range, row copies, rows one after the other.
//
// Weights and sums are f32; the (2, C) float32 shift is rounded to the compute
// dtype here (round-to-nearest-even, as Tensor.to). Quantized taps are exact
// per element (float coordinate, sign test, division by the stride).
#include <limits.h>

#include "common.cuh"
#include "staging.cuh"

namespace rubiks {

constexpr int kMaxThreads = 512;
constexpr int kSmemHead = 16;     // the block's floor range lives here
constexpr int kBatch = 4;     // columns whose loads start together

struct Shift2dArgs {
  const void* src;
  const float* shift;  // (2, C), rows (H, W)
  void* dst;
  int N, Hs, Ws, Hd, Wd, C;
  int mul_h, mul_w, div_h, div_w, off_h, off_w;
  int inverse, quantize;
  int G, R, D, cols, bands;
  unsigned D_inv;  // 2^32 / D + 1: q mod D without a division
};

// The taps of one axis at destination position p: cells, or -1.
__device__ __forceinline__ AxisTaps axis_taps(int p, int mul, int off, int div,
                                              float s, int d_src,
                                              int quantize) {
  const float f = clamped_floor(s);
  const int base = p * mul + off;
  AxisTaps a;
  if (quantize) {
    const float v = (float)base + s;
    const float t = truncf(v < 0.f ? v - 0.5f : v + 0.5f);
    a.idx[0] = (int)fminf(fmaxf(t, -2.0e9f), 2.0e9f);
    a.w[0] = 1.f;
    a.idx[1] = -1;
    a.w[1] = 0.f;
  } else {
    const float r = s - f;
    a.idx[0] = base + (int)f;
    a.w[0] = 1.f - r;
    a.idx[1] = a.idx[0] + 1;
    a.w[1] = r;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int j = a.idx[k];
    bool ok = (k == 0 || !quantize) && j >= 0;
    if (ok && div > 1) {
      ok = j % div == 0;
      j /= div;
    }
    a.idx[k] = (ok && j < d_src) ? j : -1;
  }
  return a;
}

// What a thread keeps of its channel.
struct Channel {
  float s_h, s_w;  // shifts, rounded to T, negated for the gradient
  float a0, a1;    // column weights 1 - r, r
  int f_w;         // floor of s_w
};

// Destination row r of the block's channel group: the thread's channel at
// column w goes to dst[w * C], straight to device memory. STAGED: source
// rows come from the ring (row q in slot q mod D, pixel pitch G); otherwise
// from the frame in device memory (pixel pitch C).
template <class T, bool STAGED>
__device__ __forceinline__ void compute_row(const Shift2dArgs& p, int r,
                                            const T* src, int row_pitch,
                                            const Channel& ch, int w_begin,
                                            int w_end, T* dst) {
  if (w_begin >= w_end) return;  // an idle lane must not touch the source
  const int pp = STAGED ? p.G : p.C;
  const int opp = p.C;
  const AxisTaps th =
      axis_taps(r, p.mul_h, p.off_h, p.div_h, ch.s_h, p.Hs, p.quantize);
  auto row_ptr = [&](int q) {
    return STAGED ? src + ring_slot(q, p.D, p.D_inv) * row_pitch
                  : src + q * p.Ws * p.C;
  };
  // The valid row taps first: one unconditional load, one predicated (the
  // gradient at stride 2 has one row tap, as it has one column tap).
  const T* p0;
  const T* p1;
  float r0, r1 = 0.f;
  bool two = false;
  if (th.idx[0] >= 0) {
    p0 = p1 = row_ptr(th.idx[0]);
    r0 = th.w[0];
    if (th.idx[1] >= 0) {
      p1 = row_ptr(th.idx[1]);
      r1 = th.w[1];
      two = true;
    }
  } else if (th.idx[1] >= 0) {
    p0 = p1 = row_ptr(th.idx[1]);
    r0 = th.w[1];
  } else {
    // No source row: zeros, without reading (a ring slot may hold anything).
    T* z = dst + w_begin * opp;
    for (int w = w_begin; w < w_end; ++w, z += opp) *z = from_f32<T>(0.f);
    return;
  }
  // The vertical lerp at source column i, zero outside the row: column 0 is
  // read and dropped by a select, no branch.
  auto col = [&](int i) {
    const bool inside = (unsigned)i < (unsigned)p.Ws;
    const int o = inside ? i * pp : 0;
    float v = r0 * to_f32(p0[o]);
    if (two) v = fmaf(r1, to_f32(p1[o]), v);
    return inside ? v : 0.f;
  };
  if (p.quantize) {
    T* out = dst + w_begin * opp;
    for (int w = w_begin; w < w_end; ++w, out += opp) {
      const AxisTaps tw =
          axis_taps(w, p.mul_w, p.off_w, p.div_w, ch.s_w, p.Ws, 1);
      *out = from_f32<T>(tw.idx[0] >= 0 ? col(tw.idx[0]) : 0.f);
    }
    return;
  }
  // Columns go in batches: all of a batch's loads start before its
  // first store.
  const int base = p.off_w + ch.f_w;  // raw coordinate q = w * mul + base
  T* out = dst + w_begin * opp;
  int w = w_begin;
  if (p.div_w == 1) {
    // Cells q and q + 1; at a column step of 1 the second is the next
    // column's first.
    const bool carry_on = p.mul_w == 1;
    const int step = p.mul_w;
    int i = w_begin * step + base;
    float prev = carry_on ? col(i) : 0.f;
    for (; w + kBatch <= w_end;
         w += kBatch, i += kBatch * step, out += kBatch * opp) {
      float a[kBatch], b[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) b[k] = col(i + k * step + 1);
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        a[k] = carry_on ? (k ? b[k - 1] : prev) : col(i + k * step);
      prev = b[kBatch - 1];
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
        out[k * opp] = from_f32<T>(fmaf(ch.a1, b[k], ch.a0 * a[k]));
    }
    for (; w < w_end; ++w, i += step, out += opp) {
      const float a = carry_on ? prev : col(i);
      prev = col(i + 1);
      *out = from_f32<T>(fmaf(ch.a1, prev, ch.a0 * a));
    }
  } else if (p.div_w == 2) {
    // The gradient at stride 2: of q and q + 1 one is even, so the one
    // cell is (q + 1) >> 1, with weight a0 for an even q and a1 for odd.
    auto one = [&](int q) {
      return ((q & 1) ? ch.a1 : ch.a0) * col((q + 1) >> 1);
    };
    int q = w_begin + base;
    for (; w + kBatch <= w_end; w += kBatch, q += kBatch, out += kBatch * opp) {
      float v[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) v[k] = one(q + k);
#pragma unroll
      for (int k = 0; k < kBatch; ++k) out[k * opp] = from_f32<T>(v[k]);
    }
    for (; w < w_end; ++w, ++q, out += opp) *out = from_f32<T>(one(q));
  } else {
    // Any other stride of the gradient: cell d = q / div where div divides
    // q (weight a0), or (q + 1) / div where it divides q + 1 (weight a1),
    // never both; m = q mod div walks with adds.
    const int q = w_begin + base;
    int d = floor_div(q, p.div_w), m = q - d * p.div_w;
    for (; w < w_end; ++w, out += opp) {
      const bool first = m == 0, second = m == p.div_w - 1;
      const float wgt = first ? ch.a0 : second ? ch.a1 : 0.f;
      *out = from_f32<T>(wgt * col(d + (second ? 1 : 0)));
      if (++m == p.div_w) {
        m = 0;
        ++d;
      }
    }
  }
}

template <class T, int CB>
__global__ void __launch_bounds__(kMaxThreads)
    shift2d_kernel(const Shift2dArgs p) {
  extern __shared__ __align__(16) char smem[];
  int* range = reinterpret_cast<int*>(smem);  // [0] min, [1] max floor
  const int row_pitch =
      ring_pitch(p.Ws * p.G * (int)sizeof(T)) / (int)sizeof(T);
  T* ring = reinterpret_cast<T*>(smem + kSmemHead);

  const int n = blockIdx.x / p.bands;
  const int band = blockIdx.x - n * p.bands;
  const int r_begin = band * p.R;
  const int r_end = min(r_begin + p.R, p.Hd);
  const int c0 = blockIdx.y * p.G;
  const int gcount = min(p.G, p.C - c0);
  const int ty = threadIdx.x / p.G;
  const int cl = threadIdx.x - ty * p.G;
  const bool active = cl < gcount;
  const int seg = (p.Wd + p.cols - 1) / p.cols;
  const int w_begin = min(ty * seg, p.Wd);
  const int w_end = active ? min(w_begin + seg, p.Wd) : w_begin;

  const T* frame_src = static_cast<const T*>(p.src) +
                       (int64_t)n * p.Hs * p.Ws * p.C + c0;
  T* frame_dst =
      static_cast<T*>(p.dst) + (int64_t)n * p.Hd * p.Wd * p.C + c0;

  Channel ch = {0.f, 0.f, 1.f, 0.f, 0};
  if (threadIdx.x == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  __syncthreads();
  if (active) {
    const float sign = p.inverse ? -1.f : 1.f;
    ch.s_h = sign * round_to<T>(__ldg(p.shift + c0 + cl));
    ch.s_w = sign * round_to<T>(__ldg(p.shift + p.C + c0 + cl));
    const float fw = clamped_floor(ch.s_w);
    ch.f_w = (int)fw;
    ch.a1 = ch.s_w - fw;
    ch.a0 = 1.f - ch.a1;
    if (ty == 0) {
      const int fh = (int)clamped_floor(ch.s_h);
      atomicMin(&range[0], fh);
      atomicMax(&range[1], fh);
    }
  }
  __syncthreads();
  const int f_min = range[0], f_max = range[1];
  const bool staged =
      p.D > 0 && ring_need(f_max - f_min, p.mul_h, p.div_h) <= p.D;

  // The copy geometry of one source row.
  const bool whole = p.G == p.C;
  const int esz = (int)sizeof(T);
  const int in_pixels = whole ? 1 : p.Ws;
  const int in_run = (whole ? p.Ws : 1) * gcount * esz;

  // Source rows destination row r reads: [lo(r), hi(r)], monotone in r.
  auto lo = [&](int r) {
    const int q = r * p.mul_h + p.off_h + f_min;
    return max(-floor_div(-q, p.div_h), 0);
  };
  auto hi = [&](int r) {
    const int q = r * p.mul_h + p.off_h + f_max + 1;
    return min(floor_div(q, p.div_h), p.Hs - 1);
  };
  int next = 0;  // first source row not yet requested
  auto request = [&](int r) {
    if (!staged) return;  // nothing to wait for, no group needed
    next = max(next, lo(r));
    for (const int last = hi(r); next <= last; ++next)
      copy_row<CB>(
          reinterpret_cast<char*>(ring +
                                  ring_slot(next, p.D, p.D_inv) * row_pitch),
          reinterpret_cast<const char*>(frame_src) +
              (int64_t)next * p.Ws * p.C * esz,
          in_pixels, in_run, p.C * esz, p.G * esz);
    cp_commit();
  };

  const int ahead =
      staged ? min(ring_ahead(f_max - f_min, p.mul_h, p.div_h, p.D), kMaxAhead)
             : 1;
  for (int k = 0; k < ahead; ++k) {
    if (r_begin + k < r_end) request(r_begin + k);
    else cp_commit();
  }
  for (int r = r_begin; r < r_end; ++r) {
    // Rows up to r + ahead - 1 are requested: those of r must have landed.
    // The barrier also says that every thread is done with row r - 1, so
    // the slots of the rows below lo(r) may be written again.
    cp_wait(ahead - 1);
    __syncthreads();
    if (r + ahead < r_end) request(r + ahead);
    else cp_commit();
    T* out = frame_dst + r * p.Wd * p.C + cl;
    // One body, instantiated by where it reads, so that every load has a
    // known address space.
    if (staged)
      compute_row<T, true>(p, r, ring + cl, row_pitch, ch, w_begin, w_end,
                           out);
    else
      compute_row<T, false>(p, r, frame_src + cl, 0, ch, w_begin, w_end, out);
  }
}

template <class T, int CB>
int shift2d_launch(const Shift2dArgs& p, int smem_bytes, cudaStream_t stream) {
  auto kernel = shift2d_kernel<T, CB>;
  // Raise the kernel's shared-memory limit once per device.
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  const int groups = (p.C + p.G - 1) / p.G;
  kernel<<<dim3((unsigned)(p.N * p.bands), groups), p.G * p.cols, smem_bytes,
           stream>>>(p);
  return (int)cudaGetLastError();
}

int shift2d_dispatch(Shift2dArgs p, int dtype, int copy_bytes, int smem_bytes,
                     void* stream) {
  if (p.N == 0 || p.Hd == 0 || p.Wd == 0 || p.C == 0) return 0;
  const int esz = dtype == kBF16 ? 2 : 4;
  const int threads = p.G * p.cols;
  const int need = kSmemHead + p.D * ring_pitch(p.Ws * p.G * esz);
  if (p.G < 1 || p.R < 1 || p.D < 0 || p.D > 256 || p.cols < 1 ||
      threads > kMaxThreads || smem_bytes != need || need > kMaxSmem ||
      copy_bytes % esz != 0 ||
      (p.G * esz) % copy_bytes != 0 || (p.C * esz) % copy_bytes != 0 ||
      (p.N * (int64_t)((p.Hd + p.R - 1) / p.R)) > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  p.bands = (p.Hd + p.R - 1) / p.R;
  p.D_inv = p.D > 1 ? (unsigned)(0x100000000ULL / (unsigned)p.D + 1) : 0u;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (copy_bytes == 16) return shift2d_launch<__nv_bfloat16, 16>(p, need, s);
    if (copy_bytes == 4) return shift2d_launch<__nv_bfloat16, 4>(p, need, s);
    if (copy_bytes == 2) return shift2d_launch<__nv_bfloat16, 2>(p, need, s);
  } else if (dtype == kF32) {
    if (copy_bytes == 16) return shift2d_launch<float, 16>(p, need, s);
    if (copy_bytes == 4) return shift2d_launch<float, 4>(p, need, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace rubiks

extern "C" {

// x (N, H, W, C) and out (N, Ho, Wo, C) contiguous, of dtype (0 float32, 1
// bfloat16); shift (2, C) float32 as the parameter holds it. The six
// arguments before the stream are the wrapper's plan
// (ops/shift2d.py::shift2d_plan): bytes per copy, channels per group,
// destination rows per band, ring depth, column runs per block, dynamic
// shared memory.
int rubiks_shift2d_fwd(const void* x, const float* shift, void* out, int dtype,
                       int N, int H, int W, int C, int Ho, int Wo, int sh,
                       int sw, int ph, int pw, int quantize, int copy_bytes,
                       int G, int R, int D, int cols, int smem_bytes,
                       void* stream) {
  rubiks::Shift2dArgs p = {x,  shift, out, N,   H,   W, Ho,       Wo, C, sh,
                           sw, 1,     1,   -ph, -pw, 0, quantize, G,  R, D,
                           cols, 0, 0u};
  return rubiks::shift2d_dispatch(p, dtype, copy_bytes, smem_bytes, stream);
}

// og (N, Ho, Wo, C) and gx (N, H, W, C) contiguous, of dtype; shift as for
// the forward (not negated: the kernel negates).
int rubiks_shift2d_inv(const void* og, const float* shift, void* gx, int dtype,
                       int N, int H, int W, int C, int Ho, int Wo, int sh,
                       int sw, int ph, int pw, int quantize, int copy_bytes,
                       int G, int R, int D, int cols, int smem_bytes,
                       void* stream) {
  rubiks::Shift2dArgs p = {og, shift, gx, N,  Ho, Wo, H,        W, C, 1,
                           1,  sh,    sw, ph, pw, 1,  quantize, G, R, D,
                           cols, 0, 0u};
  return rubiks::shift2d_dispatch(p, dtype, copy_bytes, smem_bytes, stream);
}

}  // extern "C"
