// The 3D shift redesigned for the H100, one device body in three modes: K1,
// the forward (counter shift3d); K1-inverse, the input gradient (counter
// shift3d_inverse); and K4, the raw (3, C) shift gradient (counter
// shift_grad). The file keeps the name it had when it held the backward
// alone.
//
// K1 replaces rubiksnet_tpu/ops/pallas/shift_kernel.py::rubiks_shift3d_pallas
// (forward, stride 1) and, at stride (1, 2, 2), ops/pallas/fused_shift3d.py::
// rubiks_shift_3d_fused. K1-inverse replaces rubiks_shift3d_pallas with
// inverse=True (stride 1) and the XLA inverse shift of the strided entries
// (rubiksnet_tpu/ops/shift3d.py::rubiks_shift_3d_input_grad); K4
// rubiksnet_tpu/ops/pallas/shift_grad_kernel.py::
// rubiks_shift3d_shift_grad_pallas (corrected taps :64-85) with the XLA
// shift gradient of the strided entries (ops/shift3d.py::
// rubiks_shift_3d_shift_grad).
//
// What the three compute. Forward: out[n, t', h', w', c] is the trilinear
// interpolation of x at o * stride - pad + s per axis (o the output
// position), zero outside x: taps floor(s) + {0, 1} with weights (1 - r, r);
// quantize reads the one tap floor(s) + (r >= 0.5) (a remainder below 0.5
// rounds down). Input gradient: gx[n, t, h, w, c] sums, over the 2x2x2
// corners of the negated shift, og at output position j / stride per axis,
// where j = i + pad + floor(-s) + {0, 1} is a non-negative multiple of the
// stride (weights 1 - r, r of the negated shift's remainder); quantize reads
// the one tap floor(-s) + (r >= 0.5), the quantized tap of the negated shift
// (at a remainder of exactly 0.5 not the forward's transpose: the
// reference's rule). Shift gradient: per output element the corners of x at
// o * stride - pad + {lo, hi} per axis, lo = floor(s) moved back one cell
// where the remainder is exactly 0, hi = floor(s) + 1, lerp weights (1 - r,
// r); with those corners q[a][b][c] (a, b, c: small/large along T, H, W)
//   dT = sum_{b,c} lH_b lW_c (q[1][b][c] - q[0][b][c])
//   dH = sum_{a,c} lT_a lW_c (q[a][1][c] - q[a][0][c])
//   dW = sum_{a,b} lT_a lH_b (q[a][b][1] - q[a][b][0])
// (tests/oracle.py:167-182), each times og, summed over (N, To, Ho, Wo) in
// f32. Quantize does not enter it (the reference's rule).
//
// One body. Per axis a destination position p reads raw coordinates
// q = p * mul + off + {lo_c, hi_c} and the source cell q / div where div
// divides q (forward: destination the output, source x, mul = stride, div
// 1, off = -pad, the shift as it is; input gradient: destination gx, source
// og, mul 1, div = stride, off = pad, the shift negated; shift gradient:
// destination the output positions, source x, mul = stride, div 1, off =
// -pad, the corrected taps). The forward and the input gradient write one
// value per destination element, the shift gradient accumulates three sums
// per thread.
//
// What bounds them on the card. The functions are bound by bytes (the
// forward reads x and writes out; the input gradient reads og and writes gx;
// the shift gradient reads og and x). The first forms, one thread per
// element, were bound by their instruction count: four 64-bit divisions
// per element to unflatten its index, the taps of all three axes
// recomputed per element, a division by the stride per tap, 2-byte loads.
// The design is shift2d.cu's, carried into 3D; what bounds it is latency,
// a block's chain of dependent steps (the tap range, the first rows'
// copies, then per row its barrier and a thread's run of columns, each
// column four dependent shared loads and their sums): a trace of the
// blocks (BWD3D_TRACE) puts 89-99% of a row's time in the thread's own
// instructions and little in the waits for copies.
//
//
// * Grid = (clip, destination frame, band of destination rows) x channel
//   group; the destination frame varies fastest, so the blocks that read a
//   source frame (two or three destination frames read each) run together
//   and share it in L2. A block takes one destination frame: walking the T
//   frames of its clip would need the band's rows of 3-4 frames resident
//   at once, which at 112x112x72 leaves room for 24 channels a block.
// * A thread owns one channel and a run of columns, a warp's lanes are
//   consecutive channels. Its taps are computed once per channel (T once
//   per block, H once per row), the columns walked with adds; no division
//   per element, 64-bit arithmetic only for the clip's base pointers.
// * The source rows of the 2-4 frames a destination frame reads are staged
//   in a shared-memory ring of F frames x D rows by 16-byte cp.async (4-byte
//   for C = 54 and 108, 2-byte for odd bf16 widths), as in shift2d.cu: while
//   row r is computed the rows of the next rows are in flight, one barrier
//   per row. A destination row combines up to four staged rows (T tap x H
//   tap) per source column, each load unconditional and a select dropping
//   the corners that read nothing: a branch per corner load, with its
//   reconvergence, made the first build several times slower.
// * The block works out its tap range from its channels' floors (the host
//   cannot know it without a synchronising read). Where the frames or rows
//   it needs exceed the ring (large integer shifts: shifts are unbounded in
//   training) it reads device memory directly with the same body.
// * Forward and input gradient, W axis: at stride 1 the value of a source
//   column is carried to the next destination column (one column of four
//   loads per element). The forward at a strided W reads each output
//   column's own two source columns (at stride 2 every source column once).
//   The input gradient at stride 2: of q and q + 1 exactly one is even, so
//   og is read once per axis without a branch (shift2d.cu's parity rule); a
//   general stride walks q mod stride with adds. T and H take the same rule
//   per row.
// * Shift gradient, W axis: per source column the three corner sums
//   (P for dT, Q for dH, L for dW) from the four staged rows, then per output
//   column P, Q and L at lo and hi (hi - lo is 1, or 2 at an integer
//   remainder): at stride 1 a window of three source columns slides along,
//   one new column per element. og is read once: staged in a ring of its
//   own beside the source rows where that leaves the channel group as wide,
//   else from device memory, coalesced, the first columns of a row two rows
//   ahead (a load per column left its latency in every column). Whole
//   batches of columns, past the run with og 0: no branch per column. Each
//   thread keeps its three f32 sums
//   in a fixed order; a block reduces its threads in a fixed order and
//   writes one partial per (unit, axis, channel); a second launch sums the
//   partials over the units in a fixed order (warps over contiguous ranges,
//   then the ranges in order). No float atomics: a rerun is bit-identical.
//   A first form summed the partials in the same launch (the last block of
//   a channel group, by an integer ticket); it forced groups of 32 channels
//   (one block read every partial of its group), and at 32 channels a
//   row's fixed cost (its barrier, copies and taps) came 9 times per row of
//   a 288-channel tensor (6.0-8.0 ms per Large step, slower than the first
//   form; a chip run of the probe on an H100).
//
// The (3, C) float32 shift is rounded to the compute dtype here
// (round-to-nearest-even, as Tensor.to), so a call of the forward or the
// input gradient is one device kernel and one of the shift gradient two.
#include <limits.h>

#include "common.cuh"
#include "staging.cuh"

// BWD3D_TRACE (a build of utils/shift3d_bwd_probe.py --trace alone; the
// port's build leaves it out) records when each block reaches the stages
// of its life.

namespace rubiks {
namespace bwd3d {

// The kernels' __launch_bounds__: at most kMaxThreads threads a block and
// kMinBlocks blocks an SM, which caps a thread at 80 registers. At 102-116
// registers an SM held fewer blocks (the probe on an H100: K1-inverse 2.48
// -> 1.97 ms, K4 7.50 -> 5.64 ms per Large step with these bounds); K4 at 1
// or 3 blocks an SM (117 registers, or 56 with 476 bytes of spill loads)
// ran slower again. ops/shift3d.py's BWD_MAX_THREADS plans within
// kMaxThreads (a CPU test holds the two equal); dispatch refuses a plan
// with more threads.
constexpr int kMaxThreads = 384;
constexpr int kMinBlocks = 2;
constexpr int kSmemHead = 32;  // the block's tap ranges
constexpr int kBatch = 4;      // columns whose loads start together

enum Mode { kInputGrad = 0, kShiftGrad = 1, kForward = 2 };

#ifdef BWD3D_TRACE
// Per block 8 slots: the global timer (ns) at block start (0), after the
// tap range (1), after the first row's barrier (2), after the last row (3),
// at the end (4); thread 0's SM cycles in the rows' waits and barriers (5)
// and in their compute (6); the SM (7).
__device__ unsigned long long* bwd3d_trace;
__device__ __forceinline__ unsigned long long* trace_slots() {
  if (threadIdx.x != 0 || bwd3d_trace == nullptr) return nullptr;
  return bwd3d_trace + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 8;
}
__device__ __forceinline__ void mark(int k) {
  unsigned long long* at = trace_slots();
  if (at == nullptr) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  at[k] = t;
  if (k == 0) {
    unsigned sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    at[7] = sm;
  }
}
// Thread 0's cycles in the rows' waits (slot 5) and compute (slot 6).
__device__ __forceinline__ long long cycles() {
  long long t = 0;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t));
#endif
  return t;
}
struct RowClock {
  long long last = 0, wait = 0, comp = 0;
  __device__ void start() { last = cycles(); }
  __device__ void waited() {
    const long long t = cycles();
    wait += t - last;
    last = t;
  }
  __device__ void computed() {
    const long long t = cycles();
    comp += t - last;
    last = t;
  }
  __device__ void store() {
    if (unsigned long long* at = trace_slots()) at[5] = wait, at[6] = comp;
  }
};
#else
__device__ __forceinline__ void mark(int) {}
struct RowClock {
  __device__ void start() {}
  __device__ void waited() {}
  __device__ void computed() {}
  __device__ void store() {}
};
#endif

struct Args {
  const void* src;      // staged: og (input gradient) or x (shift gradient)
  const void* og;       // shift gradient: og, one value per destination
  const float* shift;   // (3, C) float32, rows (T, H, W)
  void* dst;            // input gradient: gx
  float* partial;       // shift gradient: (units, 3, C)
  int N, Ts, Hs, Ws, Td, Hd, Wd, C;
  int mul_t, mul_h, mul_w, div_t, div_h, div_w, off_t, off_h, off_w;
  int quantize;
  int G, R, F, D, cols, bands, units;
  int O;  // shift gradient: og rows staged beside the ring (0: read og from
          // device memory)
  unsigned D_inv;  // 2^32 / D + 1: q mod D without a division
};

// One axis of a channel: destination position p reads raw coordinates
// p * mul + off + {lo, hi} with lerp weights (w0, w1).
struct AxisCh {
  int lo, hi;
  float w0, w1;
};

template <class T>
__device__ __forceinline__ AxisCh axis_channel(float s_raw, int mode,
                                               int quantize) {
  const float s = round_to<T>(s_raw);
  AxisCh a;
  if (mode != kShiftGrad) {
    // The forward's shift, or the input gradient's negated one; quantize:
    // the one tap its remainder rounds to.
    const float v = mode == kForward ? s : -s;
    const float f = clamped_floor(v);
    const float r = v - f;
    a.lo = (int)f + ((quantize && r >= 0.5f) ? 1 : 0);
    a.hi = a.lo + 1;
    a.w0 = quantize ? 1.f : 1.f - r;
    a.w1 = quantize ? 0.f : r;
  } else {
    // The corrected taps: the small one moves back a cell at remainder 0.
    const float f = clamped_floor(s);
    const float r = s - f;
    a.lo = (int)f - (r == 0.f ? 1 : 0);
    a.hi = (int)f + 1;
    a.w0 = 1.f - r;
    a.w1 = r;
  }
  return a;
}

// The source cells of one axis at destination position p, -1 where a tap
// reads nothing: outside the source, not a multiple of the stride, or (with
// drop_zero, the forward and the input gradient) of weight 0.
__device__ __forceinline__ AxisTaps cells(int p, int mul, int off, int div,
                                          const AxisCh& a, int d_src,
                                          bool drop_zero) {
  AxisTaps t;
  const int base = p * mul + off;
  t.idx[0] = base + a.lo;
  t.idx[1] = base + a.hi;
  t.w[0] = a.w0;
  t.w[1] = a.w1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    int j = t.idx[k];
    bool ok = j >= 0 && !(drop_zero && t.w[k] == 0.f);
    if (ok && div > 1) {
      ok = j % div == 0;
      j /= div;
    }
    t.idx[k] = (ok && j < d_src) ? j : -1;
  }
  return t;
}

// What a thread keeps of its channel: the three axes and its columns.
struct Lane {
  AxisCh t, h, w;
  int w_begin, w_end;
};

// The up to four source rows (T tap x H tap) of one destination row: a
// base pointer at the thread's channel and each row's element offset from
// it (32-bit offsets, not four pointers: fewer registers), with a flag each.
// A corner that reads nothing has offset 0, a valid address whose value a
// select drops: the loads take no branch (a branch per corner load, with
// its reconvergence, made the first form several times slower).
template <class T>
struct Corners {
  const T* base;
  int off[4];
  bool ok[4];

  // The four corners at source column i (pixel pitch pp, row of ws
  // pixels), 0 where a corner reads nothing or i lies outside the row.
  __device__ __forceinline__ void read(int i, int pp, int ws,
                                       float (&v)[4]) const {
    const bool inside = (unsigned)i < (unsigned)ws;
    const int o = inside ? i * pp : 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float x = to_f32(base[off[c] + o]);
      v[c] = ok[c] && inside ? x : 0.f;
    }
  }
};

// Destination row r of destination frame td: the source rows of its taps.
// STAGED: row q of frame j lies in ring slot ((j - f_lo) * D + q mod D);
// otherwise in the clip in device memory.
template <class T, bool STAGED>
__device__ __forceinline__ Corners<T> corners(const Args& p, const T* base,
                                              int row_pitch, int f_lo,
                                              const AxisTaps& tt,
                                              const AxisTaps& th) {
  Corners<T> k;
  k.base = base;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int j = tt.idx[a], q = th.idx[b];
      const bool ok = j >= 0 && q >= 0;
      const int jj = ok ? j : 0, qq = ok ? q : 0;
      k.ok[2 * a + b] = ok;
      k.off[2 * a + b] =
          !ok ? 0
          : STAGED ? ((jj - f_lo) * p.D + ring_slot(qq, p.D, p.D_inv)) *
                         row_pitch
                   : (jj * p.Hs + qq) * p.Ws * p.C;
    }
  return k;
}

// Forward and input gradient (MODE), destination row r of frame td: the
// thread's channel at column w goes to dst[w * C], straight to device
// memory.
template <class T, bool STAGED, int MODE>
__device__ __forceinline__ void lerp_row(const Args& p, const Lane& ln,
                                         const Corners<T>& k,
                                         const AxisTaps& tt,
                                         const AxisTaps& th, T* dst) {
  const int pp = STAGED ? p.G : p.C;
  const int opp = p.C;
  float wt[4];
  bool any = false;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wt[2 * a + b] = tt.w[a] * th.w[b];
      any |= k.ok[2 * a + b];
    }
  if (!any) {
    // No source row: zeros, without reading (a ring slot may hold anything).
    T* z = dst + ln.w_begin * opp;
    for (int w = ln.w_begin; w < ln.w_end; ++w, z += opp) *z = from_f32<T>(0.f);
    return;
  }
  // The corner sum at source column i, zero outside the row.
  auto col = [&](int i) {
    float x[4];
    k.read(i, pp, p.Ws, x);
    float v = wt[0] * x[0];
#pragma unroll
    for (int c = 1; c < 4; ++c) v = fmaf(wt[c], x[c], v);
    return v;
  };
  const float a0 = ln.w.w0, a1 = ln.w.w1;
  const int base = p.off_w + ln.w.lo;  // raw coordinate q = w * mul + base
  T* out = dst + ln.w_begin * opp;
  int w = ln.w_begin;
  const int w_end = ln.w_end;
  if (MODE == kForward && p.mul_w > 1) {
    // The forward at a strided W: each column reads its own cells q and
    // q + 1 (at stride 2 every source column once).
    const int step = p.mul_w;
    int i = w * step + base;
    for (; w + kBatch <= w_end;
         w += kBatch, i += kBatch * step, out += kBatch * opp) {
      float v[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c)
        v[c] = fmaf(a1, col(i + c * step + 1), a0 * col(i + c * step));
#pragma unroll
      for (int c = 0; c < kBatch; ++c) out[c * opp] = from_f32<T>(v[c]);
    }
    for (; w < w_end; ++w, i += step, out += opp)
      *out = from_f32<T>(fmaf(a1, col(i + 1), a0 * col(i)));
  } else if (MODE == kForward || p.div_w == 1) {
    // Cells q and q + 1: the second is the next column's first.
    int i = w + base;
    float prev = col(i);
    for (; w + kBatch <= w_end; w += kBatch, i += kBatch, out += kBatch * opp) {
      float b[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c) b[c] = col(i + c + 1);
#pragma unroll
      for (int c = 0; c < kBatch; ++c) {
        out[c * opp] = from_f32<T>(fmaf(a1, b[c], a0 * (c ? b[c - 1] : prev)));
      }
      prev = b[kBatch - 1];
    }
    for (; w < w_end; ++w, ++i, out += opp) {
      const float a = prev;
      prev = col(i + 1);
      *out = from_f32<T>(fmaf(a1, prev, a0 * a));
    }
  } else if (p.div_w == 2) {
    // Of q and q + 1 one is even: the one cell is (q + 1) >> 1, with
    // weight a0 for an even q and a1 for an odd one.
    auto one = [&](int q) { return ((q & 1) ? a1 : a0) * col((q + 1) >> 1); };
    int q = w + base;
    for (; w + kBatch <= w_end; w += kBatch, q += kBatch, out += kBatch * opp) {
      float v[kBatch];
#pragma unroll
      for (int c = 0; c < kBatch; ++c) v[c] = one(q + c);
#pragma unroll
      for (int c = 0; c < kBatch; ++c) out[c * opp] = from_f32<T>(v[c]);
    }
    for (; w < w_end; ++w, ++q, out += opp) *out = from_f32<T>(one(q));
  } else {
    // Any other stride: cell d = q / div where div divides q (weight a0),
    // or (q + 1) / div where it divides q + 1 (weight a1), never both;
    // m = q mod div walks with adds.
    const int q = w + base;
    int d = floor_div(q, p.div_w), m = q - d * p.div_w;
    for (; w < w_end; ++w, out += opp) {
      const bool first = m == 0, second = m == p.div_w - 1;
      const float wgt = first ? a0 : second ? a1 : 0.f;
      *out = from_f32<T>(wgt * col(d + (second ? 1 : 0)));
      if (++m == p.div_w) {
        m = 0;
        ++d;
      }
    }
  }
}

// Shift gradient, output row r of frame td: adds og times the three
// derivatives at each of the thread's columns to g.
// og at the first kBatch of the thread's columns of a row (zeros past its
// run), loaded before the row's barrier so that the wait covers them.
template <class T>
__device__ __forceinline__ void fetch_og(const T* u, int n, int C,
                                         float (&v)[kBatch]) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) v[k] = k < n ? to_f32(u[k * C]) : 0.f;
}

template <class T, bool STAGED>
__device__ __forceinline__ void shift_grad_row(const Args& p, const Lane& ln,
                                               const Corners<T>& k,
                                               const AxisTaps& tt,
                                               const AxisTaps& th,
                                               const T* og_row, int og_step,
                                               float (&cur)[kBatch],
                                               float3& g) {
  const int pp = STAGED ? p.G : p.C;
  // Per corner (T tap a, H tap b) its weight in P = sum_b lH_b (q[1][b] -
  // q[0][b]), Q = sum_a lT_a (q[a][1] - q[a][0]), L = sum lT_a lH_b q[a][b].
  float wp[4], wq[4], wl[4];
  bool any = false;
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      wp[2 * a + b] = a ? th.w[b] : -th.w[b];
      wq[2 * a + b] = b ? tt.w[a] : -tt.w[a];
      wl[2 * a + b] = tt.w[a] * th.w[b];
      any |= k.ok[2 * a + b];
    }
  if (!any) return;  // every corner outside x: nothing to add
  auto col3 = [&](int i) {
    float x[4];
    k.read(i, pp, p.Ws, x);
    float3 v = make_float3(wp[0] * x[0], wq[0] * x[0], wl[0] * x[0]);
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      v.x = fmaf(wp[c], x[c], v.x);
      v.y = fmaf(wq[c], x[c], v.y);
      v.z = fmaf(wl[c], x[c], v.z);
    }
    return v;
  };
  const float a0 = ln.w.w0, a1 = ln.w.w1;
  auto add = [&](float u, const float3& lo, const float3& hi) {
    g.x = fmaf(u, fmaf(a1, hi.x, a0 * lo.x), g.x);
    g.y = fmaf(u, fmaf(a1, hi.y, a0 * lo.y), g.y);
    g.z = fmaf(u, hi.z - lo.z, g.z);
  };
  const int d = ln.w.hi - ln.w.lo;  // 1, or 2 at an integer remainder
  // og in batches of kBatch columns (from device memory: the first batch
  // fetched two rows ahead), the next batch's loads in flight while the
  // current one is computed: a load per column would wait each time.
  const T* u = og_row + ln.w_begin * og_step;
  const int w_end = ln.w_end;
  auto fetch = [&](int w, float (&v)[kBatch]) {
    fetch_og(u + (w - ln.w_begin) * og_step, w_end - w, og_step, v);
  };
  float nxt[kBatch];
  int w = ln.w_begin;
  int i = w * p.mul_w + p.off_w + ln.w.lo;
  // Whole batches: past the run og is 0 (fetch_og), so the columns there
  // add nothing and no column takes a branch.
  if (p.mul_w == 1) {
    // A window of source columns i, i + 1, i + 2 slides along: one new
    // column per output element, in every lane whatever its d.
    float3 c0 = col3(i), c1 = col3(i + 1);
    for (; w < w_end; w += kBatch) {
      fetch(w + kBatch, nxt);
#pragma unroll
      for (int k = 0; k < kBatch; ++k, ++i) {
        const float3 c2 = col3(i + 2);
        add(cur[k], c0, d == 2 ? c2 : c1);
        c0 = c1;
        c1 = c2;
        cur[k] = nxt[k];
      }
    }
  } else {
    for (; w < w_end; w += kBatch) {
      fetch(w + kBatch, nxt);
#pragma unroll
      for (int k = 0; k < kBatch; ++k, i += p.mul_w) {
        add(cur[k], col3(i), col3(i + d));
        cur[k] = nxt[k];
      }
    }
  }
}

template <class T, int CB, int MODE>
__device__ __forceinline__ void body(const Args& p) {
  extern __shared__ __align__(16) char smem[];
  int* head = reinterpret_cast<int*>(smem);  // T lo, T hi, H lo, H hi; flag
  const int esz = (int)sizeof(T);
  const int row_pitch = ring_pitch(p.Ws * p.G * esz) / esz;
  T* ring = reinterpret_cast<T*>(smem + kSmemHead);

  const int c0 = blockIdx.y * p.G;
  const int gcount = min(p.G, p.C - c0);
  const int ty = threadIdx.x / p.G;
  const int cl = threadIdx.x - ty * p.G;
  const bool active = cl < gcount;
  const int seg = (p.Wd + p.cols - 1) / p.cols;

  mark(0);
  Lane ln;
  ln.t = ln.h = ln.w = AxisCh{0, 1, 1.f, 0.f};
  ln.w_begin = min(ty * seg, p.Wd);
  ln.w_end = active ? min(ln.w_begin + seg, p.Wd) : ln.w_begin;
  if (threadIdx.x == 0) {
    head[0] = head[2] = INT_MAX;
    head[1] = head[3] = INT_MIN;
  }
  __syncthreads();
  if (active) {
    const float* s = p.shift + c0 + cl;
    ln.t = axis_channel<T>(__ldg(s), MODE, p.quantize);
    ln.h = axis_channel<T>(__ldg(s + p.C), MODE, p.quantize);
    ln.w = axis_channel<T>(__ldg(s + 2 * p.C), MODE, p.quantize);
    if (ty == 0) {
      atomicMin(&head[0], ln.t.lo);
      atomicMax(&head[1], ln.t.hi);
      atomicMin(&head[2], ln.h.lo);
      atomicMax(&head[3], ln.h.hi);
    }
  }
  __syncthreads();
  mark(1);
  const int t_lo = head[0], t_hi = head[1], h_lo = head[2], h_hi = head[3];
  // Frames one destination frame reads, rows two consecutive rows read.
  const bool staged = p.D > 0 && (t_hi - t_lo) / p.div_t + 1 <= p.F &&
                      ring_need(h_hi - h_lo - 1, p.mul_h, p.div_h) <= p.D;
  const int ahead =
      staged ? min(ring_ahead(h_hi - h_lo - 1, p.mul_h, p.div_h, p.D),
                   kMaxAhead)
             : 1;
  const bool drop_zero = MODE != kShiftGrad;

  // The copy geometry of one source row.
  const bool whole = p.G == p.C;
  const int in_pixels = whole ? 1 : p.Ws;
  const int in_run = (whole ? p.Ws : 1) * gcount * esz;
  const int64_t src_clip = (int64_t)p.Ts * p.Hs * p.Ws * p.C;
  const int64_t dst_clip = (int64_t)p.Td * p.Hd * p.Wd * p.C;
  // The shift gradient's og rows in a ring of their own after the source
  // rows' (row r in slot r mod D): copied with the source rows that row r
  // needs, so that og is read from shared memory.
  const bool og_staged = MODE == kShiftGrad && staged && p.O > 0;
  const int og_pitch = ring_pitch(p.Wd * p.G * esz) / esz;
  T* og_ring = ring + p.F * p.D * row_pitch;
  const int og_pixels = whole ? 1 : p.Wd;
  const int og_run = (whole ? p.Wd : 1) * gcount * esz;

  float3 g = make_float3(0.f, 0.f, 0.f);
  {
    const int unit = blockIdx.x;  // one (clip, frame, band) a block
    const int td = unit % p.Td;
    const int rest = unit / p.Td;
    const int n = rest / p.bands;
    const int band = rest - n * p.bands;
    const int r_begin = band * p.R;
    const int r_end = min(r_begin + p.R, p.Hd);
    const T* src = static_cast<const T*>(p.src) + n * src_clip + c0;
    // Source frames [f_lo, f_hi] of destination frame td.
    const int qt = td * p.mul_t + p.off_t;
    const int f_lo = max(-floor_div(-(qt + t_lo), p.div_t), 0);
    const int f_hi = min(floor_div(qt + t_hi, p.div_t), p.Ts - 1);
    const AxisTaps tt =
        cells(td, p.mul_t, p.off_t, p.div_t, ln.t, p.Ts, drop_zero);

    // Source rows destination row r reads: [lo(r), hi(r)], monotone in r.
    auto lo = [&](int r) {
      return max(-floor_div(-(r * p.mul_h + p.off_h + h_lo), p.div_h), 0);
    };
    auto hi = [&](int r) {
      return min(floor_div(r * p.mul_h + p.off_h + h_hi, p.div_h), p.Hs - 1);
    };
    int next = 0;  // first source row not yet requested
    const T* og_src = static_cast<const T*>(p.og) + n * dst_clip +
                      (int64_t)td * p.Hd * p.Wd * p.C + c0;
    auto request = [&](int r) {
      if (!staged) return;
      if (og_staged)
        copy_row<CB>(reinterpret_cast<char*>(
                         og_ring + ring_slot(r, p.D, p.D_inv) * og_pitch),
                     reinterpret_cast<const char*>(og_src + r * p.Wd * p.C),
                     og_pixels, og_run, p.C * esz, p.G * esz);
      next = max(next, lo(r));
      for (const int last = hi(r); next <= last; ++next) {
        const int slot = ring_slot(next, p.D, p.D_inv);
        for (int f = f_lo; f <= f_hi; ++f)
          copy_row<CB>(
              reinterpret_cast<char*>(
                  ring + ((f - f_lo) * p.D + slot) * row_pitch),
              reinterpret_cast<const char*>(src +
                                            (f * p.Hs + next) * p.Ws * p.C),
              in_pixels, in_run, p.C * esz, p.G * esz);
      }
      cp_commit();
    };

    for (int k = 0; k < ahead; ++k) {
      if (r_begin + k < r_end) request(r_begin + k);
      else cp_commit();
    }
    RowClock clock;
    clock.start();
    // The shift gradient: og at the first kBatch columns of rows r, r + 1
    // and r + 2, loaded two rows ahead so that a row's compute and barrier
    // cover their latency.
    const T* og_unit = static_cast<const T*>(p.og) + n * dst_clip +
                       (int64_t)td * p.Hd * p.Wd * p.C + c0 + cl +
                       ln.w_begin * p.C;
    const int run = ln.w_end - ln.w_begin;
    auto og_first = [&](int r, float (&v)[kBatch]) {
      if (MODE == kShiftGrad && !og_staged)
        fetch_og(og_unit + r * p.Wd * p.C, r < r_end ? run : 0, p.C, v);
    };
    float first[kBatch], second[kBatch], third[kBatch];
    og_first(r_begin, first);
    og_first(r_begin + 1, second);
    for (int r = r_begin; r < r_end; ++r) {
      const int64_t at = n * dst_clip + ((td * p.Hd + r) * p.Wd) * p.C + c0 +
                         cl;
      og_first(r + 2, third);
      // Rows up to r + ahead - 1 are requested: those of r must have landed.
      // The barrier also says that every thread is done with row r - 1, so
      // the slots of the rows below lo(r) may be written again.
      clock.computed();
      cp_wait(ahead - 1);
      __syncthreads();
      clock.waited();
      if (r == r_begin) mark(2);
      if (r + ahead < r_end) request(r + ahead);
      else cp_commit();
      if (ln.w_begin >= ln.w_end) continue;  // idle lanes touch no source
      const AxisTaps th =
          cells(r, p.mul_h, p.off_h, p.div_h, ln.h, p.Hs, drop_zero);
      // One body, instantiated by where it reads, so that every load has a
      // known address space.
      if constexpr (MODE != kShiftGrad) {
        T* out = static_cast<T*>(p.dst) + at;
        if (staged)
          lerp_row<T, true, MODE>(
              p, ln, corners<T, true>(p, ring + cl, row_pitch, f_lo, tt, th),
              tt, th, out);
        else
          lerp_row<T, false, MODE>(
              p, ln, corners<T, false>(p, src + cl, 0, 0, tt, th), tt, th,
              out);
      } else {
        if (og_staged) {
          const T* og_row =
              og_ring + ring_slot(r, p.D, p.D_inv) * og_pitch + cl;
          fetch_og(og_row + ln.w_begin * p.G, run, p.G, first);
          shift_grad_row<T, true>(
              p, ln, corners<T, true>(p, ring + cl, row_pitch, f_lo, tt, th),
              tt, th, og_row, p.G, first, g);
        } else if (staged) {
          shift_grad_row<T, true>(
              p, ln, corners<T, true>(p, ring + cl, row_pitch, f_lo, tt, th),
              tt, th, static_cast<const T*>(p.og) + at, p.C, first, g);
        } else {
          shift_grad_row<T, false>(
              p, ln, corners<T, false>(p, src + cl, 0, 0, tt, th), tt, th,
              static_cast<const T*>(p.og) + at, p.C, first, g);
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          first[k] = second[k];
          second[k] = third[k];
        }
      }
    }
    clock.computed();
    clock.store();
  }
  mark(3);
  if constexpr (MODE == kShiftGrad) {
    // The block's partial: its threads summed per channel in column-run
    // order, one value per (unit, axis, channel), which the sum kernel adds.
    const int nt = blockDim.x;
    float* red = reinterpret_cast<float*>(
        smem + kSmemHead + (size_t)p.F * p.D * ring_pitch(p.Ws * p.G * esz) +
        (size_t)p.O * ring_pitch(p.Wd * p.G * esz));  // [3][nt]
    cp_wait(0);
    red[threadIdx.x] = g.x;
    red[nt + threadIdx.x] = g.y;
    red[2 * nt + threadIdx.x] = g.z;
    __syncthreads();
    const int outs = 3 * gcount;
    for (int o = threadIdx.x; o < outs; o += nt) {
      const int a = o / gcount, c = o - a * gcount;
      float acc = 0.f;
      for (int y = 0; y < p.cols; ++y) acc += red[a * nt + y * p.G + c];
      p.partial[((int64_t)blockIdx.x * 3 + a) * p.C + c0 + c] = acc;
    }
  }
  mark(4);
}

template <class T, int CB>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bwd3d_input_grad_kernel(const Args p) {
  body<T, CB, kInputGrad>(p);
}

template <class T, int CB>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bwd3d_shift_grad_kernel(const Args p) {
  body<T, CB, kShiftGrad>(p);
}

template <class T, int CB>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bwd3d_forward_kernel(const Args p) {
  body<T, CB, kForward>(p);
}

// out[i] = sum over units of partial[unit, i], i over 3 * C: a block takes
// kSumOuts outputs; each of its kSumParts warps sums one contiguous range of
// units in unit order, and the ranges are added in order. The order depends
// on the shape alone: a rerun is bit-identical.
constexpr int kSumOuts = 32, kSumParts = 16;

__global__ void __launch_bounds__(kSumOuts * kSumParts)
    bwd3d_shift_grad_sum_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int units,
                                int n3c) {
  __shared__ float red[kSumParts][kSumOuts];
  const int lane = threadIdx.x % kSumOuts, part = threadIdx.x / kSumOuts;
  const int o = blockIdx.x * kSumOuts + lane;
  float acc = 0.f;
  if (o < n3c) {
    const int end = (int)((int64_t)(part + 1) * units / kSumParts);
#pragma unroll 8
    for (int u = (int)((int64_t)part * units / kSumParts); u < end; ++u)
      acc += partial[(int64_t)u * n3c + o];
  }
  red[part][lane] = acc;
  __syncthreads();
  if (part == 0 && o < n3c) {
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < kSumParts; ++k) sum += red[k][lane];
    out[o] = sum;
  }
}

template <class T, int CB, int MODE>
int launch(const Args& p, dim3 grid, int smem_bytes, cudaStream_t stream) {
  auto kernel = MODE == kInputGrad   ? bwd3d_input_grad_kernel<T, CB>
                : MODE == kShiftGrad ? bwd3d_shift_grad_kernel<T, CB>
                                     : bwd3d_forward_kernel<T, CB>;
  // Raise the kernel's shared-memory limit once per device (a flag per
  // instantiation, so per kernel).
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[dev] = true;
  }
  kernel<<<grid, p.G * p.cols, smem_bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <class T, int CB>
int launch_mode(int mode, const Args& p, dim3 grid, int smem_bytes,
                cudaStream_t stream) {
  switch (mode) {
    case kInputGrad:
      return launch<T, CB, kInputGrad>(p, grid, smem_bytes, stream);
    case kShiftGrad:
      return launch<T, CB, kShiftGrad>(p, grid, smem_bytes, stream);
    default:
      return launch<T, CB, kForward>(p, grid, smem_bytes, stream);
  }
}

// Checks the plan and launches the kernel of `mode` (the shift gradient:
// then its sum over units into `out`).
int dispatch(Args p, int mode, int dtype, int copy_bytes, int smem_bytes,
             float* out, void* stream) {
  if (p.C == 0) return 0;
  const int esz = dtype == kBF16 ? 2 : 4;
  const int threads = p.G * p.cols;
  const int64_t ring = (int64_t)p.F * p.D * ring_pitch(p.Ws * p.G * esz) +
                       (int64_t)p.O * ring_pitch(p.Wd * p.G * esz);
  const int64_t need =
      kSmemHead + ring + (mode == kShiftGrad ? 12 * threads : 0);
  const int64_t bands = p.R > 0 ? (p.Hd + p.R - 1) / p.R : 0;
  const int64_t units = (int64_t)p.N * p.Td * bands;
  const int groups = (p.C + p.G - 1) / max(p.G, 1);
  if (mode < kInputGrad || mode > kForward || p.G < 1 || p.R < 1 ||
      p.F < 0 || p.D < 0 || p.D > 256 || p.cols < 1 ||
      !(p.O == 0 || (mode == kShiftGrad && p.O == p.D)) ||
      threads > kMaxThreads || smem_bytes != need || need > kMaxSmem ||
      copy_bytes % esz != 0 || (p.G * esz) % copy_bytes != 0 ||
      (p.C * esz) % copy_bytes != 0 || units > 2147483647LL ||
      groups > 65535 || p.div_t < 1 || p.div_h < 1 || p.div_w < 1 ||
      p.mul_t < 1 || p.mul_h < 1 || p.mul_w < 1 ||
      (int64_t)p.Ts * p.Hs * p.Ws * p.C > 2147483647LL ||
      (int64_t)p.Td * p.Hd * p.Wd * p.C > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  p.bands = (int)bands;
  p.units = (int)units;
  p.D_inv = p.D > 1 ? (unsigned)(0x100000000ULL / (unsigned)p.D + 1) : 0u;
  auto s = static_cast<cudaStream_t>(stream);
  if (units > 0) {
    const dim3 grid((unsigned)units, groups);
    const int bytes = (int)need;
    int rc = (int)cudaErrorInvalidValue;
    if (dtype == kBF16) {
      if (copy_bytes == 16)
        rc = launch_mode<__nv_bfloat16, 16>(mode, p, grid, bytes, s);
      else if (copy_bytes == 4)
        rc = launch_mode<__nv_bfloat16, 4>(mode, p, grid, bytes, s);
      else if (copy_bytes == 2)
        rc = launch_mode<__nv_bfloat16, 2>(mode, p, grid, bytes, s);
    } else if (dtype == kF32) {
      if (copy_bytes == 16) rc = launch_mode<float, 16>(mode, p, grid, bytes, s);
      else if (copy_bytes == 4)
        rc = launch_mode<float, 4>(mode, p, grid, bytes, s);
    }
    if (rc != 0) return rc;
  }
  if (mode != kShiftGrad) return 0;
  const int n3c = 3 * p.C;
  bwd3d_shift_grad_sum_kernel<<<(n3c + kSumOuts - 1) / kSumOuts,
                                kSumOuts * kSumParts, 0, s>>>(
      p.partial, out, p.units, n3c);
  return (int)cudaGetLastError();
}

}  // namespace bwd3d
}  // namespace rubiks

extern "C" {

// x (N, T, H, W, C) and out (N, To, Ho, Wo, C) contiguous, of dtype (0
// float32, 1 bfloat16); shift (3, C) float32 as the parameter holds it (the
// kernel rounds it to the dtype). quantize: 0 fractional, 1 the 3D rule. The
// arguments after it are the wrapper's plan (ops/shift3d.py::
// shift3d_bwd_plan), as for the input gradient below.
int rubiks_shift3d_fwd_staged(const void* x, const float* shift, void* out,
                              int dtype, int N, int T, int H, int W, int C,
                              int To, int Ho, int Wo, int st, int sh, int sw,
                              int pt, int ph, int pw, int quantize,
                              int copy_bytes, int G, int R, int F, int D,
                              int cols, int smem_bytes, void* stream) {
  rubiks::bwd3d::Args p = {};
  p.src = x;
  p.shift = shift;
  p.dst = out;
  p.N = N, p.Ts = T, p.Hs = H, p.Ws = W, p.Td = To, p.Hd = Ho, p.Wd = Wo;
  p.C = C;
  p.mul_t = st, p.mul_h = sh, p.mul_w = sw;
  p.div_t = p.div_h = p.div_w = 1;
  p.off_t = -pt, p.off_h = -ph, p.off_w = -pw;
  p.quantize = quantize;
  p.G = G, p.R = R, p.F = F, p.D = D, p.cols = cols;
  return rubiks::bwd3d::dispatch(p, rubiks::bwd3d::kForward, dtype,
                                 copy_bytes, smem_bytes, nullptr, stream);
}

// og (N, To, Ho, Wo, C) and gx (N, T, H, W, C) contiguous, of dtype (0
// float32, 1 bfloat16); shift (3, C) float32 as the parameter holds it (the
// kernel rounds it to the dtype and negates it). quantize: 0 fractional, 1
// the 3D rule. The arguments after it are the wrapper's plan
// (ops/shift3d.py::shift3d_bwd_plan): bytes per copy, channels per group,
// destination rows per band, ring frames, ring rows, column runs per block,
// dynamic shared memory.
int rubiks_shift3d_inv_staged(const void* og, const float* shift, void* gx,
                              int dtype, int N, int T, int H, int W, int C,
                              int To, int Ho, int Wo, int st, int sh, int sw,
                              int pt, int ph, int pw, int quantize,
                              int copy_bytes, int G, int R, int F, int D,
                              int cols, int smem_bytes, void* stream) {
  rubiks::bwd3d::Args p = {};
  p.src = og;
  p.shift = shift;
  p.dst = gx;
  p.N = N, p.Ts = To, p.Hs = Ho, p.Ws = Wo, p.Td = T, p.Hd = H, p.Wd = W;
  p.C = C;
  p.mul_t = p.mul_h = p.mul_w = 1;
  p.div_t = st, p.div_h = sh, p.div_w = sw;
  p.off_t = pt, p.off_h = ph, p.off_w = pw;
  p.quantize = quantize;
  p.G = G, p.R = R, p.F = F, p.D = D, p.cols = cols;
  return rubiks::bwd3d::dispatch(p, rubiks::bwd3d::kInputGrad, dtype,
                                 copy_bytes, smem_bytes, nullptr, stream);
}

// og (N, To, Ho, Wo, C) and x (N, T, H, W, C) contiguous, of dtype; shift
// (3, C) float32 as the parameter holds it. partial (units, 3, C) float32
// scratch, out (3, C) float32 result. The plan's arguments as for the input
// gradient, and O: og rows staged in a ring of their own (D of them, or 0:
// og read from device memory); two launches: the partials, then their sum
// in a fixed order.
int rubiks_shift_grad_staged(const void* og, const void* x,
                             const float* shift, float* partial, float* out,
                             int dtype, int N, int T, int H, int W, int C,
                             int To, int Ho, int Wo, int st, int sh, int sw,
                             int pt, int ph, int pw, int copy_bytes, int G,
                             int R, int F, int D, int cols, int O,
                             int smem_bytes, void* stream) {
  rubiks::bwd3d::Args p = {};
  p.src = x;
  p.og = og;
  p.shift = shift;
  p.partial = partial;
  p.N = N, p.Ts = T, p.Hs = H, p.Ws = W, p.Td = To, p.Hd = Ho, p.Wd = Wo;
  p.C = C;
  p.mul_t = st, p.mul_h = sh, p.mul_w = sw;
  p.div_t = p.div_h = p.div_w = 1;
  p.off_t = -pt, p.off_h = -ph, p.off_w = -pw;
  p.G = G, p.R = R, p.F = F, p.D = D, p.cols = cols, p.O = O;
  return rubiks::bwd3d::dispatch(p, rubiks::bwd3d::kShiftGrad, dtype,
                                 copy_bytes, smem_bytes, out, stream);
}

#ifdef BWD3D_TRACE
// Where the blocks of the next launches record their stages (8 unsigned
// 64-bit slots a block), or nullptr.
int rubiks_bwd3d_trace(void* buf) {
  return (int)cudaMemcpyToSymbol(rubiks::bwd3d::bwd3d_trace, &buf,
                                 sizeof(buf));
}
#endif

// The message of a code any entry point of the kernel library returned.
const char* rubiks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
