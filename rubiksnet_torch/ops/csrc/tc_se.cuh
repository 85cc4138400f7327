// The SE gate's per-frame sums in launch A's store, for the tensor-core
// launches of K2 (fused_block_tc.cu: kTcMidSe, kTcMidAqSe) and K3
// (fused_entry_tc.cu: kTcEntryMidSe). With these, the gate is one launch per
// SE block (se_gate_tc.cu) instead of a pass over mid and a gate launch
// (se_gate.cuh, which float32 keeps).
//
// The gate takes the spatial mean of shift(mid) per (frame, channel). The
// shift is linear with zero fill, so (se_gate.cuh says why)
//   sum_{ho,wo} shift(mid)[t] = sum_jt wT[jt] * S[t + jt - K],
//   S[t'] = sum_{h,w} mid[t', h, w] * aH[h] * aW[w],
// aH[h] the sum of the H taps that carry input row h onto some output row
// (at stride 2 only those of matching parity), aW likewise. Launch A holds
// every value of mid in registers before it stores it, so it forms S there:
// each value it stores is multiplied by its channel's aH[h] * aW[w] and
// summed per frame. The value summed is the one stored, rounded to bf16,
// which is what launch B reads and what the plain se_gate(shift(mid)) of
// ops/fused_block.py sums (mid is bf16 there too).
//
// The weights. aH[h] equals the axis's tap sum (per parity at stride 2)
// everywhere but within K + 1 of an edge, so a block keeps, per axis and
// channel of its column chunk, `lo` entries for the rows at the low edge,
// `hi` at the high edge and `stride` interior ones: the tables, built once
// in the prologue from the taps (tc_se_build_tables).
//
// The order, fixed by the shape alone, no atomics: within a warp, a thread
// sums its two rows of a (frame, column), then the eight row lanes are
// added by shuffles in a fixed order (tc_core.cuh::store_tile_se, for warps
// whose rows lie in one or two frames: a reduce-scatter, xor 16, 8, 4;
// tc_se_warp_sums, the general path: xor 4, 8, 16); across the tile's row
// warps through shared memory, in warp order (tc_se_store_partials). What
// it costs: a few instructions a stored value (the unpack, the weight, the
// multiply-add, a share of the shuffles) and one short ordered pass a
// tile, where the pass over mid it replaces read all of mid again (PERF.md
// has the numbers). Each (row tile, frame slot, column)
// gets one float32 partial, written once by the column's chunk. A tile of
// bm rows spans at most tc_se_slots(bm, H * W) frames; slot s of tile i is
// frame (i * bm) / (H * W) + s. se_gate_tc.cu sums a frame's tiles in tile
// order.
//
// Shared memory, from the kernel's t_off on (K2's launch A leaves its gather
// table unused: the SE region starts there): the two tables, (lo + hi +
// stride) x wn * 72 floats each, then the row warps' sums, wm x slots x wn *
// 72 floats (tc_se_bytes). The kernels' argument structs are those of the
// other launches, unchanged (a field more moved K2's launch A's spills):
// launch A has no gate to read, so its gate field carries the partials, and
// the rest follows from the shape and from the stride S, a template
// argument: 1 for K2, 2 for K3.
#pragma once

#include "common.cuh"
#include "fused_block_tc.cuh"

namespace rubiks {

// Frames a tile of bm rows can touch, frames of hw rows each.
__host__ __device__ inline int tc_se_slots(int bm, int hw) {
  return (bm + hw - 2) / hw + 1;
}

// The table sizes of a shift with taps_n taps, tap j at offset j - K:
// entries at the low and at the high edge of an axis.
__host__ __device__ inline void tc_se_borders(int taps_n, int K, int stride,
                                              int& lo, int& hi) {
  lo = taps_n - 1 - K > 0 ? taps_n - 1 - K : 0;
  hi = K + stride - 1;
}

// Bytes of the SE region: two tables and the row warps' sums.
__host__ __device__ inline int tc_se_bytes(int taps_n, int K, int stride,
                                           int wm, int wn, int slots) {
  int lo, hi;
  tc_se_borders(taps_n, K, stride, lo, hi);
  return (2 * (lo + hi + stride) + wm * slots) * wn * kTcWarpCols * 4;
}

// What the SE functions derive from the kernel's arguments p.
struct TcSeGeom {
  int lo, hi;   // table entries at the low and the high edge
  int entries;  // lo + hi + S: the interior, one entry per parity
  int slots;    // frame slots of a row tile
  int ncp;      // columns of a table row: the chunk's wn * 72
  float* base;  // the SE region in shared memory
};

template <int S, class P>
__device__ __forceinline__ TcSeGeom tc_se_geom(const P& p) {
  extern __shared__ __align__(16) unsigned char tc_se_base[];
  TcSeGeom g;
  tc_se_borders(p.taps_n, p.K, S, g.lo, g.hi);
  g.entries = g.lo + g.hi + S;
  g.slots = tc_se_slots(p.bm, p.H * p.W);
  g.ncp = p.wn * kTcWarpCols;
  g.base = reinterpret_cast<float*>(tc_se_base + p.t_off);
  return g;
}

// The table entry of coordinate i on an axis of extent d.
template <int S>
__device__ __forceinline__ int tc_se_entry(const TcSeGeom& g, int i, int d) {
  if (i < g.lo) return i;
  if (i >= d - g.hi) return g.lo + i - (d - g.hi);
  return g.lo + g.hi + (S == 2 ? (i & 1) : 0);
}

// The coordinate entry e stands for, or -1 if no coordinate of the axis
// maps there.
template <int S>
__device__ __forceinline__ int tc_se_coord(const TcSeGeom& g, int e, int d) {
  if (e < g.lo) return e < d ? e : -1;
  if (e < g.lo + g.hi) {
    const int i = d - g.hi + (e - g.lo);
    return i >= g.lo ? i : -1;
  }
  const int i = g.lo + ((e - g.lo - g.hi - g.lo) & (S - 1));
  return i < d - g.hi ? i : -1;
}

// Sum of the taps of one axis that carry input cell i onto an output cell:
// tap j reads input o * S + j - K at output o, so o = (i - j + K) / S must
// be an integer in [0, d_out) (se_gate.cuh's carried_taps).
template <int S>
__device__ __forceinline__ float tc_se_carried(const float* __restrict__ row,
                                               int C, int c, int taps_n,
                                               int K, int i, int d_out) {
  float a = 0.f;
  for (int j = 0; j < taps_n; ++j) {
    const int q = i - j + K;
    if (q >= 0 && q % S == 0 && q / S < d_out) a += __ldg(row + j * C + c);
  }
  return a;
}

// The prologue: the H and W tables of the chunk's columns [n0, n0 + wn * 72).
template <int S, class P>
__device__ __forceinline__ void tc_se_build_tables(const P& p, int n0) {
  const TcSeGeom g = tc_se_geom<S>(p);
  const int per_axis = g.entries * g.ncp;
  for (int idx = threadIdx.x; idx < 2 * per_axis; idx += blockDim.x) {
    const int axis = idx / per_axis;
    const int rem = idx - axis * per_axis;
    const int e = rem / g.ncp, c = n0 + rem - e * g.ncp;
    const int d = axis ? p.W : p.H;
    const int i = tc_se_coord<S>(g, e, d);
    g.base[idx] =
        (c < p.C && i >= 0)
            ? tc_se_carried<S>(p.taps() + (int64_t)(1 + axis) * p.taps_n * p.C,
                               p.C, c, p.taps_n, p.K, i, d / S)
            : 0.f;
  }
}

// The frames the rows of row warp wm_i of the tile at m0 touch (0: the warp
// has no rows): with one or two multiply_tile's store sums as it stores
// (store_tile_se).
template <class P>
__device__ __forceinline__ int tc_se_frames(const P& p, int64_t m0,
                                            int wm_i) {
  const int r_lo = (int)m0 + wm_i * 16;
  const int r_hi = min(r_lo + 15, (int)p.M - 1);
  const int hw = p.H * p.W;
  return r_lo < p.M ? r_hi / hw - r_lo / hw + 1 : 0;
}

// The general epilogue of a warp's 16 rows x 72 columns (multiply_tile's
// accumulators: rows g and g + 8, columns 8 nt + 2 t4 + e of the warp's
// first column col0 in the chunk): per frame the rows touch, the weighted
// sums of the stored values, reduced over the row lanes, into the warp's
// row of the shared sums: warps whose rows span three or more frames (frames
// of fewer than 16 rows), widths that are no multiple of 4.
template <int S, class P>
__device__ __forceinline__ void tc_se_warp_sums(
    const P& p, const float (&acc)[kTcWarpCols / 8][4], int64_t m0, int n0,
    int col0, int nt_valid, int wm_i, int lane) {
  const TcSeGeom geo = tc_se_geom<S>(p);
  const int ncp = geo.ncp;
  const float* tab_h = geo.base;
  const float* tab_w = tab_h + geo.entries * ncp;
  float* red = geo.base + (2 * geo.entries + wm_i * geo.slots) * ncp;
  const int hw = p.H * p.W;
  const int r_lo = (int)m0 + wm_i * 16;
  if (r_lo >= p.M) return;  // the warp has no rows (uniform)
  const int r_hi = min(r_lo + 15, (int)p.M - 1);
  const int f0 = (int)m0 / hw;
  const int g = lane >> 2, t4 = lane & 3;
  int frame[2], eh[2], ew[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = r_lo + g + 8 * half;
    frame[half] = m <= r_hi ? m / hw : -1;  // -1: past M
    const int q = m <= r_hi ? m / p.W : 0;
    eh[half] = tc_se_entry<S>(geo, q % p.H, p.H) * ncp;
    ew[half] = tc_se_entry<S>(geo, m <= r_hi ? m - q * p.W : 0, p.W) * ncp;
  }
  for (int f = r_lo / hw; f <= r_hi / hw; ++f) {
#pragma unroll
    for (int nt = 0; nt < kTcWarpCols / 8; ++nt) {
      if (nt < nt_valid) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + nt * 8 + 2 * t4 + e;
          const int n = n0 + col;
          float sum = 0.f;
          if (n < p.C) {
            const float sc = __ldg(p.s2() + n), bi = __ldg(p.b2() + n);
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              if (frame[half] == f) {
                const float v = round_to<__nv_bfloat16>(
                    fmaxf(fmaf(sc, acc[nt][2 * half + e], bi), 0.f));
                sum = fmaf(v, tab_h[eh[half] + col] * tab_w[ew[half] + col],
                           sum);
              }
            }
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 4);
          sum += __shfl_xor_sync(0xffffffffu, sum, 8);
          sum += __shfl_xor_sync(0xffffffffu, sum, 16);
          if (g == 0 && n < p.C) red[(f - f0) * ncp + col] = sum;
        }
      }
    }
  }
}

// After every row warp's sums of the tile [m0, m0 + bm) are in shared
// memory: per (frame slot, column of the chunk) their sum in warp order, of
// the warps whose rows touch that frame, to the tile's partials (the
// launch's gate field). `nthreads` threads from `tid` share the work.
template <int S, class P>
__device__ __forceinline__ void tc_se_store_partials(const P& p, int64_t m0,
                                                     int n0, int tid,
                                                     int nthreads) {
  const TcSeGeom geo = tc_se_geom<S>(p);
  const int ncp = geo.ncp;
  const float* red = geo.base + 2 * geo.entries * ncp;
  const int hw = p.H * p.W;
  const int ncols = min(ncp, p.C - n0);
  const int first = (int)m0, f0 = first / hw;
  const int rows = (int)min((int64_t)p.bm, p.M - m0);  // rows of the tile
  const int nslots = (first + rows - 1) / hw - f0 + 1;
  float* out = const_cast<float*>(p.gate) +
               (m0 / p.bm) * geo.slots * p.C + n0;
  for (int i = tid; i < nslots * ncols; i += nthreads) {
    const int slot = i / ncols, col = i - slot * ncols;
    // The tile's rows [a, b] of frame f0 + slot: the row warps a / 16 ..
    // b / 16 touch it, and wrote their sums.
    const int a = max((f0 + slot) * hw - first, 0);
    const int b = min((f0 + slot + 1) * hw - first, rows) - 1;
    float sum = 0.f;
    for (int w = a >> 4; w <= b >> 4; ++w)
      sum += red[(w * geo.slots + slot) * ncp + col];
    out[slot * p.C + col] = sum;
  }
}

}  // namespace rubiks
