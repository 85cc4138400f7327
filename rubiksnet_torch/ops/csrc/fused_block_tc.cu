// K2's two GEMM launches for bfloat16, designed for the H100: the fused
// stride-1 block of fused_block.cu,
//
//   A: mid = relu(s2 . ([AQ] relu(s1 . x + b1) @ W2) + b2)
//   B: out = x + ([gate .] shift3d(mid)) @ W3
//
// in its rubiks3d and rubiks3d-aq forms (and under the SE gate, whose own two
// launches sit between A and B unchanged). It replaces, for bf16, the
// common.cuh GEMM those launches ran on before, and with it
// rubiksnet_tpu/ops/pallas/fused_block.py::fused_block_run (aq_mix, the SE
// multiply) and ops/pallas/fused_frames.py::fused_frames_run. float32 stays on
// the common.cuh GEMM (SIMT f32 products, exact).
//
// What held the previous route back was not arithmetic or bytes but a serial
// chain: 2-byte loads, two barriers per 16-deep slab of A and of W, the weights
// re-read by each of 784 blocks through registers as f32, a gather of three
// nested loops with bounds in shared memory, 64-wide column tiles that pad 288
// to 320, SIMT products. What this design does about each:
//
// * Products on the tensor cores: mma.sync m16n8k16, bf16 operands, f32
//   accumulators, operands fetched by ldmatrix from shared-memory tiles whose
//   rows are padded by 16 or 32 bytes (no bank conflict). A warp owns 16 rows
//   x 72 columns (9 column tiles): the published widths 72 * 2^j divide
//   exactly, others (54, 108, ...) skip the tiles past the width. K is padded
//   to 16 with zeros in shared memory. (wgmma's swizzled operand layouts were
//   left for later: the loaders and the arrival of W bound the kernel, not
//   the products.)
// * Weights resident: a block copies its columns of W (all of them where they
//   fit beside the A tile, C <= 288; a chunk of wn * 72 columns otherwise,
//   grid.y chunks) into shared memory once, by 16-byte cp.async, and then
//   walks over row tiles (a persistent block): W is read once per block, not
//   once per row tile, and never through registers. The copy lands while the
//   first A tile is built, and it starts while the launch before this one
//   still runs (programmatic dependent launch, see the kernel). Column chunks
//   also give the small batches enough blocks; each chunk rebuilds the A tile.
// * Launch A's loader reads x 16 bytes a thread along C, with the channel
//   group's scale, bias and attention rows held in registers, several rows in
//   flight, and stores the operand tile 16 bytes at a time. With aq the clip
//   boundary comes from the row's (n, t), not from the flat index.
// * Launch B's gather: one channel per lane (a warp reads 64 contiguous bytes
//   per corner), the taps of a channel reduced once per block to a first
//   offset and two weights per axis in a shared-memory table. A lane walks 16
//   consecutive pixels and carries the interpolation along T and H from one
//   source column to the next, so a pixel costs four loads, not eight; bounds
//   and pointers are set once per image line, the loads of four columns start
//   together, predicates give the zero fill. The reads go to the L1/L2 caches
//   directly, at every width. At 288 and 576 the resident weights leave no
//   room to stage a halo of three frames per row tile in shared memory; at 72
//   and 144 they do (a band of image lines per channel slab, as shift2d.cu
//   stages its rows), and that variant has not been written or timed: it is
//   queued in ROADMAP.md. Taps with more than two non-zero weights per axis
//   take a general loop in the same kernel.
// * Stores: bn2/relu (A) or the residual add (B) on the accumulator fragment,
//   four consecutive columns per thread (8-byte stores, after one exchange of
//   two values between neighbouring threads). The residual is fetched before
//   the products. out may alias x: a thread reads
//   and writes the same elements, every read before the first write, and
//   launch B reads nothing else of x.
//
// What bounds it now (H100, batch 8; PERF.md has the numbers): a block of the
// grid has one or two row tiles at 14x14x288, so the phases of a tile (load,
// barrier, multiply, store) and the arrival of its 166 KB of W are exposed
// more than overlapped, and the gather is the longest of them: about 40
// instructions a value, which also sets the time at 56x56 and 112x112.
//
// No float atomics and no split of K: the result is bit-identical from run to
// run. The plan (rows per tile, warps, column chunks, grid, shared memory) is
// made in ops/fused_block.py::fused_block_plan and only checked here.
#include <cuda_bf16.h>

#include "common.cuh"
#include "fused_block_tc.cuh"

namespace rubiks {

using bf16 = __nv_bfloat16;

enum TcMode { kTcMid = 0, kTcMidAq = 1, kTcOut = 2 };

constexpr int kTcNT = kTcWarpCols / 8;  // column tiles of a warp
constexpr int kTcMaxThreads = 512;
constexpr int kTcWide = 1 << 24;  // table flag: more than two taps on an axis
constexpr int kTcBias = 64;       // tap offsets are stored + kTcBias, 8 bits

struct TcArgs {
  const bf16* x;      // A: the input. B: the residual
  const bf16* mid;    // B: the tensor the shift gathers
  bf16* dst;          // A: mid. B: out
  const bf16* w;      // (C, C) as (in, out)
  const float* vt;    // rows s1, b1, s2, b2, 3 * taps_n taps, [3 attention]
  const float* gate;  // B: nullptr or (N*T, C)
  int64_t M;
  int T, H, W, C, taps_n, K;
  int Kp;          // C rounded up to 16
  int a_rs, w_rs;  // row strides of the A tile and the W chunk, in elements
  int wn, bm, row_tiles;
  int pw;          // producer warps (0: every warp loads, then multiplies)
  int a_bytes;     // bytes of one A tile buffer (two of them when pw > 0)
  int w_off, t_off;  // byte offsets of the W chunk and the table
  int vec;           // 16-byte global accesses are aligned
};

__device__ __forceinline__ void tc_cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void tc_cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
// d += a (16 x 16, row) . b (16 x 8, col), bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(a, b);  // a in the low half
  return *reinterpret_cast<const unsigned*>(&t);
}
__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}
__device__ __forceinline__ void ldg8(const float* p, float (&f)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}
__device__ __forceinline__ float bf16_bits_to_f32(unsigned short u) {
  return __uint_as_float((unsigned)u << 16);
}

__device__ __forceinline__ void tc_cp16(void* smem, const void* gmem) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(gmem)
               : "memory");
}

// The block's columns [n0, n0 + wn * 72) of W into shared memory, rows past C
// zero (the A tile's padded columns meet them): 16-byte asynchronous copies
// where the width allows, element by element otherwise. (4-byte copies, tried
// for a column order that suits the store, took three times as long: 13 us of
// a 36 us launch at 14 x 14 x 288.)
__device__ __forceinline__ void load_w_chunk(const TcArgs& p, bf16* Ws,
                                             int n0) {
  const int cols = min(p.wn * kTcWarpCols, ((p.C + 7) & ~7) - n0);
  if (p.vec) {
    const int per_row = cols >> 3;
    for (int i = threadIdx.x; i < p.Kp * per_row; i += blockDim.x) {
      const int k = i / per_row, n = (i - k * per_row) << 3;
      bf16* dst = Ws + k * p.w_rs + n;
      if (k < p.C)
        tc_cp16(dst, p.w + (int64_t)k * p.C + n0 + n);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < p.Kp * cols; i += blockDim.x) {
      const int k = i / cols, n = i - k * cols;
      const bool in = k < p.C && n0 + n < p.C;
      Ws[k * p.w_rs + n] =
          in ? p.w[(int64_t)k * p.C + n0 + n] : __float2bfloat16(0.f);
    }
  }
  tc_cp_commit();
}

// ---------------------------------------------------------------- launch A

// relu(s . x + b) as a bf16 operand value.
__device__ __forceinline__ float act_bf16(float s, float x, float b) {
  return round_to<bf16>(fmaxf(fmaf(s, x, b), 0.f));
}

// The A tile of rows [m0, m0 + bm) from x, 16 bytes a thread: a thread keeps
// one group of 8 channels (its scale, bias and attention rows in registers)
// and walks down the rows, RB rows' loads in flight.
template <bool AQ>
__device__ __forceinline__ void build_act_tile_vec(const TcArgs& p, bf16* As,
                                                   int64_t m0, int tid,
                                                   int nthreads) {
  constexpr int RB = AQ ? 2 : 4;
  constexpr int NV = AQ ? 3 : 1;
  const int groups = p.Kp >> 3;
  const int tcs = min(groups, nthreads);
  const int trs = nthreads / tcs;
  const int tr = tid / tcs, tc = tid - tr * tcs;
  if (tr >= trs) return;
  const int HW = p.H * p.W;
  const int64_t frame = (int64_t)HW * p.C;
  const float* aw = p.vt + (int64_t)(4 + 3 * p.taps_n) * p.C;
  for (int g = tc; g < groups; g += tcs) {
    const int k = g << 3;
    const bool live = k < p.C;
    const int kk = live ? k : 0;
    float s[8], b[8], w0[8], w1[8], w2[8];
    ldg8(p.vt + kk, s);
    ldg8(p.vt + p.C + kk, b);
    if (AQ) {
      ldg8(aw + kk, w0);
      ldg8(aw + p.C + kk, w1);
      ldg8(aw + 2 * p.C + kk, w2);
    }
    for (int r0 = tr; r0 < p.bm; r0 += trs * RB) {
      uint4 v[RB][NV];
      bool prev[RB], next[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        int64_t m = m0 + r0 + j * trs;
        if (m >= p.M) m = p.M - 1;
        const uint4* px = reinterpret_cast<const uint4*>(p.x + m * p.C + kk);
        if (AQ) {
          const int t = (int)((m / HW) % p.T);
          prev[j] = t > 0;
          next[j] = t < p.T - 1;
          const uint4* pp = reinterpret_cast<const uint4*>(
              p.x + (prev[j] ? m * p.C - frame : m * p.C) + kk);
          const uint4* pn = reinterpret_cast<const uint4*>(
              p.x + (next[j] ? m * p.C + frame : m * p.C) + kk);
          v[j][0] = __ldg(pp);
          v[j][NV / 2] = __ldg(px);
          v[j][NV - 1] = __ldg(pn);
        } else {
          prev[j] = next[j] = false;
          v[j][0] = __ldg(px);
        }
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int r = r0 + j * trs;
        if (r >= p.bm) continue;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (live && m0 + r < p.M) {
          float f[8], c[8];
          unpack8(v[j][NV / 2], c);
          if (AQ) {
            float pv[8], nx[8];
            unpack8(v[j][0], pv);
            unpack8(v[j][NV - 1], nx);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              float acc = prev[j] ? w0[i] * act_bf16(s[i], pv[i], b[i]) : 0.f;
              acc = fmaf(w1[i], act_bf16(s[i], c[i], b[i]), acc);
              if (next[j]) acc = fmaf(w2[i], act_bf16(s[i], nx[i], b[i]), acc);
              f[i] = acc;
            }
          } else {
#pragma unroll
            for (int i = 0; i < 8; ++i)
              f[i] = fmaxf(fmaf(s[i], c[i], b[i]), 0.f);
          }
          o = pack8(f);
        }
        *reinterpret_cast<uint4*>(As + r * p.a_rs + k) = o;
      }
    }
  }
}

// The same tile element by element, for widths that are no multiple of 8 (the
// tiny tier's 54 and 108) or tensors that are not 16-byte aligned.
template <bool AQ>
__device__ __forceinline__ void build_act_tile_scalar(const TcArgs& p,
                                                      bf16* As, int64_t m0,
                                                      int tid, int nthreads) {
  const int HW = p.H * p.W;
  const float* aw = p.vt + (int64_t)(4 + 3 * p.taps_n) * p.C;
  for (int i = tid; i < p.bm * p.Kp; i += nthreads) {
    const int r = i / p.Kp, k = i - r * p.Kp;
    const int64_t m = m0 + r;
    float v = 0.f;
    if (m < p.M && k < p.C) {
      const float s = __ldg(p.vt + k), b = __ldg(p.vt + p.C + k);
      auto act = [&](int64_t mm) {
        return act_bf16(s, to_f32(p.x[mm * p.C + k]), b);
      };
      if (AQ) {
        const int t = (int)((m / HW) % p.T);
        if (t > 0) v = __ldg(aw + k) * act(m - HW);
        v = fmaf(__ldg(aw + p.C + k), act(m), v);
        if (t < p.T - 1) v = fmaf(__ldg(aw + 2 * p.C + k), act(m + HW), v);
      } else {
        v = act(m);
      }
    }
    As[r * p.a_rs + k] = __float2bfloat16(v);
  }
}

// ---------------------------------------------------------------- launch B

// The per-channel table of launch B, 8 words a channel in shared memory:
// [0] the first non-zero tap's offset per axis (T, H, W), each + kTcBias in 8
// bits, and kTcWide; [1] the element offset of that corner from the row's own
// (m, 0); [2..7] the weights of that tap and the next, per axis. A fractional
// shift has two adjacent non-zero taps per axis, a quantized or integer one
// has one; the identity T row of the aq form has one.
__device__ __forceinline__ void build_tap_table(const TcArgs& p, int* table) {
  const float* taps = p.vt + 4 * (int64_t)p.C;
  float* wts = reinterpret_cast<float*>(table + 2 * p.Kp);
  for (int c = threadIdx.x; c < p.Kp; c += blockDim.x) {
    int off[3] = {0, 0, 0};
    bool wide = false;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int lo = -1, hi = -1;
      if (c < p.C) {
        for (int j = 0; j < p.taps_n; ++j) {
          if (__ldg(taps + (int64_t)(a * p.taps_n + j) * p.C + c) != 0.f) {
            if (lo < 0) lo = j;
            hi = j;
          }
        }
      }
      float w0 = 0.f, w1 = 0.f;
      if (lo >= 0) {
        off[a] = lo - p.K;
        w0 = __ldg(taps + (int64_t)(a * p.taps_n + lo) * p.C + c);
        if (lo + 1 < p.taps_n)
          w1 = __ldg(taps + (int64_t)(a * p.taps_n + lo + 1) * p.C + c);
        wide |= hi > lo + 1;
      }
      wts[(2 * a) * p.Kp + c] = w0;
      wts[(2 * a + 1) * p.Kp + c] = w1;
    }
    table[c] = (off[0] + kTcBias) | ((off[1] + kTcBias) << 8) |
               ((off[2] + kTcBias) << 16) | (wide ? kTcWide : 0);
    table[p.Kp + c] = ((off[0] * p.H + off[1]) * p.W + off[2]) * p.C + c;
  }
}

// Where a row of the (N, T, H, W) grid lies.
struct TcRow {
  int t, h, w, frame;
};

__device__ __forceinline__ TcRow tc_row(const TcArgs& p, int m) {
  TcRow r;
  r.w = m % p.W;
  const int q = m / p.W;
  r.h = q % p.H;
  r.frame = q / p.H;
  r.t = r.frame % p.T;
  return r;
}

// The shifted value of channel c at row r as a sum over every non-zero tap,
// for a channel whose taps are not two adjacent ones: right, not fast.
__device__ __forceinline__ float gather_taps(const TcArgs& p, const TcRow& r,
                                             int c) {
  const float* taps = p.vt + 4 * (int64_t)p.C;
  float acc = 0.f;
  for (int jt = 0; jt < p.taps_n; ++jt) {
    const float a = __ldg(taps + (int64_t)jt * p.C + c);
    const int ti = r.t + jt - p.K;
    if (a == 0.f || ti < 0 || ti >= p.T) continue;
    for (int jh = 0; jh < p.taps_n; ++jh) {
      const float bw = __ldg(taps + (int64_t)(p.taps_n + jh) * p.C + c);
      const int hi = r.h + jh - p.K;
      if (bw == 0.f || hi < 0 || hi >= p.H) continue;
      const float ab = a * bw;
      const bf16* row =
          p.mid + ((int64_t)((r.frame - r.t + ti) * p.H + hi) * p.W) * p.C + c;
      for (int jw = 0; jw < p.taps_n; ++jw) {
        const float cw = __ldg(taps + (int64_t)(2 * p.taps_n + jw) * p.C + c);
        const int wi = r.w + jw - p.K;
        if (cw == 0.f || wi < 0 || wi >= p.W) continue;
        acc = fmaf(ab * cw, to_f32(row[(int64_t)wi * p.C]), acc);
      }
    }
  }
  return acc;
}

constexpr int kTcRun = 16;   // consecutive rows a warp walks for one slab
constexpr int kTcBatch = 4;  // columns whose loads start together

// One line of the walk: the four (frame, row) taps of a channel at the
// current (t, h), their weights, and which of them exist.
struct TcLine {
  const unsigned short* q;  // mid at (frame + ot, h + oh, 0, c)
  int off[2][2];            // element offsets of the taps (dt, dh)
  float ab[2][2];           // wT[dt] * wH[dh]
  bool ok[2][2];
  int W, C;
  // S(col): the temporal and vertical interpolation at source column col,
  // zero outside the line.
  __device__ __forceinline__ void load(int col,
                                       unsigned short (&u)[2][2]) const {
    const bool in = (unsigned)col < (unsigned)W;
    const unsigned short* at = q + col * C;
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
#pragma unroll
      for (int dh = 0; dh < 2; ++dh)
        u[dt][dh] = (in && ok[dt][dh]) ? __ldg(at + off[dt][dh])
                                       : (unsigned short)0;
  }
  __device__ __forceinline__ float sum(const unsigned short (&u)[2][2]) const {
    float s = 0.f;
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
#pragma unroll
      for (int dh = 0; dh < 2; ++dh)
        s = fmaf(ab[dt][dh], bf16_bits_to_f32(u[dt][dh]), s);
    return s;
  }
};

// The A tile of launch B. A unit of work is kTcRun consecutive rows of one
// 32-channel slab; a warp takes units in turn, a lane one channel. Consecutive
// rows are consecutive pixels of an image line, and the interpolation along W
// of pixel w + 1 starts where that of pixel w ended: the lane carries S(col),
// the interpolation along T and H at a source column, from one pixel to the
// next, so a pixel costs four loads, not eight, and its addresses are adds.
// The line's taps, bounds and pointers are set once per line, the columns go in
// batches of kTcBatch whose loads all start before the first multiply-add.
// (Issuing every load of a run at once, with the predicates following each
// pixel, measured slower: the gather is bound by its instructions, about 40
// a value, not by the latency of L2.)
__device__ __forceinline__ void build_shift_tile(const TcArgs& p, bf16* As,
                                                 int64_t m0, const int* table,
                                                 int tid, int nthreads) {
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* wts = reinterpret_cast<const float*>(table + 2 * p.Kp);
  const int slabs = (p.Kp + 31) >> 5;
  const int units = (p.bm / kTcRun) * slabs;
  for (int u = warp; u < units; u += nwarps) {
    const int run = u / slabs, c = ((u - run * slabs) << 5) + lane;
    if (c >= p.Kp) continue;
    bf16* dst = As + run * kTcRun * p.a_rs + c;
    const int64_t m_first = m0 + run * kTcRun;
    const int nrows =
        (int)max((int64_t)0, min((int64_t)kTcRun, p.M - m_first));
    int r = 0;
    if (c < p.C && nrows > 0) {
      TcRow at = tc_row(p, (int)m_first);
      const int pk = table[c];
      if (pk & kTcWide) {
        for (; r < nrows; ++r) {
          const TcRow here = tc_row(p, (int)m_first + r);
          float v = gather_taps(p, here, c);
          if (p.gate != nullptr)
            v *= __ldg(p.gate + (int64_t)here.frame * p.C + c);
          dst[r * p.a_rs] = __float2bfloat16(v);
        }
      } else {
        const int ot = (pk & 0xff) - kTcBias, oh = ((pk >> 8) & 0xff) - kTcBias;
        const int ow = ((pk >> 16) & 0xff) - kTcBias;
        float wa[3][2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          wa[a][0] = wts[(2 * a) * p.Kp + c];
          wa[a][1] = wts[(2 * a + 1) * p.Kp + c];
        }
        TcLine ln;
        ln.W = p.W, ln.C = p.C;
#pragma unroll
        for (int dt = 0; dt < 2; ++dt)
#pragma unroll
          for (int dh = 0; dh < 2; ++dh) {
            ln.ab[dt][dh] = wa[0][dt] * wa[1][dh];
            ln.off[dt][dh] = (dt * p.H + dh) * p.W * p.C;
          }
        while (r < nrows) {
          // A line: the pixels at.w .. at.w + seg - 1 of row (at.frame, at.h).
          const int seg = min(p.W - at.w, nrows - r);
          bool okt[2], okh[2];
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            okt[d] = wa[0][d] != 0.f &&
                     (unsigned)(at.t + ot + d) < (unsigned)p.T;
            okh[d] = wa[1][d] != 0.f &&
                     (unsigned)(at.h + oh + d) < (unsigned)p.H;
          }
#pragma unroll
          for (int dt = 0; dt < 2; ++dt)
#pragma unroll
            for (int dh = 0; dh < 2; ++dh) ln.ok[dt][dh] = okt[dt] && okh[dh];
          ln.q = reinterpret_cast<const unsigned short*>(
              p.mid + ((int64_t)(at.frame + ot) * p.H + (at.h + oh)) *
                          (int64_t)p.W * p.C + c);
          const float gate =
              p.gate != nullptr
                  ? __ldg(p.gate + (int64_t)at.frame * p.C + c) : 1.f;
          const float w0 = wa[2][0] * gate, w1 = wa[2][1] * gate;
          unsigned short u0[2][2];
          int col = at.w + ow;
          ln.load(col, u0);
          float prev = ln.sum(u0);
          ++col;
          int j = 0;
          for (; j + kTcBatch <= seg; j += kTcBatch, col += kTcBatch) {
            unsigned short ub[kTcBatch][2][2];
#pragma unroll
            for (int k = 0; k < kTcBatch; ++k) ln.load(col + k, ub[k]);
#pragma unroll
            for (int k = 0; k < kTcBatch; ++k) {
              const float sk = ln.sum(ub[k]);
              dst[(r + j + k) * p.a_rs] =
                  __float2bfloat16(fmaf(w1, sk, w0 * prev));
              prev = sk;
            }
          }
          for (; j < seg; ++j, ++col) {
            ln.load(col, u0);
            const float sk = ln.sum(u0);
            dst[(r + j) * p.a_rs] = __float2bfloat16(fmaf(w1, sk, w0 * prev));
            prev = sk;
          }
          r += seg;
          at.w += seg;
          if (at.w == p.W) {
            at.w = 0;
            if (++at.h == p.H) {
              at.h = 0;
              ++at.frame;
              if (++at.t == p.T) at.t = 0;
            }
          }
        }
      }
    }
    for (; r < kTcRun; ++r) dst[r * p.a_rs] = __float2bfloat16(0.f);
  }
}

// ------------------------------------------------------------- the kernel

// One A tile by the `nthreads` loading threads.
template <int MODE>
__device__ __forceinline__ void build_tile(const TcArgs& p, bf16* As,
                                           int64_t m0, const int* table,
                                           int tid, int nthreads) {
  if (MODE == kTcOut) {
    build_shift_tile(p, As, m0, table, tid, nthreads);
  } else if (p.vec) {
    build_act_tile_vec<MODE == kTcMidAq>(p, As, m0, tid, nthreads);
  } else {
    build_act_tile_scalar<MODE == kTcMidAq>(p, As, m0, tid, nthreads);
  }
}

// The store of four consecutive columns n .. n + 3 of row m (8-byte accesses;
// C is a multiple of 4 here): bn2 + relu into mid, or the residual add onto
// the four values of x in `res`.
template <int MODE>
__device__ __forceinline__ void store4(const TcArgs& p, int64_t m, int n,
                                       const float (&v)[4], uint2 res) {
  const int64_t i = m * p.C + n;
  float o[4];
  if (MODE != kTcOut) {
    const float4 sc =
        __ldg(reinterpret_cast<const float4*>(p.vt + 2 * p.C + n));
    const float4 bi =
        __ldg(reinterpret_cast<const float4*>(p.vt + 3 * p.C + n));
    o[0] = fmaxf(fmaf(sc.x, v[0], bi.x), 0.f);
    o[1] = fmaxf(fmaf(sc.y, v[1], bi.y), 0.f);
    o[2] = fmaxf(fmaf(sc.z, v[2], bi.z), 0.f);
    o[3] = fmaxf(fmaf(sc.w, v[3], bi.w), 0.f);
  } else {
    o[0] = __uint_as_float(res.x << 16) + v[0];
    o[1] = __uint_as_float(res.x & 0xffff0000u) + v[1];
    o[2] = __uint_as_float(res.y << 16) + v[2];
    o[3] = __uint_as_float(res.y & 0xffff0000u) + v[3];
  }
  *reinterpret_cast<uint2*>(p.dst + i) =
      make_uint2(pack2(o[0], o[1]), pack2(o[2], o[3]));
}

// The same for one column, any width.
template <int MODE>
__device__ __forceinline__ void store1(const TcArgs& p, int64_t m, int n,
                                       float v) {
  const int64_t i = m * p.C + n;
  if (MODE != kTcOut)
    v = fmaxf(fmaf(__ldg(p.vt + 2 * p.C + n), v, __ldg(p.vt + 3 * p.C + n)),
              0.f);
  else
    v += to_f32(p.x[i]);
  p.dst[i] = __float2bfloat16(v);
}

// The k loop of a warp's 16 rows x 72 columns: every fragment of a 16-deep
// step is fetched before the step's first product, and the products are plain
// (non-volatile) statements, so the compiler may run the next step's fetches
// under this step's products. FULL: all nine column tiles of the warp exist.
template <bool FULL>
__device__ __forceinline__ void multiply_steps(const TcArgs& p,
                                               const bf16* a_ptr,
                                               const bf16* b_ptr, int b_half,
                                               int nt_valid,
                                               float (&acc)[kTcNT][4]) {
#pragma unroll 1
  for (int k0 = 0; k0 < p.Kp; k0 += 16) {
    uint32_t a[4], b[kTcNT / 2][4], bl[2] = {0u, 0u};
    ldsm_x4(a, a_ptr + k0);
    const bf16* bk = b_ptr + k0 * p.w_rs;
#pragma unroll
    for (int np = 0; np < kTcNT / 2; ++np)
      if (FULL || 2 * np < nt_valid)
        ldsm_x4_trans(b[np], bk + np * 16 + b_half);
    if (FULL || kTcNT - 1 < nt_valid) ldsm_x2_trans(bl, bk + (kTcNT - 1) * 8);
    // A pair of tiles is stored together (below): both or none.
#pragma unroll
    for (int np = 0; np < kTcNT / 2; ++np) {
      if (FULL || 2 * np < nt_valid) {
        mma_bf16(acc[2 * np], a, b[np][0], b[np][1]);
        mma_bf16(acc[2 * np + 1], a, b[np][2], b[np][3]);
      }
    }
    if (FULL || kTcNT - 1 < nt_valid) mma_bf16(acc[kTcNT - 1], a, bl[0], bl[1]);
  }
}

// The products of one tile against the resident W chunk, and the store:
// warp (wm_i, wn_i) of the multiplying warps owns 16 rows x 72 columns.
// (Two 16-row tiles a warp, which halve the fetches of W per product, measured
// slower at every shape: the accumulators then leave room for 8 warps only.)
template <int MODE>
__device__ __forceinline__ void multiply_tile(const TcArgs& p, const bf16* As,
                                              const bf16* Ws, int64_t m0,
                                              int n0, int wm_i, int wn_i,
                                              int lane) {
  const int col0 = wn_i * kTcWarpCols;  // the warp's first column, in the chunk
  const int tiles_left = ((p.C + 7) >> 3) - ((n0 + col0) >> 3);
  const int nt_valid = max(0, min(kTcNT, tiles_left));
  if (nt_valid == 0) return;
  const int a_row0 = wm_i * 16;
  const int g = lane >> 2, t4 = lane & 3;
  // ldmatrix addresses of this lane: A rows (lane & 15), k halves by
  // (lane >> 4); W rows k0 + (lane & 15), column halves by (lane >> 4).
  const bf16* a_ptr =
      As + (a_row0 + (lane & 15)) * p.a_rs + ((lane >> 4) << 3);
  const bf16* b_ptr = Ws + (lane & 15) * p.w_rs + col0;
  const int b_half = (lane >> 4) << 3;

  float acc[kTcNT][4];
#pragma unroll
  for (int nt = 0; nt < kTcNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

  // Who stores what. The mma leaves thread t4 of a quad with columns 2 * t4,
  // 2 * t4 + 1 of each 8-wide tile. Of a pair of tiles the even threads take
  // the first and the odd threads the second, each with its neighbour's two
  // columns of that tile (one shuffle each way): four consecutive columns, one
  // 8-byte store, a full 32-byte sector per pair of threads. The ninth tile
  // is stored as it comes, two columns a thread.
  const bool quads = (p.C & 3) == 0;
  const int nbase = n0 + col0;
  const bool odd = t4 & 1;
  const int n4 = nbase + (odd ? 8 : 0) + 2 * (t4 & ~1);  // + 16 * pair
  const int n9 = nbase + 64 + 2 * t4;

  // Launch B: the residual, fetched before the products so that it arrives
  // under them. The thread that reads an element of x is the one that writes
  // it, and every read comes before the first write: out may alias x.
  uint2 res[2][kTcNT / 2];
  unsigned res9[2];
  if (MODE == kTcOut && quads) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + a_row0 + g + half * 8;
#pragma unroll
      for (int np = 0; np < kTcNT / 2; ++np) {
        const int n = n4 + 16 * np;
        res[half][np] =
            (m < p.M && 2 * np < nt_valid && n < p.C)
                ? *reinterpret_cast<const uint2*>(p.x + m * p.C + n)
                : make_uint2(0u, 0u);
      }
      res9[half] = (m < p.M && kTcNT - 1 < nt_valid && n9 < p.C)
                       ? *reinterpret_cast<const unsigned*>(p.x + m * p.C + n9)
                       : 0u;
    }
  }

  if (nt_valid == kTcNT)
    multiply_steps<true>(p, a_ptr, b_ptr, b_half, nt_valid, acc);
  else
    multiply_steps<false>(p, a_ptr, b_ptr, b_half, nt_valid, acc);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int64_t m = m0 + a_row0 + g + half * 8;
#pragma unroll
    for (int np = 0; np < kTcNT / 2; ++np) {
      // Every lane takes part in the exchange, whatever it stores.
      const float a0 = acc[2 * np][2 * half], a1 = acc[2 * np][2 * half + 1];
      const float b0 = acc[2 * np + 1][2 * half];
      const float b1 = acc[2 * np + 1][2 * half + 1];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      const int n = n4 + 16 * np;
      if (m >= p.M || 2 * np >= nt_valid || n >= p.C) continue;
      const float v[4] = {odd ? r0 : a0, odd ? r1 : a1, odd ? b0 : r0,
                          odd ? b1 : r1};
      if (quads) {
        store4<MODE>(p, m, n, v,
                     MODE == kTcOut ? res[half][np] : make_uint2(0u, 0u));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n + e < p.C) store1<MODE>(p, m, n + e, v[e]);
      }
    }
    if (m < p.M && kTcNT - 1 < nt_valid && n9 < p.C) {
      const float v0 = acc[kTcNT - 1][2 * half];
      const float v1 = acc[kTcNT - 1][2 * half + 1];
      if (MODE == kTcOut && quads) {  // n9 is even and n9 + 1 < C
        *reinterpret_cast<unsigned*>(p.dst + m * p.C + n9) =
            pack2(__uint_as_float(res9[half] << 16) + v0,
                  __uint_as_float(res9[half] & 0xffff0000u) + v1);
      } else {
        store1<MODE>(p, m, n9, v0);
        if (n9 + 1 < p.C) store1<MODE>(p, m, n9 + 1, v1);
      }
    }
  }
}

// grid (persistent blocks over the row tiles, column chunks), block pw + wm *
// wn warps. Shared memory: the A tile (bm x Kp; two of them when pw > 0), the
// W chunk (Kp x wn * 72) and the table. With pw > 0 the first pw warps only
// load: they build tile i + 1 in one buffer while the other warps multiply
// tile i from the other, one barrier per tile. With pw = 0 every warp builds
// the tile, then every warp multiplies it.
template <int MODE>
__global__ void __launch_bounds__(kTcMaxThreads, 1)
    rubiks_tc_kernel(const TcArgs p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  bf16* As = reinterpret_cast<bf16*>(tc_smem);
  bf16* Ws = reinterpret_cast<bf16*>(tc_smem + p.w_off);
  int* table = reinterpret_cast<int*>(tc_smem + p.t_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * p.wn * kTcWarpCols;  // the chunk's first column

  // The launches of a run depend on each other through x, mid and out, but
  // not through W and the taps: the next launch of the stream may begin as
  // SMs fall free and fetch those while this one still runs (programmatic
  // dependent launch), and every launch waits here, before it first touches
  // an activation, until the launch before it has finished and its writes are
  // visible. Without the launch attribute both instructions do nothing.
  asm volatile("griddepcontrol.launch_dependents;");
  load_w_chunk(p, Ws, n0);
  if (MODE == kTcOut) build_tap_table(p, table);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();

  if (p.pw == 0) {
    const int wm_i = warp / p.wn, wn_i = warp - wm_i * p.wn;
    for (int tile = blockIdx.x; tile < p.row_tiles; tile += gridDim.x) {
      const int64_t m0 = (int64_t)tile * p.bm;
      build_tile<MODE>(p, As, m0, table, tid, blockDim.x);
      tc_cp_wait_all();  // the W chunk, before the first tile's products
      __syncthreads();
      multiply_tile<MODE>(p, As, Ws, m0, n0, wm_i, wn_i, lane);
      __syncthreads();  // the A tile is free again
    }
  } else {
    const bool loads = warp < p.pw;
    const int cw = loads ? 0 : warp - p.pw;
    const int wm_i = cw / p.wn, wn_i = cw - wm_i * p.wn;
    const int nload = p.pw * 32;
    bf16* bufs[2] = {As, reinterpret_cast<bf16*>(tc_smem + p.a_bytes)};
    int tile = blockIdx.x;
    if (loads && tile < p.row_tiles)
      build_tile<MODE>(p, bufs[0], (int64_t)tile * p.bm, table, tid, nload);
    tc_cp_wait_all();
    __syncthreads();
    for (int it = 0; tile < p.row_tiles; tile += gridDim.x, ++it) {
      const int next = tile + gridDim.x;
      if (loads) {
        if (next < p.row_tiles)
          build_tile<MODE>(p, bufs[(it + 1) & 1], (int64_t)next * p.bm, table,
                           tid, nload);
      } else {
        multiply_tile<MODE>(p, bufs[it & 1], Ws, (int64_t)tile * p.bm, n0,
                                wm_i, wn_i, lane);
      }
      __syncthreads();
    }
  }
  tc_cp_wait_all();
}

// ---------------------------------------------------------------- the host

bool tc_plan_ok(const TcPlan& p, const TcShape& s) {
  if (p.wm < 1 || p.wn < 1 || p.pw < 0 ||
      (p.pw + p.wm * p.wn) * 32 > kTcMaxThreads)
    return false;
  if (p.n_split < 1 || p.n_split > 65535 || p.grid_x < 1) return false;
  if (s.N < 0 || s.T < 1 || s.H < 1 || s.W < 1 || s.C < 1) return false;
  const int64_t tiles_n = (s.C + 7) / 8;
  const int64_t chunk = (int64_t)p.wn * kTcNT;
  if (p.n_split * chunk < tiles_n || (p.n_split - 1) * chunk >= tiles_n)
    return false;  // the chunks cover the columns, and none is empty
  if (p.smem_bytes != tc_smem_bytes(p, s.C) || p.smem_bytes > kTcMaxSmem)
    return false;
  if (s.taps_n < 1 || s.taps_n > kMaxTaps || s.K < 0 || s.K >= kTcBias)
    return false;
  const int64_t frame = (int64_t)s.H * s.W * s.C;
  if (frame * (s.K + 3) >= (int64_t(1) << 31)) return false;  // int offsets
  if ((int64_t)s.N * s.T * s.H * s.W >= (int64_t(1) << 31)) return false;
  return true;
}

template <int MODE>
cudaError_t tc_launch_kernel(const TcPlan& pl, const TcArgs& a,
                             cudaStream_t stream) {
  auto kernel = rubiks_tc_kernel<MODE>;
  // Raise the kernel's shared-memory limit once per device.
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  const unsigned gx = (unsigned)(pl.grid_x < a.row_tiles ? pl.grid_x
                                                          : a.row_tiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, (unsigned)pl.n_split);
  cfg.blockDim = dim3((unsigned)(pl.pw + pl.wm * pl.wn) * 32);
  cfg.dynamicSmemBytes = (size_t)pl.smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute early = {};
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = pl.overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int MODE>
cudaError_t tc_launch(const TcPlan& pl, const TcShape& s, TcArgs a,
                      cudaStream_t stream) {
  if (!tc_plan_ok(pl, s)) return cudaErrorInvalidValue;
  a.M = (int64_t)s.N * s.T * s.H * s.W;
  if (a.M == 0) return cudaSuccess;
  a.T = s.T, a.H = s.H, a.W = s.W, a.C = s.C;
  a.taps_n = s.taps_n, a.K = s.K;
  a.Kp = (s.C + 15) & ~15;
  a.a_rs = tc_row_stride(a.Kp);
  a.w_rs = tc_row_stride(pl.wn * kTcWarpCols);
  a.wn = pl.wn;
  a.bm = pl.wm * 16;
  a.row_tiles = (int)((a.M + a.bm - 1) / a.bm);
  a.pw = pl.pw;
  a.a_bytes = a.bm * a.a_rs * 2;
  a.w_off = a.a_bytes * (pl.pw > 0 ? 2 : 1);
  a.t_off = a.w_off + a.Kp * a.w_rs * 2;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.mid) |
      reinterpret_cast<uintptr_t>(a.dst) | reinterpret_cast<uintptr_t>(a.w) |
      reinterpret_cast<uintptr_t>(a.vt);
  a.vec = (s.C % 8 == 0) && (bits & 15) == 0;
  return tc_launch_kernel<MODE>(pl, a, stream);
}

cudaError_t tc_launch_mid(const TcPlan& p, const TcShape& s, const void* x,
                          const float* vt, const void* w2, void* mid, int aq,
                          cudaStream_t stream) {
  TcArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.mid = nullptr;
  a.dst = static_cast<bf16*>(mid);
  a.w = static_cast<const bf16*>(w2);
  a.vt = vt;
  a.gate = nullptr;
  return aq ? tc_launch<kTcMidAq>(p, s, a, stream)
            : tc_launch<kTcMid>(p, s, a, stream);
}

cudaError_t tc_launch_out(const TcPlan& p, const TcShape& s, const void* x,
                          const void* mid, const float* vt, const void* w3,
                          const float* gate, void* out, cudaStream_t stream) {
  TcArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.mid = static_cast<const bf16*>(mid);
  a.dst = static_cast<bf16*>(out);
  a.w = static_cast<const bf16*>(w3);
  a.vt = vt;
  a.gate = gate;
  return tc_launch<kTcOut>(p, s, a, stream);
}

}  // namespace rubiks
