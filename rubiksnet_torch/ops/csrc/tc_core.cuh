// The device code that the tensor-core kernels of K2 (fused_block_tc.cu) and
// K3 (fused_entry_tc.cu) share: the mma.sync / ldmatrix / cp.async
// primitives, the resident-W loader, launch A's activation tile, the per-
// channel tap table and the general tap loop of the shift gather, the k loop
// of a warp's 16 x 72 tile with its stores. fused_block_tc.cu's header comment
// says what the design does and why. (The persistent walk over the row tiles
// is written out in each kernel: K2's launch A sits at the 128-register limit,
// and a shared walk moved its spills.)
//
// The functions take the kernel's argument struct as a template parameter P
// (fused_block_tc.cu::TcArgs, fused_entry_tc.cu::EntryArgs). What differs
// between the two is read through P's accessors:
//   kin()       width of the input x: its row stride, launch A's depth
//   s1(), b1()  folded bn1 scale and bias (kin() wide)
//   s2(), b2()  folded bn2 scale and bias (C wide)
//   taps()      (3 * taps_n, C) tap weights, rows T, H, W
//   tab()       channels of the tap table (its row stride in shared memory)
// and P's fields C (the output width: mid's and out's row stride), Kp (the
// depth of the A tile, padded to 16), M, bm, a_rs, w_rs, wn, x, mid, dst, w,
// gate, T, H, W, taps_n, K, vec, t_off (the SE forms of launch A, tc_se.cuh).
// Every accessor is an inline expression, so K2's kernels compile as they did
// before K3 came.
#pragma once

#include <cuda_bf16.h>

#include "common.cuh"
#include "fused_block_tc.cuh"
#include "tc_se.cuh"

namespace rubiks {

using bf16 = __nv_bfloat16;

// Launch modes. K2: A (mid), A with the attention mix, B (out = x + ...).
// K3: A (mid from x of another width), A with the attention mix, B (out,
// the shortcut a second K range of the same accumulator, no residual). The
// SE forms of the A launches also sum the gate's weighted values per frame
// (tc_se.cuh).
enum TcMode {
  kTcMid = 0,
  kTcMidAq = 1,
  kTcOut = 2,
  kTcEntryMid = 3,
  kTcEntryOut = 4,
  kTcMidSe = 5,
  kTcMidAqSe = 6,
  kTcEntryMidSe = 7,
  kTcEntryMidAq = 8
};

__host__ __device__ constexpr bool tc_se_mode(int mode) {
  return mode == kTcMidSe || mode == kTcMidAqSe || mode == kTcEntryMidSe;
}

constexpr int kTcNT = kTcWarpCols / 8;  // column tiles of a warp
constexpr int kTcMaxThreads = 512;
constexpr int kTcWide = 1 << 24;  // table flag: more than two taps on an axis
constexpr int kTcBias = 64;       // tap offsets are stored + kTcBias, 8 bits

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

// Rows [k0, k_end) of the block's resident W, its columns [n0, n0 + wn * 72):
// row k0 + i from row i of `w` (a (rows, C) matrix, (in, out)) for i < rows,
// zero past it (the A tile's padded columns meet those rows). 16-byte
// asynchronous copies where the width allows, element by element otherwise.
// (4-byte copies, tried for a column order that suits the store, took three
// times as long: 13 us of a 36 us launch at 14 x 14 x 288.)
template <class P>
__device__ __forceinline__ void load_w_rows(const P& p, bf16* Ws, int n0,
                                            const bf16* w, int k0, int rows,
                                            int k_end) {
  const int cols = min(p.wn * kTcWarpCols, ((p.C + 7) & ~7) - n0);
  if (p.vec) {
    const int per_row = cols >> 3;
    for (int i = threadIdx.x; i < (k_end - k0) * per_row; i += blockDim.x) {
      const int k = i / per_row, n = (i - k * per_row) << 3;
      bf16* dst = Ws + (k0 + k) * p.w_rs + n;
      if (k < rows)
        tc_cp16(dst, w + (int64_t)k * p.C + n0 + n);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < (k_end - k0) * cols; i += blockDim.x) {
      const int k = i / cols, n = i - k * cols;
      const bool in = k < rows && n0 + n < p.C;
      Ws[(k0 + k) * p.w_rs + n] =
          in ? w[(int64_t)k * p.C + n0 + n] : __float2bfloat16(0.f);
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
template <bool AQ, class P>
__device__ __forceinline__ void build_act_tile_vec(const P& p, bf16* As,
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
  const int64_t frame = (int64_t)HW * p.kin();
  for (int g = tc; g < groups; g += tcs) {
    const int k = g << 3;
    const bool live = k < p.kin();
    const int kk = live ? k : 0;
    float s[8], b[8], w0[8], w1[8], w2[8];
    ldg8(p.s1() + kk, s);
    ldg8(p.b1() + kk, b);
    if constexpr (AQ) {
      const float* aw = p.aqw();
      ldg8(aw + kk, w0);
      ldg8(aw + p.kin() + kk, w1);
      ldg8(aw + 2 * p.kin() + kk, w2);
    }
    for (int r0 = tr; r0 < p.bm; r0 += trs * RB) {
      uint4 v[RB][NV];
      bool prev[RB], next[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        int64_t m = m0 + r0 + j * trs;
        if (m >= p.M) m = p.M - 1;
        const uint4* px =
            reinterpret_cast<const uint4*>(p.x + m * p.kin() + kk);
        if (AQ) {
          const int t = (int)((m / HW) % p.T);
          prev[j] = t > 0;
          next[j] = t < p.T - 1;
          const uint4* pp = reinterpret_cast<const uint4*>(
              p.x + (prev[j] ? m * p.kin() - frame : m * p.kin()) + kk);
          const uint4* pn = reinterpret_cast<const uint4*>(
              p.x + (next[j] ? m * p.kin() + frame : m * p.kin()) + kk);
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
template <bool AQ, class P>
__device__ __forceinline__ void build_act_tile_scalar(const P& p, bf16* As,
                                                      int64_t m0, int tid,
                                                      int nthreads) {
  const int HW = p.H * p.W;
  for (int i = tid; i < p.bm * p.Kp; i += nthreads) {
    const int r = i / p.Kp, k = i - r * p.Kp;
    const int64_t m = m0 + r;
    float v = 0.f;
    if (m < p.M && k < p.kin()) {
      const float s = __ldg(p.s1() + k), b = __ldg(p.b1() + k);
      auto act = [&](int64_t mm) {
        return act_bf16(s, to_f32(p.x[mm * p.kin() + k]), b);
      };
      if constexpr (AQ) {
        const float* aw = p.aqw();
        const int t = (int)((m / HW) % p.T);
        if (t > 0) v = __ldg(aw + k) * act(m - HW);
        v = fmaf(__ldg(aw + p.kin() + k), act(m), v);
        if (t < p.T - 1) v = fmaf(__ldg(aw + 2 * p.kin() + k), act(m + HW), v);
      } else {
        v = act(m);
      }
    }
    As[r * p.a_rs + k] = __float2bfloat16(v);
  }
}

// ------------------------------------------------- launch B: the shift gather

// The per-channel table of launch B, 8 words a channel in shared memory
// (tab() channels a row): [0] the first non-zero tap's offset per axis (T, H,
// W), each + kTcBias in 8 bits, and kTcWide; [1] the element offset of that
// corner from the row's own (m, 0) at stride 1; [2..7] the weights of that tap
// and the next, per axis. A fractional shift has two adjacent non-zero taps
// per axis, a quantized or integer one has one; the identity T row of the aq
// form has one.
template <class P>
__device__ __forceinline__ void build_tap_table(const P& p, int* table) {
  const float* taps = p.taps();
  float* wts = reinterpret_cast<float*>(table + 2 * p.tab());
  for (int c = threadIdx.x; c < p.tab(); c += blockDim.x) {
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
      wts[(2 * a) * p.tab() + c] = w0;
      wts[(2 * a + 1) * p.tab() + c] = w1;
    }
    table[c] = (off[0] + kTcBias) | ((off[1] + kTcBias) << 8) |
               ((off[2] + kTcBias) << 16) | (wide ? kTcWide : 0);
    table[p.tab() + c] = ((off[0] * p.H + off[1]) * p.W + off[2]) * p.C + c;
  }
}

// Where a row of the gathered (N, T, H, W) grid lies: its frame, and the
// source coordinates (t, h, w) of the taps' offset 0.
struct TcRow {
  int t, h, w, frame;
};

// The shifted value of channel c at row r as a sum over every non-zero tap,
// for a channel whose taps are not two adjacent ones: right, not fast.
template <class P>
__device__ __forceinline__ float gather_taps(const P& p, const TcRow& r,
                                             int c) {
  const float* taps = p.taps();
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

// ------------------------------------------------------- products and stores

// The store of four consecutive columns n .. n + 3 of row m (8-byte accesses;
// C is a multiple of 4 here): bn2 + relu into mid (launch A), the residual
// add onto the four values of x in `res` (K2's launch B), or the sum as it is
// (K3's launch B).
template <int MODE, class P>
__device__ __forceinline__ void store4(const P& p, int64_t m, int n,
                                       const float (&v)[4], uint2 res) {
  const int64_t i = m * p.C + n;
  float o[4];
  if (MODE == kTcOut) {
    o[0] = __uint_as_float(res.x << 16) + v[0];
    o[1] = __uint_as_float(res.x & 0xffff0000u) + v[1];
    o[2] = __uint_as_float(res.y << 16) + v[2];
    o[3] = __uint_as_float(res.y & 0xffff0000u) + v[3];
  } else if (MODE == kTcEntryOut) {
    o[0] = v[0], o[1] = v[1], o[2] = v[2], o[3] = v[3];
  } else {
    const float4 sc = __ldg(reinterpret_cast<const float4*>(p.s2() + n));
    const float4 bi = __ldg(reinterpret_cast<const float4*>(p.b2() + n));
    o[0] = fmaxf(fmaf(sc.x, v[0], bi.x), 0.f);
    o[1] = fmaxf(fmaf(sc.y, v[1], bi.y), 0.f);
    o[2] = fmaxf(fmaf(sc.z, v[2], bi.z), 0.f);
    o[3] = fmaxf(fmaf(sc.w, v[3], bi.w), 0.f);
  }
  *reinterpret_cast<uint2*>(p.dst + i) =
      make_uint2(pack2(o[0], o[1]), pack2(o[2], o[3]));
}

// The same for one column, any width.
template <int MODE, class P>
__device__ __forceinline__ void store1(const P& p, int64_t m, int n,
                                       float v) {
  const int64_t i = m * p.C + n;
  if (MODE == kTcOut)
    v += to_f32(p.x[i]);
  else if (MODE != kTcEntryOut)
    v = fmaxf(fmaf(__ldg(p.s2() + n), v, __ldg(p.b2() + n)), 0.f);
  p.dst[i] = __float2bfloat16(v);
}

// The k loop of a warp's 16 rows x 72 columns: every fragment of a 16-deep
// step is fetched before the step's first product, and the products are plain
// (non-volatile) statements, so the compiler may run the next step's fetches
// under this step's products. FULL: all nine column tiles of the warp exist.
template <bool FULL, class P>
__device__ __forceinline__ void multiply_steps(const P& p, const bf16* a_ptr,
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

// Four column sums s of the eight row lanes g of a quad position, reduced
// over those lanes in a fixed order (xor 16, 8, 4): each lane ends with the
// sum of one column, (g & 4 ? 2 : 0) + (g & 2 ? 1 : 0), which the lanes
// with g even hold. Four shuffles, not twelve.
__device__ __forceinline__ float tc_se_reduce4(const float (&s)[4], int g) {
  const bool hi = g & 4, mid = g & 2;
  const float r0 = __shfl_xor_sync(0xffffffffu, hi ? s[0] : s[2], 16);
  const float r1 = __shfl_xor_sync(0xffffffffu, hi ? s[1] : s[3], 16);
  const float k0 = (hi ? s[2] : s[0]) + r0, k1 = (hi ? s[3] : s[1]) + r1;
  float v = (mid ? k1 : k0) +
            __shfl_xor_sync(0xffffffffu, mid ? k0 : k1, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// The same for two column sums: the lanes with (g & 3) == 0 hold column
// (g & 4 ? 1 : 0).
__device__ __forceinline__ float tc_se_reduce2(const float (&s)[2], int g) {
  const bool hi = g & 4;
  float v = (hi ? s[1] : s[0]) +
            __shfl_xor_sync(0xffffffffu, hi ? s[0] : s[1], 16);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 4);
}

// The SE forms' store of a warp whose 16 rows lie in one frame (TWO: in two
// frames), C a multiple of 4: multiply_tile's store of mid (bn2, relu, four
// columns a thread), and with it each stored value, rounded as stored,
// times its channel's aH[h] * aW[w] from the tables (tc_se.cuh), summed over
// the thread's rows of a frame, then over the eight row lanes
// (tc_se_reduce4) into the warp's row of the shared sums for that frame. A
// pair of column tiles at a time, both rows, so that four sums a frame are
// live, not eighteen. Stride S: 1 (K2), 2 (K3).
template <int S, bool TWO, class P>
__device__ __forceinline__ void store_tile_se(const P& p,
                                              const float (&acc)[kTcNT][4],
                                              int64_t m0, int n0, int col0,
                                              int nt_valid, int wm_i,
                                              int lane) {
  constexpr int NF = TWO ? 2 : 1;
  const TcSeGeom geo = tc_se_geom<S>(p);
  const int g = lane >> 2, t4 = lane & 3;
  const bool odd = t4 & 1;
  const int nbase = n0 + col0;
  const int n4 = nbase + (odd ? 8 : 0) + 2 * (t4 & ~1);  // + 16 * pair
  const int n9 = nbase + 64 + 2 * t4;
  const int r_lo = (int)m0 + wm_i * 16;
  const int hw = p.H * p.W;
  const int fa = r_lo / hw;
  // The thread's two rows: where they are stored, their weights indexed by
  // the absolute column, and (TWO) whether they lie in the second frame.
  bf16* dst[2];
  const float* wh[2];
  const float* ww[2];
  bool live[2], second[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = r_lo + g + 8 * half;
    live[half] = m < p.M;
    const int q = live[half] ? m / p.W : 0;
    const int w = live[half] ? m - q * p.W : 0;
    second[half] = TWO && live[half] && m >= (fa + 1) * hw;
    dst[half] = p.dst + (int64_t)m * p.C;
    wh[half] = geo.base + tc_se_entry<S>(geo, q % p.H, p.H) * geo.ncp - n0;
    ww[half] = geo.base +
               (geo.entries + tc_se_entry<S>(geo, w, p.W)) * geo.ncp - n0;
  }
  // The warp's row of the shared sums for frame fa, indexed by the column.
  float* red = geo.base +
               (2 * geo.entries + wm_i * geo.slots + fa - (int)m0 / hw) *
                   geo.ncp - n0;
  const int c4 = (g & 4 ? 2 : 0) + (g & 2 ? 1 : 0);  // tc_se_reduce4's
#pragma unroll
  for (int np = 0; np < kTcNT / 2; ++np) {
    const int n = n4 + 16 * np;
    const bool cols = 2 * np < nt_valid && n < p.C;
    float sum[NF][4];
#pragma unroll
    for (int f = 0; f < NF; ++f)
#pragma unroll
      for (int i = 0; i < 4; ++i) sum[f][i] = 0.f;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // Every lane takes part in the exchange, whatever it stores.
      const float a0 = acc[2 * np][2 * half], a1 = acc[2 * np][2 * half + 1];
      const float b0 = acc[2 * np + 1][2 * half];
      const float b1 = acc[2 * np + 1][2 * half + 1];
      const float r0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
      const float r1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
      if (!live[half] || !cols) continue;
      const float4 sc = __ldg(reinterpret_cast<const float4*>(p.s2() + n));
      const float4 bi = __ldg(reinterpret_cast<const float4*>(p.b2() + n));
      const uint2 o = make_uint2(
          pack2(fmaxf(fmaf(sc.x, odd ? r0 : a0, bi.x), 0.f),
                fmaxf(fmaf(sc.y, odd ? r1 : a1, bi.y), 0.f)),
          pack2(fmaxf(fmaf(sc.z, odd ? b0 : r0, bi.z), 0.f),
                fmaxf(fmaf(sc.w, odd ? b1 : r1, bi.w), 0.f)));
      *reinterpret_cast<uint2*>(dst[half] + n) = o;
      const float4 fh = *reinterpret_cast<const float4*>(wh[half] + n);
      const float4 fw = *reinterpret_cast<const float4*>(ww[half] + n);
      const float v[4] = {__uint_as_float(o.x << 16) * fh.x,
                          __uint_as_float(o.x & 0xffff0000u) * fh.y,
                          __uint_as_float(o.y << 16) * fh.z,
                          __uint_as_float(o.y & 0xffff0000u) * fh.w};
      const float wv[4] = {fw.x, fw.y, fw.z, fw.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (TWO && second[half])
          sum[NF - 1][i] = fmaf(v[i], wv[i], sum[NF - 1][i]);
        else
          sum[0][i] = fmaf(v[i], wv[i], sum[0][i]);
      }
    }
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      const float v = tc_se_reduce4(sum[f], g);
      if ((g & 1) == 0 && cols) red[f * geo.ncp + n + c4] = v;
    }
  }
  const bool cols9 = kTcNT - 1 < nt_valid && n9 < p.C;  // n9 + 1 < C too
  float sum9[NF][2];
#pragma unroll
  for (int f = 0; f < NF; ++f) sum9[f][0] = sum9[f][1] = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (!live[half] || !cols9) continue;
    const unsigned o = pack2(
        fmaxf(fmaf(__ldg(p.s2() + n9), acc[kTcNT - 1][2 * half],
                   __ldg(p.b2() + n9)), 0.f),
        fmaxf(fmaf(__ldg(p.s2() + n9 + 1), acc[kTcNT - 1][2 * half + 1],
                   __ldg(p.b2() + n9 + 1)), 0.f));
    *reinterpret_cast<unsigned*>(dst[half] + n9) = o;
    const float2 fh = *reinterpret_cast<const float2*>(wh[half] + n9);
    const float2 fw = *reinterpret_cast<const float2*>(ww[half] + n9);
    const int f = TWO && second[half] ? NF - 1 : 0;
    sum9[f][0] = fmaf(__uint_as_float(o << 16) * fh.x, fw.x, sum9[f][0]);
    sum9[f][1] = fmaf(__uint_as_float(o & 0xffff0000u) * fh.y, fw.y,
                      sum9[f][1]);
  }
#pragma unroll
  for (int f = 0; f < NF; ++f) {
    const float v = tc_se_reduce2(sum9[f], g);
    if ((g & 3) == 0 && cols9) red[f * geo.ncp + n9 + (g >> 2)] = v;
  }
}

// What multiply_tile calls once the warp has read the last of its A tile:
// nothing, or (K2's ring) the release of the tile's stage.
struct TcNoRelease {
  __device__ __forceinline__ void operator()() const {}
};

// The products of one tile against the resident W chunk, and the store:
// warp (wm_i, wn_i) of the multiplying warps owns 16 rows x 72 columns.
// (Two 16-row tiles a warp, which halve the fetches of W per product, measured
// slower at every shape: the accumulators then leave room for 8 warps only.)
// `release()` runs, warp-uniformly, right after the warp's last read of As.
template <int MODE, class P, class Release = TcNoRelease>
__device__ __forceinline__ void multiply_tile(const P& p, const bf16* As,
                                              const bf16* Ws, int64_t m0,
                                              int n0, int wm_i, int wn_i,
                                              int lane,
                                              const Release& release = {}) {
  const int col0 = wn_i * kTcWarpCols;  // the warp's first column, in the chunk
  const int tiles_left = ((p.C + 7) >> 3) - ((n0 + col0) >> 3);
  const int nt_valid = max(0, min(kTcNT, tiles_left));
  if (nt_valid == 0) {
    release();
    return;
  }
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

  // K2's launch B: the residual, fetched before the products so that it
  // arrives under them. The thread that reads an element of x is the one that
  // writes it, and every read comes before the first write: out may alias x.
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
  release();

  if constexpr (tc_se_mode(MODE)) {
    // The SE forms: a warp whose rows lie in one or two frames stores and
    // sums in one pass; any other takes the store below and the general
    // sums.
    constexpr int S = MODE == kTcEntryMidSe ? 2 : 1;
    const int frames = quads ? tc_se_frames(p, m0, wm_i) : 0;
    if (frames == 1) {
      store_tile_se<S, false>(p, acc, m0, n0, col0, nt_valid, wm_i, lane);
      return;
    }
    if (frames == 2) {
      store_tile_se<S, true>(p, acc, m0, n0, col0, nt_valid, wm_i, lane);
      return;
    }
  }

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
  if constexpr (tc_se_mode(MODE))
    tc_se_warp_sums<MODE == kTcEntryMidSe ? 2 : 1>(p, acc, m0, n0, col0,
                                                   nt_valid, wm_i, lane);
}

}  // namespace rubiks
