// K3's two GEMM launches for bfloat16, designed for the H100: the stride-2
// stage-entry block with channel growth of fused_entry.cu,
//
//   A: mid = relu(s2 . (relu(s1 . x + b1) @ W2) + b2)       (N, T, H, W, Cm)
//   B: out = ([gate .] shift3d_s2(mid)) @ W3
//            + relu(s1 . x + b1)[:, :, ::2, ::2] @ Wsc     (N, T, H/2, W/2, Cm)
//
// in its rubiks3d form, under the SE gate (launch A then also sums the
// gate's weighted values of mid per frame, tc_se.cuh, and one launch between
// A and B makes the gate from them, se_gate_tc.cu), and in its rubiks3d-aq
// form (launch A mixes the activated input along T with the three attention
// taps, K2-AQ's loader, before W2; the shift is 2D: an identity T tap row).
// It replaces, for bf16, the
// common.cuh GEMM those launches ran on before, and with it
// rubiksnet_tpu/ops/pallas/fused_entry.py::fused_entry_run (gate_from_mean
// for the SE tier). float32 stays on the common.cuh GEMM (SIMT f32 products,
// exact).
//
// What held the previous route back is what held K2's (fused_block_tc.cu says
// what): a serial chain of 2-byte loads and barriers, W re-read as f32 by every
// block. This design is K2's, from tc_core.cuh: mma.sync m16n8k16 products with
// ldmatrix operands, a warp owning 16 rows x 72 columns, W resident in shared
// memory per persistent block (column chunks of wn * 72 over grid.y where it
// does not fit), 16-byte loads, optional producer warps, programmatic
// dependent launch. Where K3 differs:
//
// * Launch A is K2's launch A with a depth of Cin and a width of Cm: W2 is
//   resident whole up to 144 -> 288 and in chunks at 288 -> 576. It computes
//   every full-resolution mid cell: with fractional shifts every cell is read
//   by some stride-2 tap.
// * Launch B runs over the output grid with one K loop of Cm + Cin (padded to
//   16): k < Cm is the stride-2 gather of mid at (t, 2h', 2w') + taps, from
//   K2's per-channel tap table, one channel per lane, times the gate; k >= Cm
//   is the shortcut, relu(s1 . x + b1) at (t, 2h', 2w') rounded to bf16, read
//   16 bytes a thread along Cin, not gated. W = [W3; Wsc] is loaded into one
//   resident region from the two arrays, so the shortcut is a second K range
//   of the same accumulator and the store is a plain one.
// * The gather: at stride 2 two neighbouring output pixels share no source
//   column, so K2's carry of the T/H interpolation from one column to the
//   next does not apply and a pixel costs eight corner loads (two columns of
//   four), not four. A lane walks 16 consecutive output pixels along an image
//   line with the line's bounds and pointers set once, two pixels' sixteen
//   loads in flight together. Channels whose taps are not two adjacent ones
//   take the general loop of tc_core.cuh.
// * Where [W3; Wsc] does not fit beside the A tile (Cm >= 288 at the
//   published widths: 2 and 8 column chunks), every chunk would gather the
//   same rows again, and the gather, not the products, is what costs. There
//   a pre-pass (rubiks_entry_gather_kernel, every warp gathering, the table
//   in shared memory) writes the operand rows once to a scratch, bf16, Kp a
//   row, and launch B's tiles copy them 16 bytes a thread. (Measured on the
//   H100 at batch 8 before it: launch B at 14 x 14 x 288 -> 576 took 0.333
//   ms of the entry's 0.370, eight chunks of 72 columns each gathering all
//   576 channels; PERF.md has the numbers after.)
//
// No float atomics and no split of K: the result is bit-identical from run to
// run. The plan (rows per tile, warps, column chunks, grid, shared memory) of
// each launch is made in ops/fused_entry.py::fused_entry_plan and only checked
// here.
#include "fused_entry_tc.cuh"
#include "tc_core.cuh"

namespace rubiks {

struct EntryArgs {
  const bf16* x;      // (N, T, H, W, Cin)
  const bf16* mid;    // B: (N, T, H, W, C), the tensor the shift gathers
  bf16* dst;          // A: mid. B: out (N, T, Ho, Wo, C)
  const bf16* w;      // A: W2 (Cin, C). B: W3 (C, C). (in, out)
  const bf16* wsc;    // B: the shortcut (Cin, C)
  const float* vt1;   // rows s1, b1 (AQ: then w0, w1, w2), Cin wide
  const float* vt2;   // rows s2, b2, 3 * taps_n taps, C wide
  const float* gate;  // B: nullptr or (N*T, C). A with SE: the partials
  bf16* stage;        // B: nullptr, or the gather pre-pass's rows (Kp each)
  int64_t M;          // rows: A N*T*H*W, B N*T*Ho*Wo
  int T, H, W, Ho, Wo, Cin, C, taps_n, K;
  int Kp;          // depth of the A tile: A Cin, B C + Cin, rounded up to 16
  int Kt;          // B: the table's channels, C rounded up to 16
  int a_rs, w_rs;  // row strides of the A tile and the W chunk, in elements
  int wn, bm, row_tiles;
  int pw;          // producer warps (0: every warp loads, then multiplies)
  int a_bytes;     // bytes of one A tile buffer (two of them when pw > 0)
  int w_off, t_off;  // byte offsets of the W chunk and the table
  int vec;           // 16-byte global accesses are aligned
  __device__ __forceinline__ int kin() const { return Cin; }
  __device__ __forceinline__ int tab() const { return Kt; }
  __device__ __forceinline__ const float* s1() const { return vt1; }
  __device__ __forceinline__ const float* b1() const { return vt1 + Cin; }
  // The attention rows of the AQ form of launch A, after s1 and b1.
  __device__ __forceinline__ const float* aqw() const {
    return vt1 + 2 * (int64_t)Cin;
  }
  __device__ __forceinline__ const float* s2() const { return vt2; }
  __device__ __forceinline__ const float* b2() const { return vt2 + C; }
  __device__ __forceinline__ const float* taps() const {
    return vt2 + 2 * (int64_t)C;
  }
};

// Launch A's modes: mid from x, with the gate's sums, with the attention mix.
__host__ __device__ constexpr bool entry_mid_mode(int mode) {
  return mode == kTcEntryMid || mode == kTcEntryMidSe || mode == kTcEntryMidAq;
}

// ---------------------------------------------------------------- launch B

// Where row m of the output (N, T, Ho, Wo) grid lies, in output coordinates.
__device__ __forceinline__ TcRow entry_row(const EntryArgs& p, int m) {
  TcRow r;
  r.w = m % p.Wo;
  const int q = m / p.Wo;
  r.h = q % p.Ho;
  r.frame = q / p.Ho;
  r.t = r.frame % p.T;
  return r;
}

// The full-resolution row of x that output row m samples: (frame, 2h', 2w').
__device__ __forceinline__ int64_t entry_src_row(const EntryArgs& p,
                                                 int64_t m) {
  const TcRow r = entry_row(p, (int)m);
  return ((int64_t)r.frame * p.H + 2 * r.h) * p.W + 2 * r.w;
}

// Columns [0, C) of launch B's A tile: the gathered, gated shift of mid. A
// unit of work is kTcRun consecutive output rows of one 32-channel slab; a
// warp takes units in turn, a lane one channel, and walks the rows line by
// line: per line the taps' rows (t + ot + dt, 2h' + oh + dh), their bounds
// and the gate are set once; per pixel w' the two source columns 2w' + ow and
// 2w' + ow + 1 are read, four corners each.
__device__ __forceinline__ void build_entry_shift(const EntryArgs& p,
                                                  bf16* As, int64_t m0,
                                                  const int* table, int tid,
                                                  int nthreads) {
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* wts = reinterpret_cast<const float*>(table + 2 * p.Kt);
  const int slabs = (p.C + 31) >> 5;
  const int units = (p.bm / kTcRun) * slabs;
  for (int u = warp; u < units; u += nwarps) {
    const int run = u / slabs, c = ((u - run * slabs) << 5) + lane;
    if (c >= p.C) continue;
    bf16* dst = As + run * kTcRun * p.a_rs + c;
    const int64_t m_first = m0 + run * kTcRun;
    const int nrows =
        (int)max((int64_t)0, min((int64_t)kTcRun, p.M - m_first));
    int r = 0;
    if (nrows > 0) {
      TcRow at = entry_row(p, (int)m_first);
      const int pk = table[c];
      if (pk & kTcWide) {
        for (; r < nrows; ++r) {
          TcRow here = entry_row(p, (int)m_first + r);
          const int frame = here.frame;
          here.h *= 2, here.w *= 2;  // the taps' offset 0 in mid
          float v = gather_taps(p, here, c);
          if (p.gate != nullptr)
            v *= __ldg(p.gate + (int64_t)frame * p.C + c);
          dst[r * p.a_rs] = __float2bfloat16(v);
        }
      } else {
        const int ot = (pk & 0xff) - kTcBias, oh = ((pk >> 8) & 0xff) - kTcBias;
        const int ow = ((pk >> 16) & 0xff) - kTcBias;
        float wa[3][2];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          wa[a][0] = wts[(2 * a) * p.Kt + c];
          wa[a][1] = wts[(2 * a + 1) * p.Kt + c];
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
          // A line: the output pixels at.w .. at.w + seg - 1 of row
          // (at.frame, at.h), read from source row 2 * at.h.
          const int seg = min(p.Wo - at.w, nrows - r);
          const int h = 2 * at.h;
          bool okt[2], okh[2];
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            okt[d] = wa[0][d] != 0.f &&
                     (unsigned)(at.t + ot + d) < (unsigned)p.T;
            okh[d] = wa[1][d] != 0.f && (unsigned)(h + oh + d) < (unsigned)p.H;
          }
#pragma unroll
          for (int dt = 0; dt < 2; ++dt)
#pragma unroll
            for (int dh = 0; dh < 2; ++dh) ln.ok[dt][dh] = okt[dt] && okh[dh];
          ln.q = reinterpret_cast<const unsigned short*>(
              p.mid + ((int64_t)(at.frame + ot) * p.H + (h + oh)) *
                          (int64_t)p.W * p.C + c);
          const float gate =
              p.gate != nullptr
                  ? __ldg(p.gate + (int64_t)at.frame * p.C + c) : 1.f;
          const float w0 = wa[2][0] * gate, w1 = wa[2][1] * gate;
          int col = 2 * at.w + ow;
          int j = 0;
          for (; j + 2 <= seg; j += 2, col += 4) {
            unsigned short ub[4][2][2];
#pragma unroll
            for (int k = 0; k < 4; ++k) ln.load(col + k, ub[k]);
#pragma unroll
            for (int k = 0; k < 2; ++k)
              dst[(r + j + k) * p.a_rs] = __float2bfloat16(
                  fmaf(w1, ln.sum(ub[2 * k + 1]), w0 * ln.sum(ub[2 * k])));
          }
          if (j < seg) {
            unsigned short ub[2][2][2];
            ln.load(col, ub[0]);
            ln.load(col + 1, ub[1]);
            dst[(r + j) * p.a_rs] = __float2bfloat16(
                fmaf(w1, ln.sum(ub[1]), w0 * ln.sum(ub[0])));
          }
          r += seg;
          at.w += seg;
          if (at.w == p.Wo) {
            at.w = 0;
            if (++at.h == p.Ho) {
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

// Columns [C, Kp) of launch B's A tile: the shortcut relu(s1 . x + b1) at
// (frame, 2h', 2w'), zero past C + Cin; 16 bytes a thread as launch A's
// loader reads x (C and Cin multiples of 8).
__device__ __forceinline__ void build_entry_shortcut_vec(const EntryArgs& p,
                                                         bf16* As, int64_t m0,
                                                         int tid,
                                                         int nthreads) {
  constexpr int RB = 4;
  const int groups = (p.Kp - p.C) >> 3;
  const int tcs = min(groups, nthreads);
  const int trs = nthreads / tcs;
  const int tr = tid / tcs, tc = tid - tr * tcs;
  if (tr >= trs) return;
  for (int g = tc; g < groups; g += tcs) {
    const int k = g << 3;
    const bool live = k < p.Cin;
    const int kk = live ? k : 0;
    float s[8], b[8];
    ldg8(p.s1() + kk, s);
    ldg8(p.b1() + kk, b);
    for (int r0 = tr; r0 < p.bm; r0 += trs * RB) {
      uint4 v[RB];
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        int64_t m = m0 + r0 + j * trs;
        if (m >= p.M) m = p.M - 1;
        v[j] = __ldg(reinterpret_cast<const uint4*>(
            p.x + entry_src_row(p, m) * p.Cin + kk));
      }
#pragma unroll
      for (int j = 0; j < RB; ++j) {
        const int r = r0 + j * trs;
        if (r >= p.bm) continue;
        uint4 o = make_uint4(0u, 0u, 0u, 0u);
        if (live && m0 + r < p.M) {
          float f[8];
          unpack8(v[j], f);
#pragma unroll
          for (int i = 0; i < 8; ++i) f[i] = fmaxf(fmaf(s[i], f[i], b[i]), 0.f);
          o = pack8(f);
        }
        *reinterpret_cast<uint4*>(As + r * p.a_rs + p.C + k) = o;
      }
    }
  }
}

// The same element by element, for widths that are no multiple of 8 or
// tensors that are not 16-byte aligned.
__device__ __forceinline__ void build_entry_shortcut_scalar(
    const EntryArgs& p, bf16* As, int64_t m0, int tid, int nthreads) {
  const int cols = p.Kp - p.C;
  for (int i = tid; i < p.bm * cols; i += nthreads) {
    const int r = i / cols, k = i - r * cols;
    const int64_t m = m0 + r;
    float v = 0.f;
    if (m < p.M && k < p.Cin)
      v = act_bf16(__ldg(p.s1() + k),
                   to_f32(p.x[entry_src_row(p, m) * p.Cin + k]),
                   __ldg(p.b1() + k));
    As[r * p.a_rs + p.C + k] = __float2bfloat16(v);
  }
}

// Launch B's A tile from the gather pre-pass's rows [m0, m0 + bm), 16 bytes
// a thread (Kp is a multiple of 16, the stage freshly allocated).
__device__ __forceinline__ void copy_stage_tile(const EntryArgs& p, bf16* As,
                                                int64_t m0, int tid,
                                                int nthreads) {
  const int per_row = p.Kp >> 3;
  const bf16* src = p.stage + m0 * p.Kp;
  for (int i = tid; i < p.bm * per_row; i += nthreads) {
    const int r = i / per_row, k = (i - r * per_row) << 3;
    *reinterpret_cast<uint4*>(As + r * p.a_rs + k) =
        __ldg(reinterpret_cast<const uint4*>(src + (int64_t)r * p.Kp + k));
  }
}

// The operand rows of one tile of launch B: the gather, the shortcut, zeros.
__device__ __forceinline__ void build_entry_operand(const EntryArgs& p,
                                                   bf16* As, int64_t m0,
                                                   const int* table, int tid,
                                                   int nthreads) {
  build_entry_shift(p, As, m0, table, tid, nthreads);
  if (p.vec)
    build_entry_shortcut_vec(p, As, m0, tid, nthreads);
  else
    build_entry_shortcut_scalar(p, As, m0, tid, nthreads);
}

// ------------------------------------------------------------- the kernels

// After the prologue (W chunk requested, table built, the wait for the launch
// before): persistent blocks over the row tiles, as rubiks_tc_kernel walks
// them (there written out in the kernel, whose register allocation it
// shapes). Shared memory: the A tile
// (bm x Kp; two of them when pw > 0), the W chunk (Kp x wn * 72) and the
// table. With pw > 0 the first pw warps only load: they build tile i + 1 in
// one buffer while the other warps multiply tile i from the other, one
// barrier per tile. With pw = 0 every warp builds the tile, then every warp
// multiplies it. build(As, m0, tid, nthreads) fills one A tile. The SE form
// of launch A writes each tile's partials of the gate once its row warps'
// sums are in shared memory (tc_se.cuh), as K2's kernel does.
template <int MODE, class Build>
__device__ __forceinline__ void entry_tiles(const EntryArgs& p,
                                            unsigned char* smem,
                                            const bf16* Ws, int n0,
                                            const Build& build) {
  bf16* As = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (p.pw == 0) {
    const int wm_i = warp / p.wn, wn_i = warp - wm_i * p.wn;
    for (int tile = blockIdx.x; tile < p.row_tiles; tile += gridDim.x) {
      const int64_t m0 = (int64_t)tile * p.bm;
      build(As, m0, tid, blockDim.x);
      tc_cp_wait_all();  // the W chunk, before the first tile's products
      __syncthreads();
      multiply_tile<MODE>(p, As, Ws, m0, n0, wm_i, wn_i, lane);
      __syncthreads();  // the A tile is free again
      if constexpr (tc_se_mode(MODE))
        tc_se_store_partials<2>(p, m0, n0, tid, blockDim.x);
    }
  } else {
    const bool loads = warp < p.pw;
    const int cw = loads ? 0 : warp - p.pw;
    const int wm_i = cw / p.wn, wn_i = cw - wm_i * p.wn;
    const int nload = p.pw * 32;
    bf16* bufs[2] = {As, reinterpret_cast<bf16*>(smem + p.a_bytes)};
    int tile = blockIdx.x;
    if (loads && tile < p.row_tiles)
      build(bufs[0], (int64_t)tile * p.bm, tid, nload);
    tc_cp_wait_all();
    __syncthreads();
    for (int it = 0; tile < p.row_tiles; tile += gridDim.x, ++it) {
      const int next = tile + gridDim.x;
      if (loads) {
        if (next < p.row_tiles)
          build(bufs[(it + 1) & 1], (int64_t)next * p.bm, tid, nload);
      } else {
        multiply_tile<MODE>(p, bufs[it & 1], Ws, (int64_t)tile * p.bm, n0,
                            wm_i, wn_i, lane);
        if constexpr (tc_se_mode(MODE)) {
          const int nmul = blockDim.x - nload;
          asm volatile("bar.sync 1, %0;" ::"r"(nmul) : "memory");
          tc_se_store_partials<2>(p, (int64_t)tile * p.bm, n0, tid - nload,
                                  nmul);
        }
      }
      __syncthreads();
    }
  }
  tc_cp_wait_all();
}

// One A tile by the `nthreads` loading threads.
template <int MODE>
__device__ __forceinline__ void build_entry_tile(const EntryArgs& p, bf16* As,
                                                 int64_t m0, const int* table,
                                                 int tid, int nthreads) {
  if (MODE == kTcEntryOut) {
    if (p.stage != nullptr)
      copy_stage_tile(p, As, m0, tid, nthreads);
    else
      build_entry_operand(p, As, m0, table, tid, nthreads);
  } else if (p.vec) {
    build_act_tile_vec<MODE == kTcEntryMidAq>(p, As, m0, tid, nthreads);
  } else {
    build_act_tile_scalar<MODE == kTcEntryMidAq>(p, As, m0, tid, nthreads);
  }
}

// grid (persistent blocks over the row tiles, column chunks), block pw + wm *
// wn warps; the walk over the tiles is entry_tiles.
template <int MODE>
__global__ void __launch_bounds__(kTcMaxThreads, 1)
    rubiks_entry_tc_kernel(const EntryArgs p) {
  extern __shared__ __align__(16) unsigned char entry_smem[];
  bf16* Ws = reinterpret_cast<bf16*>(entry_smem + p.w_off);
  int* table = reinterpret_cast<int*>(entry_smem + p.t_off);
  const int n0 = blockIdx.y * p.wn * kTcWarpCols;  // the chunk's first column

  // As in K2's launches: the weights and the taps come in while the launch
  // before this one still runs (programmatic dependent launch); the first
  // read of an activation (x, mid, the gate) waits for it to finish.
  asm volatile("griddepcontrol.launch_dependents;");
  if (entry_mid_mode(MODE)) {
    load_w_rows(p, Ws, n0, p.w, 0, p.Cin, p.Kp);
    if constexpr (tc_se_mode(MODE)) tc_se_build_tables<2>(p, n0);
  } else {
    load_w_rows(p, Ws, n0, p.w, 0, p.C, p.C);
    load_w_rows(p, Ws, n0, p.wsc, p.C, p.Cin, p.Kp);
    if (p.stage == nullptr) build_tap_table(p, table);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();

  entry_tiles<MODE>(p, entry_smem, Ws, n0,
                    [&](bf16* As, int64_t m0, int tid, int nthreads) {
                      build_entry_tile<MODE>(p, As, m0, table, tid,
                                             nthreads);
                    });
}

// The gather pre-pass: launch B's operand rows into the stage (row stride
// a_rs = Kp), tiles of bm rows over a persistent grid, every warp gathering.
__global__ void __launch_bounds__(kTcMaxThreads, 1)
    rubiks_entry_gather_kernel(const EntryArgs p) {
  extern __shared__ __align__(16) unsigned char gather_smem[];
  int* table = reinterpret_cast<int*>(gather_smem);
  asm volatile("griddepcontrol.launch_dependents;");
  build_tap_table(p, table);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();
  for (int tile = blockIdx.x; tile < p.row_tiles; tile += gridDim.x) {
    const int64_t m0 = (int64_t)tile * p.bm;
    build_entry_operand(p, p.stage + m0 * p.Kp, m0, table, threadIdx.x,
                        blockDim.x);
  }
}

// ---------------------------------------------------------------- the host

namespace {

bool entry_shape_ok(const EntryShape& s) {
  if (s.N < 0 || s.T < 1 || s.H < 2 || s.W < 2 || s.H % 2 || s.W % 2 ||
      s.Cin < 1 || s.Cm < 1)
    return false;
  if (s.taps_n < 1 || s.taps_n > kMaxTaps || s.K < 0 || s.K >= kTcBias)
    return false;
  const int64_t frame = (int64_t)s.H * s.W * s.Cm;
  if (frame * (s.K + 3) >= (int64_t(1) << 31)) return false;  // int offsets
  return (int64_t)s.N * s.T * s.H * s.W < (int64_t(1) << 31);
}

bool entry_plan_ok(const TcPlan& p, const EntryShape& s, int depth,
                   int table_c) {
  if (p.wm < 1 || p.wn < 1 || p.pw < 0 ||
      (p.pw + p.wm * p.wn) * 32 > kTcMaxThreads)
    return false;
  if (p.n_split < 1 || p.n_split > 65535 || p.grid_x < 1) return false;
  const int64_t tiles_n = (s.Cm + 7) / 8;
  const int64_t chunk = (int64_t)p.wn * kTcNT;
  if (p.n_split * chunk < tiles_n || (p.n_split - 1) * chunk >= tiles_n)
    return false;  // the chunks cover the columns, and none is empty
  return p.smem_bytes == entry_smem_bytes(p, depth, table_c) &&
         p.smem_bytes <= kTcMaxSmem && entry_shape_ok(s);
}

// The fields of `a` that follow from the shape, for a launch over `rows`
// rows of an A tile `depth` deep.
void entry_fill(EntryArgs& a, const EntryShape& s, int64_t rows, int depth,
                int table_c, int bm) {
  a.T = s.T, a.H = s.H, a.W = s.W, a.Ho = s.H / 2, a.Wo = s.W / 2;
  a.Cin = s.Cin, a.C = s.Cm, a.taps_n = s.taps_n, a.K = s.K;
  a.M = rows;
  a.Kp = (depth + 15) & ~15;
  a.Kt = (table_c + 15) & ~15;
  a.bm = bm;
  a.row_tiles = (int)((a.M + a.bm - 1) / a.bm);
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.mid) |
      reinterpret_cast<uintptr_t>(a.dst) | reinterpret_cast<uintptr_t>(a.w) |
      reinterpret_cast<uintptr_t>(a.wsc) | reinterpret_cast<uintptr_t>(a.vt1) |
      reinterpret_cast<uintptr_t>(a.vt2) |
      reinterpret_cast<uintptr_t>(a.stage);
  a.vec = s.Cin % 8 == 0 && s.Cm % 8 == 0 && (bits & 15) == 0;
}

// One launch of `kernel` on `stream`: its shared-memory limit raised once per
// device (`raised`), programmatic dependent launch when `overlap` is set.
cudaError_t entry_launch_kernel(void (*kernel)(EntryArgs), bool (&raised)[64],
                                unsigned grid_x, unsigned grid_y,
                                unsigned warps, int smem_bytes, int overlap,
                                const EntryArgs& a, cudaStream_t stream) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, grid_y);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute early = {};
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, a);
}

template <int MODE>
cudaError_t entry_launch(const TcPlan& pl, const EntryShape& s, EntryArgs a,
                         cudaStream_t stream, int se_slots = 0) {
  constexpr bool kA = entry_mid_mode(MODE);
  const int depth = kA ? s.Cin : s.Cm + s.Cin;
  const int table_c = kA || a.stage != nullptr ? 0 : s.Cm;
  if (!entry_plan_ok(pl, s, depth, table_c)) return cudaErrorInvalidValue;
  const int64_t rows = kA ? (int64_t)s.N * s.T * s.H * s.W
                          : (int64_t)s.N * s.T * (s.H / 2) * (s.W / 2);
  if (rows == 0) return cudaSuccess;
  entry_fill(a, s, rows, depth, table_c, pl.wm * 16);
  a.a_rs = tc_row_stride(a.Kp);
  a.w_rs = tc_row_stride(pl.wn * kTcWarpCols);
  a.wn = pl.wn;
  a.pw = pl.pw;
  a.a_bytes = a.bm * a.a_rs * 2;
  a.w_off = a.a_bytes * (pl.pw > 0 ? 2 : 1);
  a.t_off = a.w_off + a.Kp * a.w_rs * 2;
  int smem = pl.smem_bytes;
  if (tc_se_mode(MODE)) {
    // The SE region follows the W chunk (launch A has no table), as in
    // fused_block_tc.cu's tc_launch.
    if (a.gate == nullptr || se_slots != tc_se_slots(a.bm, s.H * s.W))
      return cudaErrorInvalidValue;
    const int end = a.t_off + tc_se_bytes(s.taps_n, s.K, 2, pl.wm, pl.wn,
                                          se_slots);
    if (end > kTcMaxSmem) return cudaErrorInvalidValue;
    if (end > smem) smem = end;
  }
  static bool raised[64] = {};
  return entry_launch_kernel(
      rubiks_entry_tc_kernel<MODE>, raised,
      (unsigned)(pl.grid_x < a.row_tiles ? pl.grid_x : a.row_tiles),
      (unsigned)pl.n_split, (unsigned)(pl.pw + pl.wm * pl.wn), smem,
      pl.overlap, a, stream);
}

}  // namespace

cudaError_t entry_tc_launch_mid(const TcPlan& p, const EntryShape& s,
                                const void* x, const float* vt1,
                                const float* vt2, const void* w2, void* mid,
                                int aq, float* partial, int slots,
                                cudaStream_t stream) {
  EntryArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.dst = static_cast<bf16*>(mid);
  a.w = static_cast<const bf16*>(w2);
  a.vt1 = vt1;
  a.vt2 = vt2;
  if (partial != nullptr) {
    if (aq) return cudaErrorInvalidValue;  // no SE form with the mix
    a.gate = partial;
    return entry_launch<kTcEntryMidSe>(p, s, a, stream, slots);
  }
  if (aq) return entry_launch<kTcEntryMidAq>(p, s, a, stream);
  return entry_launch<kTcEntryMid>(p, s, a, stream);
}

cudaError_t entry_tc_launch_gather(int rows, int grid_x, int smem_bytes,
                                   int overlap, const EntryShape& s,
                                   const void* x, const void* mid,
                                   const float* vt1, const float* vt2,
                                   const float* gate, void* stage,
                                   cudaStream_t stream) {
  const int kt = (s.Cm + 15) & ~15;
  if (rows < 16 || rows % 16 || grid_x < 1 || smem_bytes != 32 * kt ||
      smem_bytes > kTcMaxSmem || stage == nullptr || !entry_shape_ok(s))
    return cudaErrorInvalidValue;
  EntryArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.mid = static_cast<const bf16*>(mid);
  a.vt1 = vt1;
  a.vt2 = vt2;
  a.gate = gate;
  a.stage = static_cast<bf16*>(stage);
  const int64_t out_rows = (int64_t)s.N * s.T * (s.H / 2) * (s.W / 2);
  if (out_rows == 0) return cudaSuccess;
  entry_fill(a, s, out_rows, s.Cm + s.Cin, s.Cm, rows);
  a.a_rs = a.Kp;
  static bool raised[64] = {};
  return entry_launch_kernel(
      rubiks_entry_gather_kernel, raised,
      (unsigned)(grid_x < a.row_tiles ? grid_x : a.row_tiles), 1u,
      kTcMaxThreads / 32, smem_bytes, overlap, a, stream);
}

cudaError_t entry_tc_launch_out(const TcPlan& p, const EntryShape& s,
                                const void* x, const void* mid,
                                const float* vt1, const float* vt2,
                                const void* w3, const void* wsc,
                                const float* gate, const void* stage,
                                void* out, cudaStream_t stream) {
  EntryArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.mid = static_cast<const bf16*>(mid);
  a.dst = static_cast<bf16*>(out);
  a.w = static_cast<const bf16*>(w3);
  a.wsc = static_cast<const bf16*>(wsc);
  a.vt1 = vt1;
  a.vt2 = vt2;
  a.gate = gate;
  a.stage = static_cast<bf16*>(const_cast<void*>(stage));
  return entry_launch<kTcEntryOut>(p, s, a, stream);
}

}  // namespace rubiks
