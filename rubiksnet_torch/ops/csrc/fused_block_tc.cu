// K2's two GEMM launches for bfloat16, designed for the H100: the fused
// stride-1 block of fused_block.cu,
//
//   A: mid = relu(s2 . ([AQ] relu(s1 . x + b1) @ W2) + b2)
//   B: out = x + ([gate .] shift3d(mid)) @ W3
//
// in its rubiks3d and rubiks3d-aq forms, and under the SE gate: launch A then
// also sums the gate's weighted values of mid per frame as it stores them
// (tc_se.cuh), and one launch between A and B makes the gate from those sums
// (se_gate_tc.cu). It replaces, for bf16, the
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
//   fit beside the operand stages, C <= 288; a chunk of wn * 72 columns
//   otherwise, grid.y chunks) into shared memory once, by 16-byte cp.async,
//   and then walks over row tiles (a persistent block): W is read once per
//   block, not once per row tile, and never through registers. The copy
//   lands while the first tiles are built, and it starts while the launch
//   before this one still runs (programmatic dependent launch, see the
//   kernel). Column chunks also give the small batches enough blocks; each
//   chunk rebuilds the A tiles.
// * Loading and multiplying overlap, on a ring of operand stages: of a
//   block's 16 warps the first lw build row tiles into `stages` stages in
//   shared memory and the last wm * wn multiply the stages in tile order and
//   store; a warp counted in both does both, building stages - 1 tiles ahead
//   of the one it multiplies. Each stage has a "full" and an "empty"
//   mbarrier; no block-wide barrier runs inside the tile loop, so warps
//   drift apart and one warp's loads run under another's products. A
//   multiplying warp releases a stage as soon as it has read its last
//   fragment of it (before its store). A loader's share of a tile moves
//   from tile to tile, so that no warp takes the surplus of every tile, and
//   with small stages (wide rows) the loaders ask L2 for the next tile's
//   bytes (one bulk prefetch a range) before they build this one. Where W
//   leaves room for large stages every warp loads and multiplies; where it
//   leaves little (C >= 288) the warps split into loaders and multipliers
//   once a block has enough tiles to keep both busy. Each launch (A, B)
//   has its own plan (ops/fused_block.py::fused_block_plan).
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
//   together. A corner outside the clip or the frame reads the lane's own
//   line under a zero weight, so only a column off the line is checked (a
//   zero); the loads inside it take no predicate and no zero fill. The reads
//   go to the L1/L2 caches directly, at every width. At 288 and 576 the
//   resident weights leave no room to stage a halo of three frames per row
//   tile in shared memory; at 72
//   and 144 they do (a band of image lines per channel slab, as shift2d.cu
//   stages its rows), and that variant has not been written or timed: it is
//   queued in ROADMAP.md. Taps with more than two non-zero weights per axis
//   take a general loop in the same kernel. The executor folds mid's
//   channels in the order of their first offsets (ops/fused_block.py::
//   order_mid_channels), so the lanes of a warp mostly read the same pixels.
//   (Lanes of eight or four channels, one 16- or 8-byte load a corner for
//   the group, in several forms, measured slower than a channel a lane at
//   every shape: fewer instructions a value, no shorter a gather.)
// * Stores: bn2/relu (A) or the residual add (B) on the accumulator fragment,
//   four consecutive columns per thread (8-byte stores, after one exchange of
//   two values between neighbouring threads). The residual is fetched before
//   the products. out may alias x: a thread reads
//   and writes the same elements, every read before the first write, and
//   launch B reads nothing else of x.
//
// What bounds it now (H100; PERF.md has the numbers): launch B's gather,
// about 45 instructions a value: launch B without it takes a quarter of its
// time, and of the rest the loads and the arithmetic each take about half,
// overlapping little; its time follows the warps that gather, which the
// ring does not raise, and not the instructions a value. Then launch A's
// loads of x, which the ring overlaps with its products.
//
// No float atomics and no split of K: the result is bit-identical from run to
// run, and a row's result does not depend on the rows of a stage. The plan
// (stages, rows per stage, loader and multiplying warps, column chunks,
// grid, shared memory) is
// made in ops/fused_block.py::fused_block_plan and only checked here. The
// device code K3's launches share with these (fused_entry_tc.cu) is in
// tc_core.cuh.
#include "tc_core.cuh"

namespace rubiks {

struct TcArgs {
  const bf16* x;      // A: the input. B: the residual
  const bf16* mid;    // B: the tensor the shift gathers
  bf16* dst;          // A: mid. B: out
  const bf16* w;      // (C, C) as (in, out)
  const float* vt;    // rows s1, b1, s2, b2, 3 * taps_n taps, [3 attention]
  const float* gate;  // B: nullptr or (N*T, C). A with SE: the partials
  int64_t M;
  int T, H, W, C, taps_n, K;
  int Kp;          // C rounded up to 16
  int a_rs, w_rs;  // row strides of the A tile and the W chunk, in elements
  int wn, bm, row_tiles;  // bm: the rows of a stage
  int lw;        // loader warps: warps [0, lw) build; the last wm * wn multiply
  int stages;    // operand stages of the ring
  int prefetch;  // the loaders ask L2 for the next tile's bytes
  int w_off, t_off;  // byte offsets of the W chunk and the table
  int vec;           // 16-byte global accesses are aligned
  // What tc_core.cuh reads through accessors: x, mid and out are C wide, and
  // vt holds s1, b1, s2, b2, the taps and (aq) the attention rows, C wide.
  __device__ __forceinline__ int kin() const { return C; }
  __device__ __forceinline__ int tab() const { return Kp; }
  __device__ __forceinline__ const float* s1() const { return vt; }
  __device__ __forceinline__ const float* b1() const { return vt + C; }
  __device__ __forceinline__ const float* s2() const { return vt + 2 * C; }
  __device__ __forceinline__ const float* b2() const { return vt + 3 * C; }
  __device__ __forceinline__ const float* taps() const {
    return vt + 4 * (int64_t)C;
  }
  __device__ __forceinline__ const float* aqw() const {
    return vt + (int64_t)(4 + 3 * taps_n) * C;
  }
};

// ---------------------------------------------------------------- launch B

// Where row m of the (N, T, H, W) grid lies.
__device__ __forceinline__ TcRow tc_row(const TcArgs& p, int m) {
  TcRow r;
  r.w = m % p.W;
  const int q = m / p.W;
  r.h = q % p.H;
  r.frame = q / p.H;
  r.t = r.frame % p.T;
  return r;
}

// A line of one lane's walk: each corner's source line, or the lane's own
// where the corner does not exist, and its weight (zero there).
struct LaneLine {
  const unsigned short* pc[2][2];
  float a[2][2];
  // S(col) as TcLine::sum sums it.
  __device__ __forceinline__ float sum(const unsigned short (&u)[2][2]) const {
    float s = 0.f;
#pragma unroll
    for (int dt = 0; dt < 2; ++dt)
#pragma unroll
      for (int dh = 0; dh < 2; ++dh)
        s = fmaf(a[dt][dh], bf16_bits_to_f32(u[dt][dh]), s);
    return s;
  }
};

// The corners of source column col. CHECK: zero where col lies off the
// line; else col lies on it.
template <bool CHECK>
__device__ __forceinline__ void lane_load(const TcArgs& p, const LaneLine& ln,
                                          int col,
                                          unsigned short (&u)[2][2]) {
  const bool in = !CHECK || (unsigned)col < (unsigned)p.W;
  const int xo = col * p.C;
#pragma unroll
  for (int dt = 0; dt < 2; ++dt)
#pragma unroll
    for (int dh = 0; dh < 2; ++dh)
      u[dt][dh] = in ? __ldg(ln.pc[dt][dh] + xo) : (unsigned short)0;
}

// The A tile of launch B. A unit of work is kTcRun consecutive rows of one
// 32-channel slab; a warp takes units in turn, a lane one channel. Consecutive
// rows are consecutive pixels of an image line, and the interpolation along W
// of pixel w + 1 starts where that of pixel w ended: the lane carries S(col),
// the interpolation along T and H at a source column, from one pixel to the
// next, so a pixel costs four loads, not eight, and its addresses are adds.
// The line's taps, bounds and pointers are set once per line, the columns go in
// batches of kTcBatch whose loads all start before the first multiply-add;
// a corner that does not exist keeps a pointer into the pixel's own line and
// a zero weight, so the loads of the columns inside the line take no
// predicate (3% off launch B). (Issuing every load of a run at once, with the
// predicates following each pixel, measured slower; so did lanes of four or
// eight channels, with a third of the instructions a value.)
__device__ __forceinline__ void build_shift_tile(const TcArgs& p, bf16* As,
                                                 int64_t m0, const int* table,
                                                 int tid, int nthreads,
                                                 int turn) {
  const int lane = tid & 31, warp = tid >> 5;
  const int nwarps = nthreads >> 5;
  const float* wts = reinterpret_cast<const float*>(table + 2 * p.Kp);
  const int slabs = (p.Kp + 31) >> 5;
  const int units = (p.bm / kTcRun) * slabs;
  // In turn: unit u of the block's tile `turn` is the warp's where turn *
  // units + u is, modulo the warps, so that no warp takes the surplus of
  // every tile.
  const int first = ((warp - turn * units) % nwarps + nwarps) % nwarps;
  for (int u = first; u < units; u += nwarps) {
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
        float ab[2][2];
        int off[2][2];
#pragma unroll
        for (int dt = 0; dt < 2; ++dt)
#pragma unroll
          for (int dh = 0; dh < 2; ++dh) {
            ab[dt][dh] = wa[0][dt] * wa[1][dh];
            off[dt][dh] = (dt * p.H + dh) * p.W * p.C;
          }
        while (r < nrows) {
          // A line: the pixels at.w .. at.w + seg - 1 of row (at.frame, at.h).
          const int seg = min(p.W - at.w, nrows - r);
          // A corner that does not exist (a clip or frame border, a zero
          // weight) reads the pixel's own line under a zero weight, so that
          // its loads need no predicate: fmaf(0, v, s) is s for the finite
          // v of mid, as a zero fill gives. Only a column off the line is
          // checked, and reads zero.
          const unsigned short* own = reinterpret_cast<const unsigned short*>(
              p.mid + ((int64_t)at.frame * p.H + at.h) * (int64_t)p.W * p.C +
              c);
          const unsigned short* q = reinterpret_cast<const unsigned short*>(
              p.mid + ((int64_t)(at.frame + ot) * p.H + (at.h + oh)) *
                          (int64_t)p.W * p.C + c);
          LaneLine ln;
#pragma unroll
          for (int dt = 0; dt < 2; ++dt)
#pragma unroll
            for (int dh = 0; dh < 2; ++dh) {
              const bool ok = wa[0][dt] != 0.f && wa[1][dh] != 0.f &&
                              (unsigned)(at.t + ot + dt) < (unsigned)p.T &&
                              (unsigned)(at.h + oh + dh) < (unsigned)p.H;
              ln.pc[dt][dh] = ok ? q + off[dt][dh] : own;
              ln.a[dt][dh] = ok ? ab[dt][dh] : 0.f;
            }
          const float gate =
              p.gate != nullptr
                  ? __ldg(p.gate + (int64_t)at.frame * p.C + c) : 1.f;
          const float w0 = wa[2][0] * gate, w1 = wa[2][1] * gate;
          const int x = at.w + ow;  // the first pixel's left source column
          unsigned short u0[2][2];
          lane_load<true>(p, ln, x, u0);
          float prev = ln.sum(u0);
          // Columns x + 1 + j, j in [jlo, jhi), lie inside the line.
          const int jlo = min(seg, max(0, -(x + 1)));
          const int jhi = max(jlo, min(seg, p.W - (x + 1)));
          int j = 0;
          for (; j < jlo; ++j) {
            lane_load<true>(p, ln, x + 1 + j, u0);
            const float sk = ln.sum(u0);
            dst[(r + j) * p.a_rs] = __float2bfloat16(fmaf(w1, sk, w0 * prev));
            prev = sk;
          }
          for (; j + kTcBatch <= jhi; j += kTcBatch) {
            unsigned short ub[kTcBatch][2][2];
#pragma unroll
            for (int k = 0; k < kTcBatch; ++k)
              lane_load<false>(p, ln, x + 1 + j + k, ub[k]);
#pragma unroll
            for (int k = 0; k < kTcBatch; ++k) {
              const float sk = ln.sum(ub[k]);
              dst[(r + j + k) * p.a_rs] =
                  __float2bfloat16(fmaf(w1, sk, w0 * prev));
              prev = sk;
            }
          }
          // The columns from jhi on, checked (as a lambda shared with the
          // first loop, these two measured 3-5% slower).
          for (; j < seg; ++j) {
            lane_load<true>(p, ln, x + 1 + j, u0);
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// An arrival that also waits for the thread's cp.async copies so far: it
// completes when they have landed.
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_addr(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One A tile by the `nthreads` loading threads.
// One A tile by the `nthreads` loading threads: the block's tile `turn`.
// Launch A's threads take their rows in a turn that moves by a row a tile.
template <int MODE>
__device__ __forceinline__ void build_tile(const TcArgs& p, bf16* As,
                                           int64_t m0, const int* table,
                                           int tid, int nthreads,
                                           int turn) {
  if (MODE == kTcOut) {
    build_shift_tile(p, As, m0, table, tid, nthreads, turn);
  } else if (p.vec) {
    const int tcs = min(p.Kp >> 3, nthreads);
    build_act_tile_vec<MODE == kTcMidAq || MODE == kTcMidAqSe>(
        p, As, m0, (int)((tid + (int64_t)turn * tcs) % nthreads), nthreads);
  } else {
    build_act_tile_scalar<MODE == kTcMidAq || MODE == kTcMidAqSe>(
        p, As, m0, tid, nthreads);
  }
}

// Rows [r0, r1) of a (M, C) matrix into L2 (clipped to [0, M)), by one bulk
// prefetch.
__device__ __forceinline__ void prefetch_rows(const bf16* a, int64_t r0,
                                              int64_t r1, int C, int64_t M) {
  r0 = max(r0, (int64_t)0);
  r1 = min(r1, M);
  if (r0 >= r1) return;
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a + r0 * C) & ~uintptr_t(15);
  const uintptr_t hi =
      (reinterpret_cast<uintptr_t>(a + r1 * C) + 15) & ~uintptr_t(15);
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(lo),
               "r"((unsigned)(hi - lo))
               : "memory");
}

// What the tile at m0 will read, into L2, a range a lane: launch A the rows
// of x (with aq, also a frame before and after), launch B the rows of mid
// that its taps reach (frames -K..K, lines and columns -K..K + 1 around the
// tile's) and its rows of x.
template <int MODE>
__device__ __forceinline__ void prefetch_tile(const TcArgs& p, int64_t m0,
                                              int lane) {
  const int64_t hw = (int64_t)p.H * p.W;
  if (MODE == kTcOut) {
    const int a = lane - p.K;
    if (a <= p.K) {
      const int64_t first = m0 + a * hw - (int64_t)p.K * (p.W + 1);
      prefetch_rows(p.mid, first,
                    m0 + p.bm + a * hw + (int64_t)(p.K + 1) * (p.W + 1),
                    p.C, p.M);
    } else if (a == p.K + 1) {
      prefetch_rows(p.x, m0, m0 + p.bm, p.C, p.M);
    }
  } else {
    const bool aq = MODE == kTcMidAq || MODE == kTcMidAqSe;
    if (lane < (aq ? 3 : 1)) {
      const int64_t off = aq ? (lane - 1) * hw : 0;
      prefetch_rows(p.x, m0 + off, m0 + off + p.bm, p.kin(), p.M);
    }
  }
}

// grid (persistent blocks over the row tiles, column chunks), block of
// kRingWarps warps: warps [0, lw) load, the last wm * wn multiply, and a
// warp in both does both. Shared memory: the ring's barriers, `stages`
// operand stages of bm x Kp, the W chunk (Kp x wn * 72) and the table. A
// block's i-th tile goes to stage i mod stages. A loader warp
// waits until the stage's previous tile has been released (its empty
// barrier), builds its share of the tile and arrives on the full barrier,
// one arrival a warp; a multiplying warp waits for W once, then for each
// tile's full barrier, multiplies, and arrives on its empty barrier right
// after its last fragment read. A warp in both roles builds up to stages - 1
// tiles ahead of the one it multiplies. The SE forms of launch A also build
// the gate's weight tables in the prologue and, once a tile's row warps have
// left their sums in shared memory (a barrier among the multiplying warps
// only), write the tile's partials (tc_se.cuh) before the next tile's sums
// may overwrite them (a second one).
template <int MODE>
__global__ void __launch_bounds__(kTcMaxThreads, 1)
    rubiks_tc_kernel(const TcArgs p) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(tc_smem);
  uint64_t* empty = full + kRingMaxStages;
  uint64_t* w_ready = empty + kRingMaxStages;
  bf16* ring = reinterpret_cast<bf16*>(tc_smem + kRingBarBytes);
  bf16* Ws = reinterpret_cast<bf16*>(tc_smem + p.w_off);
  int* table = reinterpret_cast<int*>(tc_smem + p.t_off);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * p.wn * kTcWarpCols;  // the chunk's first column
  const int nwarps = blockDim.x >> 5, nmw = (p.bm >> 4) * p.wn;
  const int first_mul = nwarps - nmw;
  const bool loads = warp < p.lw, mults = warp >= first_mul;
  const int nload = p.lw * 32;
  const int stage_elems = p.bm * p.a_rs;

  // The launches of a run depend on each other through x, mid and out, but
  // not through W and the taps: the next launch of the stream may begin as
  // SMs fall free and fetch those while this one still runs (programmatic
  // dependent launch), and every launch waits here, before it first touches
  // an activation, until the launch before it has finished and its writes are
  // visible. Without the launch attribute both instructions do nothing.
  asm volatile("griddepcontrol.launch_dependents;");
  load_w_rows(p, Ws, n0, p.w, 0, p.C, p.Kp);
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, p.lw);
      mbar_init(empty + s, nmw);
    }
    mbar_init(w_ready, blockDim.x);
  }
  __syncthreads();              // the barriers exist
  mbar_arrive_copies(w_ready);  // completes when this thread's copies land
  mbar_arrive(w_ready);         // and after its plain stores of zero rows
  if (MODE == kTcOut) build_tap_table(p, table);
  if constexpr (tc_se_mode(MODE)) tc_se_build_tables<1>(p, n0);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();

  const int ntiles =
      ((int)p.row_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
      (int)gridDim.x;
  // A warp that also multiplies builds stages - 1 tiles ahead of the one it
  // multiplies; one that only loads, as far as the stages let it.
  const int ahead = mults ? p.stages - 1 : ntiles;
  const int cw = warp - first_mul;
  const int wm_i = cw / p.wn, wn_i = cw - wm_i * p.wn;
  int ls = 0, ms = 0, lt = 0;  // the stages of tiles lt and mt
  unsigned lph = 0, mph = 0;   // the parities of those stages' uses
  for (int mt = 0;; ++mt) {
    if (loads) {
      for (; lt < ntiles && lt <= mt + ahead; ++lt) {
        if (p.prefetch && warp == 0 && lt + 1 < ntiles)
          prefetch_tile<MODE>(
              p, ((int64_t)blockIdx.x + (int64_t)(lt + 1) * gridDim.x) * p.bm,
              lane);
        if (lt >= p.stages) mbar_wait(empty + ls, lph ^ 1);
        build_tile<MODE>(p, ring + ls * stage_elems,
                         ((int64_t)blockIdx.x + (int64_t)lt * gridDim.x) *
                             p.bm,
                         table, tid, nload, lt);
        __syncwarp();
        if (lane == 0) mbar_arrive(full + ls);
        if (++ls == p.stages) ls = 0, lph ^= 1;
      }
    }
    if (!mults || mt >= ntiles) break;
    if (mt == 0) mbar_wait(w_ready, 0);
    const int64_t m0 = ((int64_t)blockIdx.x + (int64_t)mt * gridDim.x) * p.bm;
    mbar_wait(full + ms, mph);
    uint64_t* done = empty + ms;
    multiply_tile<MODE>(p, ring + ms * stage_elems, Ws, m0, n0, wm_i, wn_i,
                        lane, [done, lane] {
                          __syncwarp();
                          if (lane == 0) mbar_arrive(done);
                        });
    if constexpr (tc_se_mode(MODE)) {
      asm volatile("bar.sync 1, %0;" ::"r"(nmw * 32) : "memory");
      tc_se_store_partials<1>(p, m0, n0, tid - first_mul * 32, nmw * 32);
      asm volatile("bar.sync 1, %0;" ::"r"(nmw * 32) : "memory");
    }
    if (++ms == p.stages) ms = 0, mph ^= 1;
  }
  tc_cp_wait_all();
}

// ---------------------------------------------------------------- the host

bool tc_plan_ok(const RingPlan& p, const TcShape& s) {
  if (p.wm < 1 || p.wn < 1 || p.lw < 1 || p.stages < 1 ||
      p.stages > kRingMaxStages || p.lw > kRingWarps ||
      p.wm * p.wn > kRingWarps || p.lw + p.wm * p.wn < kRingWarps)
    return false;
  if (p.n_split < 1 || p.n_split > 65535 || p.grid_x < 1) return false;
  if (s.N < 0 || s.T < 1 || s.H < 1 || s.W < 1 || s.C < 1) return false;
  const int64_t tiles_n = (s.C + 7) / 8;
  const int64_t chunk = (int64_t)p.wn * kTcNT;
  if (p.n_split * chunk < tiles_n || (p.n_split - 1) * chunk >= tiles_n)
    return false;  // the chunks cover the columns, and none is empty
  if (p.smem_bytes != ring_smem_bytes(p, s.C) || p.smem_bytes > kTcMaxSmem)
    return false;
  if (s.taps_n < 1 || s.taps_n > kMaxTaps || s.K < 0 || s.K >= kTcBias)
    return false;
  const int64_t frame = (int64_t)s.H * s.W * s.C;
  if (frame * (s.K + 3) >= (int64_t(1) << 31)) return false;  // int offsets
  if ((int64_t)s.N * s.T * s.H * s.W >= (int64_t(1) << 31)) return false;
  return true;
}

template <int MODE>
cudaError_t tc_launch_kernel(const RingPlan& pl, const TcArgs& a,
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
  cfg.blockDim = dim3(kRingWarps * 32);
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
cudaError_t tc_launch(RingPlan pl, const TcShape& s, TcArgs a,
                      cudaStream_t stream, int se_slots = 0) {
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
  a.lw = pl.lw;
  a.stages = pl.stages;
  a.prefetch = pl.prefetch;
  a.w_off = kRingBarBytes + pl.stages * a.bm * a.a_rs * 2;
  a.t_off = a.w_off + a.Kp * a.w_rs * 2;
  const uintptr_t bits =
      reinterpret_cast<uintptr_t>(a.x) | reinterpret_cast<uintptr_t>(a.mid) |
      reinterpret_cast<uintptr_t>(a.dst) | reinterpret_cast<uintptr_t>(a.w) |
      reinterpret_cast<uintptr_t>(a.vt);
  a.vec = (s.C % 8 == 0) && (bits & 15) == 0;
  if (tc_se_mode(MODE)) {
    // The SE region takes the place of launch B's table, and more room
    // where it needs it.
    if (a.gate == nullptr || se_slots != tc_se_slots(a.bm, s.H * s.W))
      return cudaErrorInvalidValue;
    const int end = a.t_off + tc_se_bytes(s.taps_n, s.K, 1, pl.wm, pl.wn,
                                          se_slots);
    if (end > kTcMaxSmem) return cudaErrorInvalidValue;
    if (end > pl.smem_bytes) pl.smem_bytes = end;
  }
  return tc_launch_kernel<MODE>(pl, a, stream);
}

cudaError_t tc_launch_mid(const RingPlan& p, const TcShape& s, const void* x,
                          const float* vt, const void* w2, void* mid, int aq,
                          float* partial, int slots, cudaStream_t stream) {
  TcArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.mid = nullptr;
  a.dst = static_cast<bf16*>(mid);
  a.w = static_cast<const bf16*>(w2);
  a.vt = vt;
  a.gate = nullptr;
  if (partial != nullptr) {
    a.gate = partial;
    return aq ? tc_launch<kTcMidAqSe>(p, s, a, stream, slots)
              : tc_launch<kTcMidSe>(p, s, a, stream, slots);
  }
  return aq ? tc_launch<kTcMidAq>(p, s, a, stream)
            : tc_launch<kTcMid>(p, s, a, stream);
}

cudaError_t tc_launch_out(const RingPlan& p, const TcShape& s, const void* x,
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
