// Host interface of the tensor-core launches of K2 (fused_block_tc.cu), as
// fused_block.cu calls them.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rubiks {

// K2's launch plan, computed by ops/fused_block.py::fused_block_plan and
// checked again here (tc_plan_ok): nothing is chosen on this side.
struct RingPlan {
  int lw;          // loader warps, the block's first: they build the stages
  int stages;      // operand stages of the ring, 1 to kRingMaxStages
  int wm, wn;      // multiplying warps, the block's last, along the rows and
                   // along the columns: a stage holds wm * 16 rows, a block
                   // owns wn * 72 columns; a warp may load and multiply
  int n_split;     // column chunks (grid.y) of wn * 72 columns each
  int grid_x;      // persistent blocks along the row tiles
  int smem_bytes;  // dynamic shared memory of a block
  int overlap;     // a launch may begin (fetch its W) before the one before
                   // it in the stream has ended
  int prefetch;    // the loaders ask L2 for the next tile's bytes
};

// The plan of a launch of K3 (fused_entry_tc.cuh), made by
// ops/fused_entry.py::fused_entry_plan.
struct TcPlan {
  int pw;          // warps that only load (0: every warp loads and multiplies)
  int wm, wn;      // multiplying warps along the rows and along the columns:
                   // a block owns wm * 16 rows and wn * 72 columns
  int n_split;     // column chunks (grid.y) of wn * 72 columns each
  int grid_x;      // persistent blocks along the row tiles
  int smem_bytes;  // dynamic shared memory of a block
  int overlap;     // a launch may begin (fetch its W) before the one before
                   // it in the stream has ended
};

struct TcShape {
  int N, T, H, W, C;  // x, mid, out: (N, T, H, W, C) bfloat16
  int taps_n, K;      // taps per axis, tap j reads offset j - K
};

// Row stride, in elements, of a shared-memory tile `cols` bf16 wide: rows
// 16 bytes apart modulo 32 so that the eight rows of an ldmatrix hit eight
// different bank groups.
__host__ __device__ inline int tc_row_stride(int cols) {
  int rs = ((cols + 7) & ~7) + 8;
  if (((rs >> 3) & 1) == 0) rs += 8;
  return rs;
}

constexpr int kTcWarpCols = 72;  // columns of one warp: 9 tiles of 8
constexpr int kTcMaxSmem = 232448;  // bytes a block can use on the H100

constexpr int kRingMaxStages = 8;
constexpr int kRingWarps = 16;  // warps of a block of K2
// The ring's mbarriers, at the start of shared memory: a full and an empty
// one per stage and one for W, 8 bytes each, rounded up to 16.
constexpr int kRingBarBytes = (8 * (2 * kRingMaxStages + 1) + 15) & ~15;

// Bytes of dynamic shared memory K2's plan needs: the barriers, the stages
// (wm * 16 rows each), the W chunk and the loader's per-channel table (8
// words a channel).
inline int ring_smem_bytes(const RingPlan& p, int C) {
  const int kp = (C + 15) & ~15;
  return kRingBarBytes + p.stages * p.wm * 16 * tc_row_stride(kp) * 2 +
         kp * tc_row_stride(p.wn * kTcWarpCols) * 2 + 8 * kp * 4;
}

bool tc_plan_ok(const RingPlan& p, const TcShape& s);

// Launch A: mid = relu(s2 . (A @ W2) + b2), A = relu(s1 . x + b1), with aq
// mixed along T by the three attention rows that follow the taps in vt.
// partial: nullptr, or the SE gate's per-frame weighted sums of mid, (row
// tiles of wm * 16 rows, slots, C) float32 with slots = tc_se_slots(wm * 16,
// H * W)
// (tc_se.cuh).
cudaError_t tc_launch_mid(const RingPlan& p, const TcShape& s, const void* x,
                          const float* vt, const void* w2, void* mid, int aq,
                          float* partial, int slots, cudaStream_t stream);

// Launch B: out = x + ([gate .] shift3d(mid)) @ W3; out may alias x.
cudaError_t tc_launch_out(const RingPlan& p, const TcShape& s, const void* x,
                          const void* mid, const float* vt, const void* w3,
                          const float* gate, void* out, cudaStream_t stream);

// The SE gate (N*T = frames, C) float32 from launch A's partials
// (se_gate_tc.cu): taps_t the T tap row (taps_n, C), se (2, C, Cr) fc1 and
// fc2 transposed, hw the rows of a frame and bm the rows of a tile of
// launch A, inv_count 1 / (Ho * Wo). overlap: programmatic dependent launch.
cudaError_t se_gate_tc_launch(const float* partial, const float* taps_t,
                              const float* se, float* gate, int frames, int T,
                              int hw, int bm, int slots, int C, int Cr,
                              int taps_n, int K, float inv_count, int overlap,
                              cudaStream_t stream);

}  // namespace rubiks
