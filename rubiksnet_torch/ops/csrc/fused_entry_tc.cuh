// Host interface of the tensor-core launches of K3 (fused_entry_tc.cu), as
// fused_entry.cu calls them. The plan of each launch is a TcPlan
// (fused_block_tc.cuh), made by ops/fused_entry.py::fused_entry_plan and
// checked again here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_block_tc.cuh"

namespace rubiks {

struct EntryShape {
  int N, T, H, W;  // x (N, T, H, W, Cin), mid (N, T, H, W, Cm), H, W even
  int Cin, Cm;     // out (N, T, H/2, W/2, Cm), all bfloat16
  int taps_n, K;   // taps per axis, tap j reads offset j - K
};

// Bytes of dynamic shared memory a launch of K3 needs: the A tile of `depth`
// columns (two with loading warps), the W chunk of as many rows, and the
// gather's table of 8 words for each of `table_c` channels (launch B: Cm;
// launch A has none). Both rounded up to 16.
inline int entry_smem_bytes(const TcPlan& p, int depth, int table_c) {
  const int kp = (depth + 15) & ~15;
  const int kt = (table_c + 15) & ~15;
  return (p.pw > 0 ? 2 : 1) * p.wm * 16 * tc_row_stride(kp) * 2 +
         kp * tc_row_stride(p.wn * kTcWarpCols) * 2 + 8 * kt * 4;
}

// Launch A: mid = relu(s2 . ([AQ] relu(s1 . x + b1) @ W2) + b2) over the
// full-resolution grid. vt1: (2, Cin) s1, b1, with aq (5, Cin): then the
// three attention rows, which mix the activated input over frames t - 1, t,
// t + 1 (zero outside the clip) in float32 before the operand is rounded;
// vt2: (2 + 3 * taps_n, Cm) s2, b2 and the taps; W2 (Cin, Cm). partial:
// nullptr, or the SE gate's per-frame weighted sums of mid for the stride-2
// shift, (row tiles, slots, Cm) float32 with slots = tc_se_slots(wm * 16,
// H * W) (tc_se.cuh); not with aq.
cudaError_t entry_tc_launch_mid(const TcPlan& p, const EntryShape& s,
                                const void* x, const float* vt1,
                                const float* vt2, const void* w2, void* mid,
                                int aq, float* partial, int slots,
                                cudaStream_t stream);

// Where launch B holds its weights in column chunks, the gather pre-pass: the
// rows of launch B's A operand, [gate .] shift3d_s2(mid) then relu(s1 . x +
// b1)[::2, ::2] then zeros up to Cm + Cin rounded to 16, into `stage` (at
// least N*T*(H/2)*(W/2) rows rounded up to `rows`), once, so that the chunks
// copy them instead of each gathering them again. `rows` per tile, a
// multiple of 16; 16 warps a block; `smem_bytes` the table's: 32 bytes for
// each of Cm rounded up to 16 channels.
cudaError_t entry_tc_launch_gather(int rows, int grid_x, int smem_bytes,
                                   int overlap, const EntryShape& s,
                                   const void* x, const void* mid,
                                   const float* vt1, const float* vt2,
                                   const float* gate, void* stage,
                                   cudaStream_t stream);

// Launch B: out = ([gate .] shift3d_s2(mid)) @ W3 + relu(s1 . x + b1)[::2,
// ::2] @ Wsc over the (N, T, H/2, W/2) grid. W3 (Cm, Cm), Wsc (Cin, Cm),
// gate nullptr or (N*T, Cm) float32. stage: nullptr (the launch gathers its
// operand itself) or the gather pre-pass's rows, copied instead (its plan
// then has no table).
cudaError_t entry_tc_launch_out(const TcPlan& p, const EntryShape& s,
                                const void* x, const void* mid,
                                const float* vt1, const float* vt2,
                                const void* w3, const void* wsc,
                                const float* gate, const void* stage,
                                void* out, cudaStream_t stream);

}  // namespace rubiks
