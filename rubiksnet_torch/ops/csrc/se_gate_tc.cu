// The SE gate of K2's and K3's tensor-core route: one launch per SE block,
// between launch A and launch B,
//
//   gate[n, t, c] = sigmoid(relu(m[n, t, :] . fc1) . fc2)[c]
//   m[n, t, c]    = sum_jt wT[jt, c] * S[n, t + jt - K, c] / (Ho * Wo)
//
// from the per-frame weighted sums S that launch A left as partials, one per
// (row tile, frame slot, channel) (tc_se.cuh). Replaces se_gate /
// se_conv3_batched of rubiksnet_tpu/ops/pallas/fused_block.py (also reached
// from fused_frames.py) and gate_from_mean of ops/pallas/fused_entry.py for
// bfloat16; float32 and the route "simt" keep se_gate.cuh's two launches,
// whose first pass reads all of mid again.
//
// What bounds it on the card: the bytes of the partials (a frame's tiles,
// read for each frame whose T taps reach it, mostly from L2) and of fc1 and
// fc2, read by every frame's block from L2; no pass over mid. At the small
// stages the chain of dependent steps, not the bytes, sets its time, so
// what does not depend on launch A is done before the wait for it. One
// block per frame, 12 warps:
//  0. fc1 into shared memory by 16-byte asynchronous copies, and fc2's rows
//     into L1, before the wait (fc1 where it fits: C * Cr floats beside the
//     rest).
//  1. S of the frames t + jt - K the taps reach: each channel's tiles are
//     cut into G = 384 / C contiguous ranges (G >= 1), a thread sums one
//     range in tile order, and the G range sums are added in range order;
//     then the T taps, as se_gate.cuh does.
//  2. fc1: warp w takes the channels [w C / 12, (w + 1) C / 12) and every
//     output j; its lanes read consecutive elements of fc1 (several
//     channels at once where Cr < 32: lane = channel offset * Cr + j), a
//     lane's channels in order, then lane j adds the lanes of its output in
//     lane order; the 12 warps' sums in warp order, then relu.
//  3. fc2 and the sigmoid, a thread per channel, its row of fc2 (stored
//     transposed, (C, Cr)) read 16 bytes at a time, all loads in flight.
// Everything is summed in an order fixed by the shape: every rerun is
// bit-identical. Programmatic dependent launch as K2's launches: launch B
// may begin (fetch its W) while this runs, and this waits for launch A's
// writes before it reads the partials.
#include "common.cuh"
#include "fused_block_tc.cuh"
#include "tc_core.cuh"

namespace rubiks {

namespace {

constexpr int kGateWarps = 12;

struct GateArgs {
  const float* partial;  // (row tiles, slots, C)
  const float* taps;     // the T tap row of the shift, (taps_n, C)
  const float* se;       // (2, C, Cr): fc1 as (C, Cr), fc2 transposed
  float* gate;           // (frames, C)
  int T, hw, bm, slots, C, Cr, taps_n, K;
  int G;                 // ranges of a channel's tiles in step 1
  int staged;            // fc1 is copied into shared memory
  int vec;               // se is 16-byte aligned
  float inv_count;       // 1 / (Ho * Wo)
};

__global__ void __launch_bounds__(kGateWarps * 32)
    se_gate_tc_kernel(const GateArgs a) {
  extern __shared__ __align__(16) float gate_smem[];
  const int n1 = a.staged ? a.C * a.Cr : 0;
  float* fc1s = gate_smem;                  // [C * Cr], if staged
  float* m = fc1s + ((n1 + 3) & ~3);        // [C]
  float* y1 = m + a.C;                      // [Cr]
  float* red2 = y1 + a.Cr;                  // [kGateWarps * Cr]
  float* red1 = red2 + kGateWarps * a.Cr;   // [G * taps_n * C]
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int frame = blockIdx.x, t = frame % a.T, clip0 = frame - t;
  const float* fc2t = a.se + (int64_t)a.C * a.Cr;
  asm volatile("griddepcontrol.launch_dependents;");
  if (a.staged) {  // 0. fc1, which launch A does not write
    for (int i = 4 * tid; i + 4 <= n1; i += 4 * nthreads)
      tc_cp16(fc1s + i, a.se + i);
    tc_cp_commit();
    for (int i = (n1 & ~3) + tid; i < n1; i += nthreads) fc1s[i] = a.se[i];
  }
  const float* fc1 = a.staged ? fc1s : a.se;
  // The rows of fc2 this thread reads in step 3, into L1 meanwhile.
  for (int c = tid; c < a.C; c += nthreads)
    for (int b = 0; b < a.Cr; b += 32)
      asm volatile("prefetch.global.L1 [%0];" ::"l"(fc2t + (int64_t)c * a.Cr +
                                                     b));
  asm volatile("griddepcontrol.wait;" ::: "memory");

  // 1. The frames' sums, each channel's tiles in G ranges.
  for (int i = tid; i < a.G * a.C; i += nthreads) {
    const int g = i / a.C, c = i - g * a.C;
    for (int jt = 0; jt < a.taps_n; ++jt) {
      const int ti = t + jt - a.K;
      float s = 0.f;
      if (ti >= 0 && ti < a.T && __ldg(a.taps + jt * a.C + c) != 0.f) {
        const int f = clip0 + ti;
        const int first = f * a.hw / a.bm;
        const int n = ((f + 1) * a.hw - 1) / a.bm - first + 1;
        int tile = first + g * n / a.G;
        const int end = first + (g + 1) * n / a.G;
        // The first tile of the frame may begin in an earlier frame; every
        // later one begins in this frame (slot 0).
        if (tile == first && tile < end) {
          const int slot = f - first * a.bm / a.hw;
          s = __ldg(a.partial + ((int64_t)tile * a.slots + slot) * a.C + c);
          ++tile;
        }
        const float* p = a.partial + (int64_t)tile * a.slots * a.C + c;
        const int64_t step = (int64_t)a.slots * a.C;
#pragma unroll 8
        for (; tile < end; ++tile, p += step) s += __ldg(p);
      }
      red1[(g * a.taps_n + jt) * a.C + c] = s;
    }
  }
  __syncthreads();
  for (int c = tid; c < a.C; c += nthreads) {
    float acc = 0.f;
    for (int jt = 0; jt < a.taps_n; ++jt) {
      const int ti = t + jt - a.K;
      const float wt = __ldg(a.taps + jt * a.C + c);
      if (ti < 0 || ti >= a.T || wt == 0.f) continue;
      float s = 0.f;
      for (int g = 0; g < a.G; ++g) s += red1[(g * a.taps_n + jt) * a.C + c];
      acc = fmaf(wt, s, acc);
    }
    m[c] = acc * a.inv_count;
  }
  tc_cp_wait_all();
  __syncthreads();

  // 2. fc1: warp w over its channel segment, lanes on consecutive elements.
  const int c_lo = warp * a.C / kGateWarps;
  const int c_hi = (warp + 1) * a.C / kGateWarps;
  if (a.Cr < 32) {
    const int rows = 32 / a.Cr;  // channels a pass of the warp reads
    const int c_sub = lane / a.Cr, j = lane - c_sub * a.Cr;
    float acc = 0.f;
    if (c_sub < rows) {
#pragma unroll 4
      for (int c = c_lo + c_sub; c < c_hi; c += rows)
        acc = fmaf(m[c], fc1[(int64_t)c * a.Cr + j], acc);
    }
    float total = 0.f;
    for (int k = 0; k < rows; ++k)
      total += __shfl_sync(0xffffffffu, acc, j + k * a.Cr);
    if (lane < a.Cr) red2[warp * a.Cr + lane] = total;
  } else {
    for (int j = lane; j < a.Cr; j += 32) {
      float acc = 0.f;
#pragma unroll 4
      for (int c = c_lo; c < c_hi; ++c)
        acc = fmaf(m[c], fc1[(int64_t)c * a.Cr + j], acc);
      red2[warp * a.Cr + j] = acc;
    }
  }
  __syncthreads();
  for (int j = tid; j < a.Cr; j += nthreads) {
    float s = 0.f;
    for (int w = 0; w < kGateWarps; ++w) s += red2[w * a.Cr + j];
    y1[j] = fmaxf(s, 0.f);
  }
  __syncthreads();

  // 3. fc2 and the sigmoid.
  for (int c = tid; c < a.C; c += nthreads) {
    const float* row = fc2t + (int64_t)c * a.Cr;
    float acc = 0.f;
    int j = 0;
    if (a.vec && (a.Cr & 3) == 0) {
      for (; j + 16 <= a.Cr; j += 16) {
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = __ldg(reinterpret_cast<const float4*>(row + j) + k);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          acc = fmaf(y1[j + 4 * k], v[k].x, acc);
          acc = fmaf(y1[j + 4 * k + 1], v[k].y, acc);
          acc = fmaf(y1[j + 4 * k + 2], v[k].z, acc);
          acc = fmaf(y1[j + 4 * k + 3], v[k].w, acc);
        }
      }
    }
    for (; j < a.Cr; ++j) acc = fmaf(y1[j], __ldg(row + j), acc);
    a.gate[(int64_t)frame * a.C + c] = 1.f / (1.f + expf(-acc));
  }
}

}  // namespace

cudaError_t se_gate_tc_launch(const float* partial, const float* taps_t,
                              const float* se, float* gate, int frames, int T,
                              int hw, int bm, int slots, int C, int Cr,
                              int taps_n, int K, float inv_count, int overlap,
                              cudaStream_t stream) {
  if (frames == 0) return cudaSuccess;
  if (frames < 0 || T < 1 || frames % T || hw < 1 || bm < 16 || C < 1 ||
      Cr < 1 || taps_n < 1 || K < 0 || slots != tc_se_slots(bm, hw) ||
      (int64_t)frames * hw >= (int64_t(1) << 31))
    return cudaErrorInvalidValue;
  GateArgs a = {partial, taps_t, se, gate, T, hw, bm, slots, C, Cr, taps_n,
                K, 0, 0, 0, inv_count};
  a.vec = (reinterpret_cast<uintptr_t>(se) & 15) == 0;
  const int nthreads = kGateWarps * 32;
  a.G = C < nthreads ? nthreads / C : 1;
  size_t smem = sizeof(float) * ((size_t)C + Cr + (size_t)kGateWarps * Cr +
                                 (size_t)a.G * taps_n * C);
  const size_t staged = sizeof(float) * (((size_t)C * Cr + 3) & ~3);
  a.staged = a.vec && smem + staged <= (size_t)kTcMaxSmem;
  if (a.staged) smem += staged;
  static bool raised[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= 64 || !raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        se_gate_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kTcMaxSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) raised[dev] = true;
  }
  if (smem > (size_t)kTcMaxSmem) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)frames);
  cfg.blockDim = dim3((unsigned)nthreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute early = {};
  early.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  early.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &early;
  cfg.numAttrs = overlap ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, se_gate_tc_kernel, a);
}

}  // namespace rubiks
