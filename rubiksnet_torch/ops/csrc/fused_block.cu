// K2: a run of stride-1 identity-shortcut RubiksNet blocks, inference.
//
//   x <- x + W3 . [SE] shift3d(relu(bn2(W2 . [AQ] relu(bn1(x)))))
//
// Replaces rubiksnet_tpu/ops/pallas/fused_block.py::fused_block_run and
// ops/pallas/fused_frames.py::fused_frames_run (the same function, scheduled
// for the TPU's VMEM: whole clips resident across a run of blocks, or one
// frame per grid step for 56x56 and larger), with their SE gate and, for
// fused_block_run, the rubiks3d-aq temporal mix. The Python wrapper calls
// rubiks_fused_block_run once per run; every launch of the run is made
// here, on the caller's stream.
//
// Per block, two launches:
//   A: mid = relu(s2 . (relu(s1 . x + b1) @ W2) + b2). mid goes to device
//      memory in x's dtype, the buffer the caller passes (it comes back from
//      L2 for the small stages).
//   B: out = x + shift3d(mid) @ W3: the operand loader gathers the shifted
//      mid values with the per-axis tap weights (8 corners per element for a
//      fractional shift, 1 for a quantized one), and the store adds the
//      residual. out may alias x: each element of x is read and written by
//      the same thread, and launch B reads nothing else of x.
// With aq, launch A's loader mixes the activated input along T with the
// three attention taps and the T tap row is the identity. With se, launch
// B's loader multiplies by the gate: in bfloat16 launch A sums its weighted
// values per frame as it stores mid (tc_se.cuh) and one launch makes the gate
// from those sums (se_gate_tc.cu); in float32 two small launches compute it
// from one pass over mid (se_gate.cuh). The bn and
// tap arithmetic is f32 and the GEMM operands are rounded to x's dtype, as in
// the TPU kernel.
//
// One route per dtype. bfloat16, the serving dtype, runs fused_block_tc.cu:
// tensor-core products, resident weights, 16-byte loads, a gather of one
// channel per lane; its header says what bounds it. float32 runs the
// common.cuh GEMM below (SIMT f32 products: tensor cores would make them
// TF32). (Cutting a run into groups of clips, A then B per group so that mid
// stays in L2, measured slower at every batch: more and smaller launches.)
#include "common.cuh"
#include "fused_block_tc.cuh"
#include "se_gate.cuh"

namespace rubiks {

template <class T>
struct ResidualStore {
  const T* x;
  T* out;
  int N;
  __device__ __forceinline__ void operator()(int64_t m, int n,
                                             float acc) const {
    const int64_t i = m * N + n;
    out[i] = from_f32<T>(to_f32(x[i]) + acc);
  }
};

template <class T>
int fused_block(const void* xv, const float* vt, const void* w2v,
                const void* w3v, const float* se, float* partial, float* gate,
                void* midv, void* outv, int N, int T_, int H, int W, int C,
                int taps_n, int K, int aq, int Cr, int slices,
                cudaStream_t stream) {
  const int64_t M = (int64_t)N * T_ * H * W;
  if (M == 0) return 0;
  if (taps_n > kMaxTaps || M >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  if (se != nullptr && (partial == nullptr || gate == nullptr))
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* mid = static_cast<T*>(midv);
  T* out = static_cast<T*>(outv);
  const float* s1 = vt;
  const float* b1 = vt + C;
  const float* s2 = vt + 2 * C;
  const float* b2 = vt + 3 * C;
  const float* taps = vt + 4 * C;
  const float* aw = taps + 3 * taps_n * C;  // the AQ rows follow the taps
  const WeightLoad<T> w2{static_cast<const T*>(w2v), C};
  const BnReluStore<T> store{mid, s2, b2, C};
  cudaError_t err =
      aq ? launch_gemm<T>(M, C, C,
                          AqBnReluLoad<T>{x, s1, b1, aw, C, T_, H * W}, w2,
                          store, stream)
         : launch_gemm<T>(M, C, C, BnReluLoad<T>{x, s1, b1, C}, w2, store,
                          stream);
  if (err != cudaSuccess) return (int)err;
  if (se != nullptr) {
    err = launch_se_gate<T>(mid, taps, se, partial, gate, N * T_, T_, H, W, C,
                            H, W, 1, taps_n, K, Cr, slices, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)launch_gemm<T>(
      M, C, C,
      ShiftLoad<T>{mid, taps, T_, H, W, C, H, W, 1, taps_n, K,
                   se != nullptr ? gate : nullptr},
      WeightLoad<T>{static_cast<const T*>(w3v), C},
      ResidualStore<T>{x, out, C}, stream);
}

// One block on the tensor-core route (bfloat16 only). With se, launch A
// also leaves the gate's per-frame sums in partial (tc_se.cuh), and one
// launch turns them into the gate (se_gate_tc.cu).
int fused_block_tc(const TcPlan& plan, const void* x, const float* vt,
                   const void* w2, const void* w3, const float* se,
                   float* partial, float* gate, void* mid, void* out, int N,
                   int T_, int H, int W, int C, int taps_n, int K, int aq,
                   int Cr, int slots, cudaStream_t stream) {
  if (N == 0) return 0;
  if (se != nullptr && (partial == nullptr || gate == nullptr))
    return (int)cudaErrorInvalidValue;
  const TcShape shape = {N, T_, H, W, C, taps_n, K};
  cudaError_t err =
      tc_launch_mid(plan, shape, x, vt, w2, mid, aq,
                    se != nullptr ? partial : nullptr, slots, stream);
  if (err != cudaSuccess) return (int)err;
  if (se != nullptr) {
    err = se_gate_tc_launch(partial, vt + 4 * C, se, gate, N * T_, T_, H * W,
                            plan.wm * 16, slots, C, Cr, taps_n, K,
                            1.f / ((float)H * (float)W), plan.overlap,
                            stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)tc_launch_out(plan, shape, x, mid, vt, w3,
                            se != nullptr ? gate : nullptr, out, stream);
}

}  // namespace rubiks

extern "C" {

// A run of B blocks. x, out (N, T, H, W, C) and mid (same shape) contiguous
// of dtype (0 float32, 1 bfloat16); block 0 reads x and writes out, the later
// blocks update out in place; out may equal x. vt: (B, 4 + 3*taps_n
// [+ 3], C) float32 = per block the folded bn1 scale/bias, bn2 scale/bias,
// the T, H and W tap weights (tap j reads offset j - K) and, when aq is set,
// the three rows of attention taps. wm: (B, 2, C, C) of dtype, W2 and W3 as
// (in, out). se: null, or (B, 2, C, Cr) float32 (fc1, fc2 transposed) with
// scratch partial and gate (N*T, C) float32; partial is (N*T, slices, C),
// slices = ceil(H / 8), in float32 (se_gate.cuh's pass over mid) and (row
// tiles, slices, C), slices = tc_se_slots(wm_ * 16, H * W), in bfloat16
// (launch A's sums, tc_se.cuh). float32 runs the common.cuh GEMM, bfloat16
// the tensor-core kernels under the plan pw, wm_, wn_, n_split, grid_x,
// smem_bytes, overlap of ops/fused_block.py::fused_block_plan.
int rubiks_fused_block_run(const void* x, const float* vt, const void* wm,
                           const float* se, float* partial, float* gate,
                           void* mid, void* out, int dtype, int B, int N,
                           int T, int H, int W, int C, int taps_n, int K,
                           int aq, int Cr, int slices, int pw, int wm_,
                           int wn_, int n_split, int grid_x, int smem_bytes,
                           int overlap, void* stream) {
  using namespace rubiks;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return (int)cudaErrorInvalidValue;
  if (B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const TcPlan plan = {pw,      wm_,    wn_,        n_split,
                       grid_x,  smem_bytes, overlap};
  const size_t esz = dtype == kBF16 ? 2 : 4;
  const int rows = 4 + 3 * taps_n + (aq ? 3 : 0);
  for (int b = 0; b < B; ++b) {
    const void* src = b == 0 ? x : out;
    const float* vtb = vt + (size_t)b * rows * C;
    const char* w2 = static_cast<const char*>(wm) + (size_t)b * 2 * C * C * esz;
    const char* w3 = w2 + (size_t)C * C * esz;
    const float* seb = se != nullptr ? se + (size_t)b * 2 * C * Cr : nullptr;
    int rc;
    if (dtype == kBF16)
      rc = fused_block_tc(plan, src, vtb, w2, w3, seb, partial, gate, mid, out,
                          N, T, H, W, C, taps_n, K, aq, Cr, slices, s);
    else
      rc = fused_block<float>(src, vtb, w2, w3, seb, partial, gate, mid, out,
                              N, T, H, W, C, taps_n, K, aq, Cr, slices, s);
    if (rc != 0) return rc;
  }
  return 0;
}

}  // extern "C"
