// K3: one stride-2 stage-entry RubiksNet block with channel growth,
// inference.
//
//   a   = relu(bn1(x))                                   (N, T, H, W, Cin)
//   out = W3 . [SE] shift3d_s2(relu(bn2(W2 . [AQ] a))) + Wsc . a[:, :, ::2, ::2]
//
// Replaces rubiksnet_tpu/ops/pallas/fused_entry.py::fused_entry_run, with
// its SE gate on the decimated activation. With aq (the rubiks3d-aq
// variant, whose entries are XLA compositions in the JAX package) launch A's
// loader mixes a along T with the three attention taps, as K2's does, and
// the shift is 2D: the T tap row is the identity. The shortcut reads a
// unmixed. aq takes no SE gate. The shift at stride (1, 2, 2), pad
// 0, is the stride-1 shift sampled at (2h', 2w'); the TPU kernel's W
// de-interleave and parity-split H were workarounds for Mosaic's lack of
// strided slices, and a strided read replaces both here.
//
// Two launches on the caller's stream:
//   A: mid = relu(s2 . (relu(s1 . x + b1) @ W2) + b2) over the full-
//      resolution grid (every mid cell is read by some shift tap for
//      K >= 1), stored in x's dtype in the caller's buffer.
//   B: over the (N, T, H/2, W/2) output grid, one K loop of length
//      mid + Cin: k < mid gathers the stride-2 shifted mid against W3,
//      k >= mid reads relu(bn1(x)) at (2h', 2w') against Wsc, so the
//      strided shortcut is a second K range of the same accumulator instead
//      of an identity residual.
// With se, B's shift gather multiplies by the gate (the mean over the
// decimated (H/2, W/2) grid); the shortcut range is not gated. On the
// tensor-core route launch A sums the gate's weighted values per frame
// (tc_se.cuh) and one launch makes the gate (se_gate_tc.cu); on the SIMT
// route two small launches compute it from one pass over mid (se_gate.cuh).
//
// Two routes, as K2 has. bfloat16, the serving dtype, runs fused_entry_tc.cu
// (tensor-core products, resident weights, 16-byte loads; its header says
// how). float32 runs the common.cuh GEMM below (SIMT f32 products: tensor
// cores would make them TF32), which also stays callable for bfloat16 as
// route 0 so that both can be timed in one process.
#include "common.cuh"
#include "fused_entry_tc.cuh"
#include "se_gate.cuh"

namespace rubiks {

template <class T>
struct EntryLoad {
  using Shared = ShiftShared;
  ShiftLoad<T> shift;  // k < mid
  const T* x;          // k >= mid: relu(s1 . x + b1) at (t, 2h', 2w')
  const float* s1;
  const float* b1;
  int Cin;
  __device__ __forceinline__ void rows(Shared& sh, int64_t m0,
                                       int64_t M) const {
    shift.rows(sh, m0, M);
  }
  __device__ __forceinline__ void slab(Shared& sh, int k0) const {
    shift.slab(sh, k0);
  }
  __device__ __forceinline__ float operator()(const Shared& sh, int mm,
                                              int64_t m, int kk,
                                              int k) const {
    if (k < shift.C) return shift(sh, mm, m, kk, k);
    const int kc = k - shift.C;
    const int64_t row =
        (int64_t)((sh.nt[mm] + sh.t[mm]) * shift.H + sh.h[mm]) * shift.W +
        sh.w[mm];
    const float v = fmaf(__ldg(s1 + kc), to_f32(x[row * Cin + kc]),
                         __ldg(b1 + kc));
    return round_to<T>(fmaxf(v, 0.f));
  }
};

template <class T>
struct EntryWeightLoad {
  const T* w3;   // (mid, mid)
  const T* wsc;  // (Cin, mid)
  int mid;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return k < mid ? to_f32(w3[(int64_t)k * mid + n])
                   : to_f32(wsc[(int64_t)(k - mid) * mid + n]);
  }
};

template <class T>
struct PlainStore {
  T* out;
  int N;
  __device__ __forceinline__ void operator()(int64_t m, int n,
                                             float acc) const {
    out[m * N + n] = from_f32<T>(acc);
  }
};

template <class T>
int fused_entry(const void* xv, const float* vt1, const float* vt2,
                const void* w2v, const void* w3v, const void* wscv,
                const float* se, float* partial, float* gate, void* midv,
                void* outv, int N, int T_, int H, int W, int Cin, int Cm,
                int taps_n, int K, int Cr, int slices, int aq,
                cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int64_t M = (int64_t)N * T_ * H * W;
  const int64_t Mo = (int64_t)N * T_ * Ho * Wo;
  if (Mo == 0) return 0;
  if (taps_n > kMaxTaps || M >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  if (se != nullptr && (partial == nullptr || gate == nullptr || aq))
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* mid = static_cast<T*>(midv);
  const float* s1 = vt1;
  const float* b1 = vt1 + Cin;
  const float* aw = vt1 + 2 * Cin;  // the AQ rows follow s1 and b1
  const float* s2 = vt2;
  const float* b2 = vt2 + Cm;
  const float* taps = vt2 + 2 * Cm;
  const WeightLoad<T> w2{static_cast<const T*>(w2v), Cm};
  const BnReluStore<T> store{mid, s2, b2, Cm};
  cudaError_t err =
      aq ? launch_gemm<T>(M, Cm, Cin,
                          AqBnReluLoad<T>{x, s1, b1, aw, Cin, T_, H * W}, w2,
                          store, stream)
         : launch_gemm<T>(M, Cm, Cin, BnReluLoad<T>{x, s1, b1, Cin}, w2,
                          store, stream);
  if (err != cudaSuccess) return (int)err;
  if (se != nullptr) {
    err = launch_se_gate<T>(mid, taps, se, partial, gate, N * T_, T_, H, W,
                            Cm, Ho, Wo, 2, taps_n, K, Cr, slices, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const ShiftLoad<T> shift{mid, taps, T_, H, W, Cm, Ho, Wo, 2, taps_n, K,
                           se != nullptr ? gate : nullptr};
  return (int)launch_gemm<T>(Mo, Cm, Cm + Cin, EntryLoad<T>{shift, x, s1, b1, Cin},
                          EntryWeightLoad<T>{static_cast<const T*>(w3v),
                                             static_cast<const T*>(wscv), Cm},
                          PlainStore<T>{static_cast<T*>(outv), Cm}, stream);
}

// The entry on the tensor-core route (bfloat16 only): launch A under plan a
// (with aq the attention mix in its loader; with se, leaving the gate's
// per-frame sums in partial, tc_se.cuh), the
// gate (se_gate_tc.cu), the gather pre-pass where g_rows > 0, launch B under
// plan b.
int fused_entry_tc(const TcPlan& a, const TcPlan& b, int g_rows, int g_grid,
                   int g_smem, const void* x, const float* vt1,
                   const float* vt2, const void* w2, const void* w3,
                   const void* wsc, const float* se, float* partial,
                   float* gate, void* stage, void* mid, void* out, int N,
                   int T_, int H, int W, int Cin, int Cm, int taps_n, int K,
                   int Cr, int slices, int aq, cudaStream_t stream) {
  if (N == 0) return 0;
  if (se != nullptr && (partial == nullptr || gate == nullptr))
    return (int)cudaErrorInvalidValue;
  const EntryShape shape = {N, T_, H, W, Cin, Cm, taps_n, K};
  cudaError_t err =
      entry_tc_launch_mid(a, shape, x, vt1, vt2, w2, mid, aq,
                          se != nullptr ? partial : nullptr, slices, stream);
  if (err != cudaSuccess) return (int)err;
  const float* g = se != nullptr ? gate : nullptr;
  if (se != nullptr) {
    err = se_gate_tc_launch(partial, vt2 + 2 * Cm, se, gate, N * T_, T_,
                            H * W, a.wm * 16, slices, Cm, Cr, taps_n, K,
                            1.f / ((float)(H / 2) * (float)(W / 2)),
                            a.overlap, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (g_rows > 0) {
    err = entry_tc_launch_gather(g_rows, g_grid, g_smem, b.overlap, shape, x,
                                 mid, vt1, vt2, g, stage, stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)entry_tc_launch_out(b, shape, x, mid, vt1, vt2, w3, wsc, g,
                                  g_rows > 0 ? stage : nullptr, out, stream);
}

}  // namespace rubiks

extern "C" {

// x (N, T, H, W, Cin) with H, W even, mid (N, T, H, W, Cm) and out
// (N, T, H/2, W/2, Cm) contiguous of dtype (0 float32, 1 bfloat16).
// vt1: (2, Cin) float32 folded bn1, and when aq is set (5, Cin): then the
// three rows of attention taps. vt2: (2 + 3*taps_n, Cm) float32 folded bn2
// then the T, H, W tap weights (with aq the T row is the identity). w2, wsc:
// (Cin, Cm), w3: (Cm, Cm), of dtype, (in, out). se: null, or (2, Cm, Cr)
// float32 (fc1, fc2 transposed) with scratch partial and gate (N*T, Cm)
// float32; partial is (N*T, slices, Cm), slices = ceil(H / 8), on route 0
// (se_gate.cuh's pass over mid) and (launch A's row tiles, slices, Cm),
// slices = tc_se_slots(A's wm * 16, H * W), on route 1 (tc_se.cuh); se must
// be null with aq. route: 0 the common.cuh GEMM (either dtype; plan and
// stage unused), 1 the tensor-core kernels (bfloat16 only) under plan,
// 16 ints of ops/fused_entry.py::fused_entry_plan: launch A's (pw, wm, wn,
// n_split, grid_x, smem_bytes), launch B's, the gather pre-pass's (rows,
// grid_x, smem_bytes; rows 0: none) and overlap. stage: with the pre-pass,
// bfloat16 scratch of N*T*(H/2)*(W/2) rows rounded up to both launches'
// rows per tile, (Cm + Cin rounded up to 16) each.
int rubiks_fused_entry(const void* x, const float* vt1, const float* vt2,
                       const void* w2, const void* w3, const void* wsc,
                       const float* se, float* partial, float* gate,
                       void* mid, void* out, int dtype, int N, int T, int H,
                       int W, int Cin, int Cm, int taps_n, int K, int Cr,
                       int slices, int aq, int route, const int* plan,
                       void* stage, void* stream) {
  using namespace rubiks;
  auto s = static_cast<cudaStream_t>(stream);
  if ((route != 0 && route != 1) || (route == 1 && dtype != kBF16))
    return (int)cudaErrorInvalidValue;
  if (route == 1) {
    if (plan == nullptr) return (int)cudaErrorInvalidValue;
    const int* pa = plan;
    const int* pb = plan + 6;
    const int* pg = plan + 12;
    const int overlap = plan[15];
    const TcPlan a = {pa[0], pa[1], pa[2], pa[3], pa[4], pa[5], overlap};
    const TcPlan b = {pb[0], pb[1], pb[2], pb[3], pb[4], pb[5], overlap};
    return fused_entry_tc(a, b, pg[0], pg[1], pg[2], x, vt1, vt2, w2, w3, wsc,
                          se, partial, gate, stage, mid, out, N, T, H, W, Cin,
                          Cm, taps_n, K, Cr, slices, aq, s);
  }
  if (dtype == kBF16)
    return fused_entry<__nv_bfloat16>(x, vt1, vt2, w2, w3, wsc, se, partial,
                                      gate, mid, out, N, T, H, W, Cin, Cm,
                                      taps_n, K, Cr, slices, aq, s);
  if (dtype == kF32)
    return fused_entry<float>(x, vt1, vt2, w2, w3, wsc, se, partial, gate,
                              mid, out, N, T, H, W, Cin, Cm, taps_n, K, Cr,
                              slices, aq, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
