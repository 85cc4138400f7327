// K3: one stride-2 stage-entry RubiksNet block with channel growth,
// inference.
//
//   a   = relu(bn1(x))                                   (N, T, H, W, Cin)
//   out = W3 . [SE] shift3d_s2(relu(bn2(W2 . a))) + Wsc . a[:, :, ::2, ::2]
//
// Replaces rubiksnet_tpu/ops/pallas/fused_entry.py::fused_entry_run, with
// its SE gate on the decimated activation. The shift at stride (1, 2, 2), pad 0, is the stride-1 shift
// sampled at (2h', 2w'); the TPU kernel's W de-interleave and parity-split
// H were workarounds for Mosaic's lack of strided slices, and a strided
// read replaces both here.
//
// What bounds it on the card: the GEMMs (Cin*mid multiply-adds per input
// element for W2, (mid + Cin)*mid per output element for W3 and Wsc) and
// the full-resolution input and mid passes. Design, two launches on the
// caller's stream, both the common.cuh GEMM:
//   A: mid = relu(s2 . (relu(s1 . x + b1) @ W2) + b2) over the full-
//      resolution grid (every mid cell is read by some shift tap for
//      K >= 1), stored in x's dtype in the caller's buffer.
//   B: over the (N, T, H/2, W/2) output grid, one K loop of length
//      mid + Cin: k < mid gathers the stride-2 shifted mid against W3,
//      k >= mid reads relu(bn1(x)) at (2h', 2w') against Wsc, so the
//      strided shortcut is a second K range of the same accumulator instead
//      of an identity residual.
// With se, two small launches between A and B compute the gate from one
// pass over mid (se_gate.cuh, the mean over the decimated (H/2, W/2) grid)
// and B's shift gather multiplies by it; the shortcut range is not gated.
#include "common.cuh"
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
                int taps_n, int K, int Cr, int slices, cudaStream_t stream) {
  const int Ho = H / 2, Wo = W / 2;
  const int64_t M = (int64_t)N * T_ * H * W;
  const int64_t Mo = (int64_t)N * T_ * Ho * Wo;
  if (Mo == 0) return 0;
  if (taps_n > kMaxTaps || M >= (int64_t(1) << 31))
    return (int)cudaErrorInvalidValue;
  if (se != nullptr && (partial == nullptr || gate == nullptr))
    return (int)cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xv);
  T* mid = static_cast<T*>(midv);
  const float* s1 = vt1;
  const float* b1 = vt1 + Cin;
  const float* s2 = vt2;
  const float* b2 = vt2 + Cm;
  const float* taps = vt2 + 2 * Cm;
  cudaError_t err =
      launch_gemm<T>(M, Cm, Cin, BnReluLoad<T>{x, s1, b1, Cin},
                  WeightLoad<T>{static_cast<const T*>(w2v), Cm},
                  BnReluStore<T>{mid, s2, b2, Cm}, stream);
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

}  // namespace rubiks

extern "C" {

// x (N, T, H, W, Cin) with H, W even, mid (N, T, H, W, Cm) and out
// (N, T, H/2, W/2, Cm) contiguous of dtype (0 float32, 1 bfloat16).
// vt1: (2, Cin) float32 folded bn1; vt2: (2 + 3*taps_n, Cm) float32 folded
// bn2 then the T, H, W tap weights. w2, wsc: (Cin, Cm), w3: (Cm, Cm), of
// dtype, (in, out). se: null, or (2, Cm, Cr) float32 (fc1, fc2 transposed)
// with scratch partial (N*T, slices, Cm) and gate (N*T, Cm) float32,
// slices = ceil(H / 8).
int rubiks_fused_entry(const void* x, const float* vt1, const float* vt2,
                       const void* w2, const void* w3, const void* wsc,
                       const float* se, float* partial, float* gate,
                       void* mid, void* out, int dtype, int N, int T, int H,
                       int W, int Cin, int Cm, int taps_n, int K, int Cr,
                       int slices, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rubiks::kBF16)
    return rubiks::fused_entry<__nv_bfloat16>(x, vt1, vt2, w2, w3, wsc, se,
                                              partial, gate, mid, out, N, T,
                                              H, W, Cin, Cm, taps_n, K, Cr,
                                              slices, s);
  if (dtype == rubiks::kF32)
    return rubiks::fused_entry<float>(x, vt1, vt2, w2, w3, wsc, se, partial,
                                      gate, mid, out, N, T, H, W, Cin, Cm,
                                      taps_n, K, Cr, slices, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
