// K2: one stride-1 identity-shortcut RubiksNet block, inference.
//
//   x <- x + W3 . [SE] shift3d(relu(bn2(W2 . [AQ] relu(bn1(x)))))
//
// Replaces rubiksnet_tpu/ops/pallas/fused_block.py::fused_block_run and
// ops/pallas/fused_frames.py::fused_frames_run (the same function, scheduled
// for the TPU's VMEM: whole clips resident across a run of blocks, or one
// frame per grid step for 56x56 and larger), with their SE gate and, for
// fused_block_run, the rubiks3d-aq temporal mix. The Python wrapper calls
// this once per block of a run.
//
// What bounds it on the card: not the two 1x1 GEMMs (2*C^2 multiply-adds
// per element each, C = 72..576; tensor cores for them measured no faster)
// but the shift gather in launch B and the latency of the slab loads: about
// 5 element passes over device memory per block are far below the H100's
// bandwidth. Design, two launches on the caller's stream:
//   A: mid = relu(s2 . (relu(s1 . x + b1) @ W2) + b2), the common.cuh GEMM
//      with a bn1/relu A loader and a bn2/relu store. mid goes to device
//      memory in x's dtype (bf16 or f32), the buffer the caller passes (it
//      comes back from L2 for the small stages).
//   B: out = x + shift3d(mid) @ W3, the same GEMM whose A loader gathers the
//      shifted mid values with the per-axis tap weights (common.cuh
//      ShiftLoad: 8 corners per element for a fractional shift, 1 for a
//      quantized one) once per element, into the block's resident A tile,
//      and whose store adds the residual. out may alias x: each element of
//      x is read and written by the same thread, and launch B reads nothing
//      else of x.
// With aq, launch A's loader mixes the activated input along T with the
// three attention taps (common.cuh AqBnReluLoad: three reads of x per
// element, the neighbours from L2) and the T tap row is the identity. With
// se, two small launches between A and B compute the gate from one pass
// over mid (se_gate.cuh) and launch B's loader multiplies by it.
// The GEMM is SIMT FMA with f32 sums in both dtypes. The bn and tap
// arithmetic is f32 and the GEMM operands are rounded to x's dtype, as in
// the TPU kernel.
#include "common.cuh"
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

}  // namespace rubiks

extern "C" {

// One block. x, out (N, T, H, W, C) and mid (same shape) contiguous of dtype
// (0 float32, 1 bfloat16); out may equal x. vt: (4 + 3*taps_n [+ 3], C)
// float32 = folded bn1 scale/bias, bn2 scale/bias, the T, H and W tap
// weights (tap j reads offset j - K) and, when aq is set, the three rows of
// attention taps. w2, w3: (C, C) (in, out) of dtype. se: null, or (2, C, Cr)
// float32 (fc1, fc2 transposed) with scratch partial (N*T, slices, C) and
// gate (N*T, C) float32, slices = ceil(H / 8).
int rubiks_fused_block(const void* x, const float* vt, const void* w2,
                       const void* w3, const float* se, float* partial,
                       float* gate, void* mid, void* out, int dtype, int N,
                       int T, int H, int W, int C, int taps_n, int K, int aq,
                       int Cr, int slices, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rubiks::kBF16)
    return rubiks::fused_block<__nv_bfloat16>(x, vt, w2, w3, se, partial,
                                              gate, mid, out, N, T, H, W, C,
                                              taps_n, K, aq, Cr, slices, s);
  if (dtype == rubiks::kF32)
    return rubiks::fused_block<float>(x, vt, w2, w3, se, partial, gate, mid,
                                      out, N, T, H, W, C, taps_n, K, aq, Cr,
                                      slices, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
