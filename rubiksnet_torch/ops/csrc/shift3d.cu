// K1: the fractional 3D shift forward, one pass; and K1-inverse, its input
// gradient, one pass.
//
// K1 replaces rubiksnet_tpu/ops/pallas/shift_kernel.py::rubiks_shift3d_pallas
// (forward) and, at stride (1, 2, 2), ops/pallas/fused_shift3d.py::
// rubiks_shift_3d_fused. out[n, t', h', w', c] is the trilinear interpolation
// of x at (t'*sT - pT + shiftT[c], h'*sH - pH + shiftH[c], w'*sW - pW +
// shiftW[c]) with zero fill outside x; quantize 1 reads the one corner whose
// per-axis remainder rounds half up (remainder < 0.5 -> floor), quantize 2
// the corner at the coordinate rounded half away from zero. With T = 1 and
// a zero T row both kernels are the 2D shift (rubiksnet_tpu/ops/shift2d.py,
// which calls the same TPU kernel so), whose quantize rule is the second.
//
// K1-inverse replaces rubiks_shift3d_pallas(inverse=True), which covered
// stride 1 only, and the XLA inverse shift of the strided entry blocks
// (rubiksnet_tpu/ops/shift3d.py::rubiks_shift_3d_input_grad). gx[n, t, h, w,
// c] sums, over the 2x2x2 corners of the negated shift, og at output
// position j / stride per axis, where j = i + pad + floor(-s) + {0, 1} is a
// non-negative multiple of the stride (the reference CUDA's gating,
// cuda_src/rubiks3d_kernels.cu:455-723). At stride 1 it is K1 with negated
// shifts. Quantize reads the quantized taps of the negated shift, as the
// reference does (at a remainder of exactly 0.5 that is not the forward's
// transpose).
//
// What bounds both on the card: device-memory bandwidth. Each does 8
// multiply-adds per element written against up to 8 read, far below the
// H100's ~20 FLOP per byte of f32 balance. Design: one thread per element
// written (output for K1, input for the inverse, so no scatter and no
// atomics), neighbouring threads on neighbouring channels, so the corner
// reads of a warp fall on few rows (each channel has its own shift, so the
// corners differ per lane but stay within 2 cells); the weights and indices
// are computed in f32 per element, which costs nothing next to the memory
// traffic. The integer part of the shift is unbounded here (the gather
// form's semantics: shifts move during training), so no max_shift argument
// exists.
#include "common.cuh"

namespace rubiks {

template <class T>
__global__ void shift3d_fwd_kernel(const T* __restrict__ x,
                                   const float* __restrict__ shift,
                                   T* __restrict__ out, int T_, int H, int W,
                                   int C, int To, int Ho, int Wo, int st,
                                   int sh, int sw, int pt, int ph, int pw,
                                   int quantize, int64_t total) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    int64_t r = i / C;
    const int wo = (int)(r % Wo);
    r /= Wo;
    const int ho = (int)(r % Ho);
    r /= Ho;
    const int to = (int)(r % To);
    const int64_t n = r / To;
    const AxisTaps a[3] = {
        forward_taps(to, st, pt, __ldg(shift + c), T_, quantize),
        forward_taps(ho, sh, ph, __ldg(shift + C + c), H, quantize),
        forward_taps(wo, sw, pw, __ldg(shift + 2 * C + c), W, quantize)};
    out[i] = from_f32<T>(
        corner_sum(x + n * T_ * (int64_t)H * W * C + c, a, H, W, C));
  }
}

template <class T>
__global__ void shift3d_inv_kernel(const T* __restrict__ og,
                                   const float* __restrict__ shift,
                                   T* __restrict__ gx, int T_, int H, int W,
                                   int C, int To, int Ho, int Wo, int st,
                                   int sh, int sw, int pt, int ph, int pw,
                                   int quantize, int64_t total) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int c = (int)(i % C);
    int64_t r = i / C;
    const int w = (int)(r % W);
    r /= W;
    const int h = (int)(r % H);
    r /= H;
    const int t = (int)(r % T_);
    const int64_t n = r / T_;
    const AxisTaps a[3] = {
        inverse_taps(t, st, pt, __ldg(shift + c), To, quantize),
        inverse_taps(h, sh, ph, __ldg(shift + C + c), Ho, quantize),
        inverse_taps(w, sw, pw, __ldg(shift + 2 * C + c), Wo, quantize)};
    gx[i] = from_f32<T>(
        corner_sum(og + n * To * (int64_t)Ho * Wo * C + c, a, Ho, Wo, C));
  }
}

inline int grid_for(int64_t total, int threads) {
  const int64_t want = (total + threads - 1) / threads;
  const int64_t cap = 64LL * sm_count();
  return (int)(want < cap ? want : cap);
}

template <class T>
int shift3d_launch(bool inverse, const void* src, const float* shift,
                   void* dst, int N, int T_, int H, int W, int C, int To,
                   int Ho, int Wo, int st, int sh, int sw, int pt, int ph,
                   int pw, int quantize, cudaStream_t stream) {
  // One thread per element written: the output for K1, the input for the
  // inverse.
  const int64_t total =
      inverse ? (int64_t)N * T_ * H * W * C : (int64_t)N * To * Ho * Wo * C;
  if (total == 0) return 0;
  const int threads = 256;
  const int blocks = grid_for(total, threads);
  if (inverse)
    shift3d_inv_kernel<T><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(src), shift, static_cast<T*>(dst), T_, H, W, C,
        To, Ho, Wo, st, sh, sw, pt, ph, pw, quantize, total);
  else
    shift3d_fwd_kernel<T><<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(src), shift, static_cast<T*>(dst), T_, H, W, C,
        To, Ho, Wo, st, sh, sw, pt, ph, pw, quantize, total);
  return (int)cudaGetLastError();
}

int shift3d_dispatch(bool inverse, const void* src, const float* shift,
                     void* dst, int dtype, int N, int T, int H, int W, int C,
                     int To, int Ho, int Wo, int st, int sh, int sw, int pt,
                     int ph, int pw, int quantize, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16)
    return shift3d_launch<__nv_bfloat16>(inverse, src, shift, dst, N, T, H,
                                         W, C, To, Ho, Wo, st, sh, sw, pt,
                                         ph, pw, quantize, s);
  if (dtype == kF32)
    return shift3d_launch<float>(inverse, src, shift, dst, N, T, H, W, C, To,
                                 Ho, Wo, st, sh, sw, pt, ph, pw, quantize, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace rubiks

extern "C" {

// x (N, T, H, W, C) and out (N, To, Ho, Wo, C) contiguous, of dtype
// (0 float32, 1 bfloat16); shift (3, C) float32, already rounded to the
// compute dtype by the caller. quantize: 0 fractional, 1 half up (3D), 2
// half away from zero of the coordinate (2D).
int rubiks_shift3d_fwd(const void* x, const float* shift, void* out,
                       int dtype, int N, int T, int H, int W, int C, int To,
                       int Ho, int Wo, int st, int sh, int sw, int pt, int ph,
                       int pw, int quantize, void* stream) {
  return rubiks::shift3d_dispatch(false, x, shift, out, dtype, N, T, H, W, C,
                                  To, Ho, Wo, st, sh, sw, pt, ph, pw,
                                  quantize, stream);
}

// og (N, To, Ho, Wo, C) and gx (N, T, H, W, C) contiguous, of dtype; shift
// (3, C) float32 as for the forward (not negated: the kernel negates).
int rubiks_shift3d_inv(const void* og, const float* shift, void* gx,
                       int dtype, int N, int T, int H, int W, int C, int To,
                       int Ho, int Wo, int st, int sh, int sw, int pt, int ph,
                       int pw, int quantize, void* stream) {
  return rubiks::shift3d_dispatch(true, og, shift, gx, dtype, N, T, H, W, C,
                                  To, Ho, Wo, st, sh, sw, pt, ph, pw,
                                  quantize, stream);
}

const char* rubiks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
