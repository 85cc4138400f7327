// K1: the fractional 3D shift forward, one pass.
//
// Replaces rubiksnet_tpu/ops/pallas/shift_kernel.py::rubiks_shift3d_pallas
// (forward) and, at stride (1, 2, 2), ops/pallas/fused_shift3d.py::
// rubiks_shift_3d_fused. out[n, t', h', w', c] is the trilinear interpolation
// of x at (t'*sT - pT + shiftT[c], h'*sH - pH + shiftH[c], w'*sW - pW +
// shiftW[c]) with zero fill outside x; quantize reads the one corner whose
// per-axis remainder rounds half up (remainder < 0.5 -> floor).
//
// What bounds it on the card: device-memory bandwidth. It does 8 multiply-
// adds per output element against one element written and up to 8 read, far
// below the H100's ~20 FLOP per byte of f32 balance. Design: one thread per
// output element, neighbouring threads on neighbouring channels, so the
// corner reads of a warp fall on few rows of x (each channel has its own
// shift, so the corners differ per lane but stay within 2 cells); the
// weights and indices are computed in f32 per element, which costs nothing
// next to the memory traffic. The integer part of the shift is unbounded
// here (the gather form's semantics), so no max_shift argument exists.
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

    int base[3];
    float frac[3];
    const int origin[3] = {to * st - pt, ho * sh - ph, wo * sw - pw};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float s = __ldg(shift + a * C + c);
      const float f = floorf(s);
      base[a] = origin[a] + (int)f;
      frac[a] = s - f;
    }
    const T* xn = x + n * T_ * (int64_t)H * W * C + c;
    if (quantize) {
      const int ti = base[0] + (frac[0] >= 0.5f);
      const int hi = base[1] + (frac[1] >= 0.5f);
      const int wi = base[2] + (frac[2] >= 0.5f);
      const bool in = ti >= 0 && ti < T_ && hi >= 0 && hi < H && wi >= 0 &&
                      wi < W;
      out[i] = in ? xn[(((int64_t)ti * H + hi) * W + wi) * C]
                  : from_f32<T>(0.f);
      continue;
    }
    float acc = 0.f;
#pragma unroll
    for (int dt = 0; dt < 2; ++dt) {
      const float wt = dt ? frac[0] : 1.f - frac[0];
      const int ti = base[0] + dt;
      if (wt == 0.f || ti < 0 || ti >= T_) continue;
#pragma unroll
      for (int dh = 0; dh < 2; ++dh) {
        const float wh = dh ? frac[1] : 1.f - frac[1];
        const int hi = base[1] + dh;
        if (wh == 0.f || hi < 0 || hi >= H) continue;
#pragma unroll
        for (int dw = 0; dw < 2; ++dw) {
          const float ww = dw ? frac[2] : 1.f - frac[2];
          const int wi = base[2] + dw;
          if (ww == 0.f || wi < 0 || wi >= W) continue;
          acc = fmaf(wt * wh * ww,
                     to_f32(xn[(((int64_t)ti * H + hi) * W + wi) * C]), acc);
        }
      }
    }
    out[i] = from_f32<T>(acc);
  }
}

template <class T>
int shift3d_fwd(const void* x, const float* shift, void* out, int N, int T_,
                int H, int W, int C, int To, int Ho, int Wo, int st, int sh,
                int sw, int pt, int ph, int pw, int quantize,
                cudaStream_t stream) {
  const int64_t total = (int64_t)N * To * Ho * Wo * C;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t want = (total + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 64 ? want : 132 * 64);
  shift3d_fwd_kernel<T><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), shift, static_cast<T*>(out), T_, H, W, C, To,
      Ho, Wo, st, sh, sw, pt, ph, pw, quantize, total);
  return (int)cudaGetLastError();
}

}  // namespace rubiks

extern "C" {

// x (N, T, H, W, C) and out (N, To, Ho, Wo, C) contiguous, of dtype
// (0 float32, 1 bfloat16); shift (3, C) float32, already rounded to the
// compute dtype by the caller.
int rubiks_shift3d_fwd(const void* x, const float* shift, void* out,
                       int dtype, int N, int T, int H, int W, int C, int To,
                       int Ho, int Wo, int st, int sh, int sw, int pt, int ph,
                       int pw, int quantize, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == rubiks::kBF16)
    return rubiks::shift3d_fwd<__nv_bfloat16>(x, shift, out, N, T, H, W, C,
                                              To, Ho, Wo, st, sh, sw, pt, ph,
                                              pw, quantize, s);
  if (dtype == rubiks::kF32)
    return rubiks::shift3d_fwd<float>(x, shift, out, N, T, H, W, C, To, Ho,
                                      Wo, st, sh, sw, pt, ph, pw, quantize,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* rubiks_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
