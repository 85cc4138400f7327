// K4: the raw (3, C) gradient of the 3D shift with respect to its shift
// parameters, reduced per channel in a fixed order.
//
// Replaces rubiksnet_tpu/ops/pallas/shift_grad_kernel.py::
// rubiks_shift3d_shift_grad_pallas (stride 1, pad 0, |floor(s)| <= K only)
// and the XLA formulation the JAX package used at stride (1, 2, 2)
// (ops/shift3d.py::rubiks_shift_3d_shift_grad). For each output element
// (n, t', h', w', c) it reads the 8 corners of x around (t'*sT - pT, h'*sH -
// pH, w'*sW - pW) + the corrected taps of the shift: per axis the small tap
// floor(s), moved back one cell where the remainder is exactly 0, and the
// large tap floor(s) + 1, with lerp weights (1 - r, r). With those corners
// q[a][b][c] (a, b, c: small/large along T, H, W) the three local
// derivatives are
//   dT = sum_{b,c} lH_b lW_c (q[1][b][c] - q[0][b][c])
//   dH = sum_{a,c} lT_a lW_c (q[a][1][c] - q[a][0][c])
//   dW = sum_{a,b} lT_a lH_b (q[a][b][1] - q[a][b][0])
// (tests/oracle.py:167-182), each multiplied by og and summed over (N, To,
// Ho, Wo) in f32.
//
// What bounds it on the card: device-memory bandwidth (9 reads and ~40
// flops per output element, no writes but the partials). Design: a block is
// 32 channels x 8 row lanes; each thread keeps one channel's taps in
// registers and walks a fixed slice of rows with stride 8, so a warp reads
// 32 neighbouring channels of one row (coalesced og, near-coalesced
// corners). Each block reduces its 8 row lanes in shared memory in a fixed
// order and writes one f32 partial per (slice, axis, channel); a second
// pass sums the partials over slices in order. No float atomics, so the
// same inputs give bit-identical gradients on every run (the reference's
// atomicAdd did not).
#include "common.cuh"

namespace rubiks {

constexpr int kLanes = 32, kRowLanes = 8;

template <class T>
__global__ void __launch_bounds__(kLanes * kRowLanes)
    shift_grad_partial_kernel(const T* __restrict__ og,
                              const T* __restrict__ x,
                              const float* __restrict__ shift,
                              float* __restrict__ partial, int T_, int H,
                              int W, int C, int To, int Ho, int Wo, int st,
                              int sh, int sw, int pt, int ph, int pw,
                              int64_t rows, int64_t rows_per_slice) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kLanes + tx;
  const int slice = blockIdx.y;
  float gt = 0.f, gh = 0.f, gw = 0.f;
  if (c < C) {
    int lo[3], hi[3];  // corrected small and large offsets per axis
    float l[3][2];     // lerp weights (1 - r, r) per axis
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float s = __ldg(shift + a * C + c);
      const float f = floorf(s);
      const float r = s - f;
      lo[a] = (int)f - (r == 0.f);
      hi[a] = (int)f + 1;
      l[a][0] = 1.f - r;
      l[a][1] = r;
    }
    const int64_t r0 = (int64_t)slice * rows_per_slice;
    const int64_t r1 = r0 + rows_per_slice < rows ? r0 + rows_per_slice
                                                  : rows;
    for (int64_t row = r0 + ty; row < r1; row += kRowLanes) {
      int64_t q = row;
      const int wo = (int)(q % Wo);
      q /= Wo;
      const int ho = (int)(q % Ho);
      q /= Ho;
      const int to = (int)(q % To);
      const int64_t n = q / To;
      const int bt = to * st - pt, bh = ho * sh - ph, bw = wo * sw - pw;
      const int it[2] = {bt + lo[0], bt + hi[0]};
      const int ih[2] = {bh + lo[1], bh + hi[1]};
      const int iw[2] = {bw + lo[2], bw + hi[2]};
      const T* xn = x + n * T_ * (int64_t)H * W * C + c;
      float v[2][2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b)
#pragma unroll
          for (int d = 0; d < 2; ++d) {
            const bool in = it[a] >= 0 && it[a] < T_ && ih[b] >= 0 &&
                            ih[b] < H && iw[d] >= 0 && iw[d] < W;
            v[a][b][d] =
                in ? to_f32(xn[(((int64_t)it[a] * H + ih[b]) * W + iw[d]) *
                               C])
                   : 0.f;
          }
      float dt = 0.f, dh = 0.f, dw = 0.f;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          dt = fmaf(l[1][a] * l[2][b], v[1][a][b] - v[0][a][b], dt);
          dh = fmaf(l[0][a] * l[2][b], v[a][1][b] - v[a][0][b], dh);
          dw = fmaf(l[0][a] * l[1][b], v[a][b][1] - v[a][b][0], dw);
        }
      const float u = to_f32(og[row * C + c]);
      gt = fmaf(dt, u, gt);
      gh = fmaf(dh, u, gh);
      gw = fmaf(dw, u, gw);
    }
  }
  __shared__ float red[3][kRowLanes][kLanes];
  red[0][ty][tx] = gt;
  red[1][ty][tx] = gh;
  red[2][ty][tx] = gw;
  __syncthreads();
  if (ty < 3 && c < C) {
    float acc = 0.f;
#pragma unroll
    for (int y = 0; y < kRowLanes; ++y) acc += red[ty][y][tx];
    partial[((int64_t)slice * 3 + ty) * C + c] = acc;
  }
}

// out[i] = sum over slices of partial[slice, i], i over 3 * C, in slice
// order.
__global__ void shift_grad_sum_kernel(const float* __restrict__ partial,
                                      float* __restrict__ out, int slices,
                                      int n3c) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n3c) return;
  float acc = 0.f;
  for (int s = 0; s < slices; ++s) acc += partial[(int64_t)s * n3c + i];
  out[i] = acc;
}

template <class T>
int shift_grad_launch(const void* og, const void* x, const float* shift,
                      float* partial, float* out, int N, int T_, int H, int W,
                      int C, int To, int Ho, int Wo, int st, int sh, int sw,
                      int pt, int ph, int pw, int slices,
                      cudaStream_t stream) {
  if (C == 0) return 0;
  const int64_t rows = (int64_t)N * To * Ho * Wo;
  const int64_t per_slice = (rows + slices - 1) / slices;
  const dim3 grid((C + kLanes - 1) / kLanes, slices);
  shift_grad_partial_kernel<T><<<grid, dim3(kLanes, kRowLanes), 0, stream>>>(
      static_cast<const T*>(og), static_cast<const T*>(x), shift, partial, T_,
      H, W, C, To, Ho, Wo, st, sh, sw, pt, ph, pw, rows, per_slice);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n3c = 3 * C;
  shift_grad_sum_kernel<<<(n3c + 255) / 256, 256, 0, stream>>>(partial, out,
                                                               slices, n3c);
  return (int)cudaGetLastError();
}

}  // namespace rubiks

extern "C" {

// og (N, To, Ho, Wo, C) and x (N, T, H, W, C) contiguous, of dtype (0
// float32, 1 bfloat16); shift (3, C) float32, already rounded to the compute
// dtype; partial (slices, 3, C) and out (3, C) float32 scratch and result.
int rubiks_shift_grad(const void* og, const void* x, const float* shift,
                      float* partial, float* out, int dtype, int N, int T,
                      int H, int W, int C, int To, int Ho, int Wo, int st,
                      int sh, int sw, int pt, int ph, int pw, int slices,
                      void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (slices < 1) return (int)cudaErrorInvalidValue;
  if (dtype == rubiks::kBF16)
    return rubiks::shift_grad_launch<__nv_bfloat16>(
        og, x, shift, partial, out, N, T, H, W, C, To, Ho, Wo, st, sh, sw, pt,
        ph, pw, slices, s);
  if (dtype == rubiks::kF32)
    return rubiks::shift_grad_launch<float>(og, x, shift, partial, out, N, T,
                                            H, W, C, To, Ho, Wo, st, sh, sw,
                                            pt, ph, pw, slices, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
