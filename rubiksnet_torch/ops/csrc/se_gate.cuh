// The squeeze-excitation gate of the fused kernels (fused_block.cu,
// fused_entry.cu), in two small launches before the second GEMM:
//
//   gate[n, t, c] = sigmoid(relu(m[n, t, :] . fc1) . fc2)[c]
//   m[n, t, c]    = mean over the (Ho, Wo) output grid of shift(mid)
//
// Replaces se_gate / se_conv3_batched of
// rubiksnet_tpu/ops/pallas/fused_block.py (also reached from
// fused_frames.py) and gate_from_mean with its decimated sum of
// ops/pallas/fused_entry.py, which compute the mean and both dense layers
// inside the kernel body; so do these: no library product.
//
// What bounds it on the card: one read of mid (bytes). The shift is linear
// with zero fill, so the spatial sum of the shifted tensor is a weighted sum
// of mid itself: sum_{ho,wo} shift(mid)[t] = sum_jt wT[jt] * S[t + jt - K],
// S[t'] = sum_{h,w} mid[t', h, w] * aH[h] * aW[w], where aH[h] is the sum of
// the H taps that carry input row h onto some output row (all taps away
// from the border; at stride 2 only the taps of matching parity), and aW
// likewise. One coalesced pass over mid replaces a gather of up to 8
// corners per output element. Deterministic: pass 1 writes one partial per
// (frame, 8-row slice, channel), reduced over the block's 8 row lanes in a
// fixed order; pass 2 sums the slices in order. No float atomics.
#pragma once

#include "common.cuh"

namespace rubiks {

constexpr int kSeRows = 8;  // rows of H per block of pass 1 (blockDim.y)

// Sum of the taps of one axis that carry input cell i onto an output cell:
// tap j reads input o * S + j - K at output o, so o = (i - j + K) / S must be
// an integer in [0, d_out).
__device__ __forceinline__ float carried_taps(const float* __restrict__ taps,
                                              int C, int c, int taps_n, int K,
                                              int S, int i, int d_out) {
  float a = 0.f;
  for (int j = 0; j < taps_n; ++j) {
    const int q = i - j + K;
    if (q >= 0 && q % S == 0 && q / S < d_out) a += __ldg(taps + j * C + c);
  }
  return a;
}

// Pass 1. grid (N*T frames, ceil(C/32), slices), block (32, kSeRows): lane x
// is a channel, lane y one row of the slice. partial: (N*T, slices, C) f32.
// taps: (3*taps_n, C), rows T, H, W.
template <class T>
__global__ void __launch_bounds__(32 * kSeRows)
    se_partial_kernel(const T* __restrict__ mid,
                      const float* __restrict__ taps,
                      float* __restrict__ partial, int H, int W, int C,
                      int Ho, int Wo, int S, int taps_n, int K) {
  __shared__ float red[kSeRows][32];
  const int c = blockIdx.y * 32 + threadIdx.x;
  const int h = blockIdx.z * kSeRows + threadIdx.y;
  float sum = 0.f;
  if (c < C && h < H) {
    const float ah = carried_taps(taps + taps_n * C, C, c, taps_n, K, S, h, Ho);
    if (ah != 0.f) {
      const T* row = mid + ((int64_t)blockIdx.x * H + h) * (int64_t)W * C + c;
      const float* wtaps = taps + 2 * taps_n * C;
      for (int w = 0; w < W; ++w) {
        const float aw = carried_taps(wtaps, C, c, taps_n, K, S, w, Wo);
        sum = fmaf(aw, to_f32(row[(int64_t)w * C]), sum);
      }
      sum *= ah;
    }
  }
  red[threadIdx.y][threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.y == 0 && c < C) {
    float total = 0.f;
#pragma unroll
    for (int r = 0; r < kSeRows; ++r) total += red[r][threadIdx.x];
    partial[((int64_t)blockIdx.x * gridDim.z + blockIdx.z) * C + c] = total;
  }
}

// Pass 2. One block per frame (n, t). se: (2, C, Cr) f32, slot 0 fc1 as
// (C, Cr), slot 1 fc2 transposed (C, Cr). gate: (N*T, C) f32. Dynamic shared
// memory: (C + Cr) floats.
static __global__ void se_gate_kernel(const float* __restrict__ partial,
                               const float* __restrict__ taps,
                               const float* __restrict__ se,
                               float* __restrict__ gate, int T_, int C, int Cr,
                               int slices, int taps_n, int K,
                               float inv_count) {
  extern __shared__ float se_smem[];
  float* m = se_smem;       // [C]
  float* y1 = se_smem + C;  // [Cr]
  const int frame = blockIdx.x;
  const int t = frame % T_;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < taps_n; ++j) {
      const int ti = t + j - K;
      const float wt = __ldg(taps + j * C + c);
      if (ti < 0 || ti >= T_ || wt == 0.f) continue;
      const float* p = partial + (int64_t)(frame - t + ti) * slices * C + c;
      float s = 0.f;
      for (int i = 0; i < slices; ++i) s += p[(int64_t)i * C];
      acc = fmaf(wt, s, acc);
    }
    m[c] = acc * inv_count;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < Cr; j += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(m[c], __ldg(se + c * Cr + j), acc);
    y1[j] = fmaxf(acc, 0.f);
  }
  __syncthreads();
  const float* fc2t = se + (int64_t)C * Cr;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < Cr; ++j)
      acc = fmaf(y1[j], __ldg(fc2t + c * Cr + j), acc);
    gate[(int64_t)frame * C + c] = 1.f / (1.f + expf(-acc));
  }
}

// Both passes on `stream`. mid: (frames, H, W, C) of T; the output grid is
// (Ho, Wo) at stride S. slices must be ceil(H / kSeRows).
template <class T>
inline cudaError_t launch_se_gate(const T* mid, const float* taps,
                                  const float* se, float* partial,
                                  float* gate, int frames, int T_, int H,
                                  int W, int C, int Ho, int Wo, int S,
                                  int taps_n, int K, int Cr, int slices,
                                  cudaStream_t stream) {
  if (slices != (H + kSeRows - 1) / kSeRows || slices > 65535 || Cr < 1)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)frames, (unsigned)((C + 31) / 32),
                  (unsigned)slices);
  se_partial_kernel<T><<<grid, dim3(32, kSeRows), 0, stream>>>(
      mid, taps, partial, H, W, C, Ho, Wo, S, taps_n, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(C + Cr) * sizeof(float);
  se_gate_kernel<<<frames, 256, smem, stream>>>(
      partial, taps, se, gate, T_, C, Cr, slices, taps_n, K,
      1.f / ((float)Ho * (float)Wo));
  return cudaGetLastError();
}

}  // namespace rubiks
