// Train-mode batch norm over the last axis followed by ReLU, forward and
// backward, on a channel-last (rows, C) tensor of float32 or bfloat16.
//
// Replaces no TPU kernel: the JAX package leaves train-mode BN to XLA,
// which fuses its statistics and normalisation into the neighbouring
// fusions. In the port the same function ran as some twenty PyTorch ops a
// site (a float32 copy of the input, var_mean, sub, rsqrt, mul, mul, add, a
// cast, relu, the running statistics, and autograd's differentiation of
// each, which saved the float32 copies), about 120 bytes of device traffic
// an element at 103 sites of a RubiksNet-Large train step.
//
// What bounds it on the H100: device-memory bandwidth (a few operations an
// element, far below the card's 295 operations a byte). Design: the least
// traffic, x read twice and the output written once forward (6 bytes an
// element in bf16), dy and x read twice and dx written once backward (10
// bytes), each in three launches:
//   forward   stats    each block walks its rows once with 16-byte loads
//                      and writes per-channel Welford partials (mean, M2)
//             finalize merges the partials by Chan's formula in a fixed
//                      order into mean and rstd (saved for the backward),
//                      updates the running statistics and the batch count
//                      in place
//             apply    out = relu((x - mean) * rstd * gamma + beta)
//   backward  stats    per-channel sums of g = dy [out > 0] and g (x - mean),
//                      the mask recomputed from x exactly as the forward
//                      computed it
//             finalize dgamma = rstd sum g (x - mean), dbeta = sum g
//             apply    dx = rstd gamma (g - dbeta / R - xhat dgamma / R)
// Nothing is saved but x and the (2, C) statistics. A thread owns `vec`
// consecutive channels (one 16-byte load when C and the pointers allow it)
// and walks rows `row_lanes` apart; a block is `lanes x row_lanes` threads
// over a contiguous range of rows, so a warp reads contiguous memory. The
// plan (ops/bn_relu.py::bn_relu_plan) fixes every summation order: the same
// inputs give bit-identical results on every run. The statistics never use
// E[x^2] - E[x]^2, which cancels over millions of rows.
//
// The kernels live outside namespace rubiks: the profiler's kernel names
// then carry none of the substrings by which the benchmark sorts kernels
// into classes (portbench/yardstick.py::CLASSES).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bnrelu {

constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;        // resident blocks an SM (64 registers)
constexpr int kUnroll = 4;           // rows a thread has in flight
constexpr int kFinLanes = 32;        // channels of a finalize block
constexpr int kFinSlices = 32;       // partials walked side by side
constexpr int kFinDepth = 4;         // partials a thread loads at once

// An element type's bits and its conversions to and from float.
template <class T>
struct Elem;
template <>
struct Elem<float> {
  using Bits = uint32_t;
  static __device__ __forceinline__ float get(Bits b) {
    return __uint_as_float(b);
  }
  static __device__ __forceinline__ Bits put(float v) {
    return __float_as_uint(v);
  }
};
template <>
struct Elem<__nv_bfloat16> {
  using Bits = uint16_t;
  static __device__ __forceinline__ float get(Bits b) {
    return __uint_as_float(static_cast<uint32_t>(b) << 16);
  }
  static __device__ __forceinline__ Bits put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16(v));
  }
};

template <int Bytes>
struct Raw;
template <>
struct Raw<16> { using type = uint4; };
template <>
struct Raw<8> { using type = uint2; };
template <>
struct Raw<4> { using type = uint32_t; };
template <>
struct Raw<2> { using type = uint16_t; };

// V consecutive elements moved as one load or store.
template <class T, int V>
union Pack {
  typename Raw<V * sizeof(typename Elem<T>::Bits)>::type raw;
  typename Elem<T>::Bits e[V];
};

template <class T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  Pack<T, V> k;
  k.raw = *reinterpret_cast<const decltype(k.raw)*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) v[i] = Elem<T>::get(k.e[i]);
}

template <class T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  Pack<T, V> k;
#pragma unroll
  for (int i = 0; i < V; ++i) k.e[i] = Elem<T>::put(v[i]);
  *reinterpret_cast<decltype(k.raw)*>(p) = k.raw;
}

// The pre-activation of one element as both directions compute it, and
// whether the stored output (rounded to T) is positive.
__device__ __forceinline__ float pre_act(float t, float scale, float bias) {
  return fmaf(t, scale, bias);
}
template <class T>
__device__ __forceinline__ bool stored_positive(float y) {
  return Elem<T>::get(Elem<T>::put(y)) > 0.f;
}

// (n, mean, M2) += (nb, mb, M2b), Chan's pairwise rule; either may be empty.
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2,
                                           float nb, float mb, float m2b) {
  if (nb == 0.f) return;
  const float tot = n + nb;
  const float d = mb - mean;
  const float f = nb / tot;
  mean = fmaf(d, f, mean);
  m2 = m2 + m2b + d * d * n * f;
  n = tot;
}

// The rows of block b: [b * per_block, min(rows, (b + 1) * per_block)).
__device__ __forceinline__ int64_t block_rows(int64_t rows, int64_t per_block,
                                              int b, int64_t* r0) {
  *r0 = (int64_t)b * per_block;
  const int64_t end = *r0 + per_block < rows ? *r0 + per_block : rows;
  return end > *r0 ? end - *r0 : 0;
}

// Rows r0 + lane, r0 + lane + step, ... below r1: how many.
__device__ __forceinline__ int64_t lane_rows(int64_t n_rows, int lane,
                                             int step) {
  return n_rows > lane ? (n_rows - lane + step - 1) / step : 0;
}

// ---------------------------------------------------------------- forward

// Per block and channel: (mean, M2) of the block's rows, in partial[0][b][c]
// and partial[1][b][c]. Each thread runs Welford's update over its rows,
// then thread c merges the row lanes of channel c in order.
template <class T, int V>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bn_relu_train_stats_kernel(const T* __restrict__ x,
                               float* __restrict__ partial, int64_t rows,
                               int C, int row_lanes, int64_t per_block) {
  extern __shared__ float smem[];  // mean [row_lanes][C], M2 [row_lanes][C]
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes, rl = threadIdx.x / lanes;
  int64_t r0;
  const int64_t n_rows = block_rows(rows, per_block, blockIdx.x, &r0);
  float mean[V], m2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) mean[i] = m2[i] = 0.f;
  float n = 0.f;
  const T* p = x + (r0 + rl) * C + lane * V;
  const int64_t step = (int64_t)row_lanes * C;
  int64_t left = lane_rows(n_rows, rl, row_lanes);
  auto update = [&](const float (&v)[V]) {
    n += 1.f;
    const float inv = 1.f / n;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = v[i] - mean[i];
      mean[i] = fmaf(d, inv, mean[i]);
      m2[i] = fmaf(d, v[i] - mean[i], m2[i]);
    }
  };
  for (; left >= kUnroll; left -= kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_vec<T, V>(p + u * step, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) update(v[u]);
    p += kUnroll * step;
  }
  for (; left > 0; --left) {
    float v[V];
    load_vec<T, V>(p, v);
    update(v);
    p += step;
  }
  float* s_mean = smem;
  float* s_m2 = smem + row_lanes * C;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_mean[rl * C + lane * V + i] = mean[i];
    s_m2[rl * C + lane * V + i] = m2[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float tn = 0.f, tm = 0.f, tm2 = 0.f;
    for (int l = 0; l < row_lanes; ++l)
      chan_merge(tn, tm, tm2, (float)lane_rows(n_rows, l, row_lanes),
                 s_mean[l * C + c], s_m2[l * C + c]);
    partial[(int64_t)blockIdx.x * C + c] = tm;
    partial[((int64_t)gridDim.x + blockIdx.x) * C + c] = tm2;
  }
}

// Merge the blocks' partials per channel: slice s of a channel merges
// blocks s, s + kFinSlices, ... in order, then slice 0 merges the slices in
// order. Writes stats = (mean, rstd), updates the running statistics
// (0.9 running + 0.1 batch, the biased variance) and the batch count.
__global__ void __launch_bounds__(kFinLanes * kFinSlices)
    bn_relu_train_finalize_kernel(const float* __restrict__ partial,
                                  int blocks, int64_t rows, int64_t per_block,
                                  int C, float eps, float* __restrict__ stats,
                                  float* __restrict__ running_mean,
                                  float* __restrict__ running_var,
                                  long long* __restrict__ batches) {
  __shared__ float sh[3][kFinSlices][kFinLanes];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinLanes + tx;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  if (c < C) {
    // Blocks ty, ty + kFinSlices, ... in order, kFinDepth loads in flight.
    for (int b0 = ty; b0 < blocks; b0 += kFinSlices * kFinDepth) {
      float pm[kFinDepth], pq[kFinDepth];
#pragma unroll
      for (int j = 0; j < kFinDepth; ++j) {
        const int b = b0 + j * kFinSlices;
        pm[j] = b < blocks ? partial[(int64_t)b * C + c] : 0.f;
        pq[j] = b < blocks ? partial[((int64_t)blocks + b) * C + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kFinDepth; ++j) {
        int64_t r0;
        const int b = b0 + j * kFinSlices;
        const int64_t nb = b < blocks ? block_rows(rows, per_block, b, &r0)
                                      : 0;
        chan_merge(n, mean, m2, (float)nb, pm[j], pq[j]);
      }
    }
  }
  sh[0][ty][tx] = n;
  sh[1][ty][tx] = mean;
  sh[2][ty][tx] = m2;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int s = 1; s < kFinSlices; ++s)
      chan_merge(n, mean, m2, sh[0][s][tx], sh[1][s][tx], sh[2][s][tx]);
    const float var = m2 / (float)rows;
    stats[c] = mean;
    stats[C + c] = rsqrtf(var + eps);
    running_mean[c] = fmaf(0.1f, mean, running_mean[c] * 0.9f);
    running_var[c] = fmaf(0.1f, var, running_var[c] * 0.9f);
  }
  if (blockIdx.x == 0 && tx == 0 && ty == 0) *batches += 1;
}

// out = relu((x - mean) * rstd * gamma + beta), rounded to T.
template <class T, int V>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bn_relu_train_apply_kernel(const T* __restrict__ x,
                               const float* __restrict__ stats,
                               const float* __restrict__ weight,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int64_t rows, int C,
                               int row_lanes, int64_t per_block) {
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes, rl = threadIdx.x / lanes;
  int64_t r0;
  const int64_t n_rows = block_rows(rows, per_block, blockIdx.x, &r0);
  float mu[V], sc[V], be[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane * V + i;
    mu[i] = stats[c];
    sc[i] = stats[C + c] * weight[c];
    be[i] = bias[c];
  }
  const int64_t off = (r0 + rl) * C + lane * V;
  const T* p = x + off;
  T* q = out + off;
  const int64_t step = (int64_t)row_lanes * C;
  int64_t left = lane_rows(n_rows, rl, row_lanes);
  auto act = [&](float (&v)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i)
      v[i] = fmaxf(pre_act(v[i] - mu[i], sc[i], be[i]), 0.f);
  };
  for (; left >= kUnroll; left -= kUnroll) {
    float v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) load_vec<T, V>(p + u * step, v[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      act(v[u]);
      store_vec<T, V>(q + u * step, v[u]);
    }
    p += kUnroll * step;
    q += kUnroll * step;
  }
  for (; left > 0; --left) {
    float v[V];
    load_vec<T, V>(p, v);
    act(v);
    store_vec<T, V>(q, v);
    p += step;
    q += step;
  }
}

// --------------------------------------------------------------- backward

// Per block and channel: sum of g and of g (x - mean), g = dy [out > 0], in
// partial[0][b][c] and partial[1][b][c]; row lanes summed in order.
template <class T, int V>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bn_relu_train_bwd_stats_kernel(const T* __restrict__ dy,
                                   const T* __restrict__ x,
                                   const float* __restrict__ stats,
                                   const float* __restrict__ weight,
                                   const float* __restrict__ bias,
                                   float* __restrict__ partial, int64_t rows,
                                   int C, int row_lanes, int64_t per_block) {
  extern __shared__ float smem[];  // sum g [row_lanes][C], sum g t [..][C]
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes, rl = threadIdx.x / lanes;
  int64_t r0;
  const int64_t n_rows = block_rows(rows, per_block, blockIdx.x, &r0);
  float mu[V], sc[V], be[V], sg[V], sgt[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane * V + i;
    mu[i] = stats[c];
    sc[i] = stats[C + c] * weight[c];
    be[i] = bias[c];
    sg[i] = sgt[i] = 0.f;
  }
  const int64_t off = (r0 + rl) * C + lane * V;
  const T* pd = dy + off;
  const T* px = x + off;
  const int64_t step = (int64_t)row_lanes * C;
  int64_t left = lane_rows(n_rows, rl, row_lanes);
  auto add = [&](const float (&d)[V], const float (&v)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float t = v[i] - mu[i];
      const float g =
          stored_positive<T>(pre_act(t, sc[i], be[i])) ? d[i] : 0.f;
      sg[i] += g;
      sgt[i] = fmaf(g, t, sgt[i]);
    }
  };
  for (; left >= kUnroll; left -= kUnroll) {
    float d[kUnroll][V], v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_vec<T, V>(pd + u * step, d[u]);
      load_vec<T, V>(px + u * step, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) add(d[u], v[u]);
    pd += kUnroll * step;
    px += kUnroll * step;
  }
  for (; left > 0; --left) {
    float d[V], v[V];
    load_vec<T, V>(pd, d);
    load_vec<T, V>(px, v);
    add(d, v);
    pd += step;
    px += step;
  }
  float* s_g = smem;
  float* s_gt = smem + row_lanes * C;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_g[rl * C + lane * V + i] = sg[i];
    s_gt[rl * C + lane * V + i] = sgt[i];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < row_lanes; ++l) {
      a += s_g[l * C + c];
      b += s_gt[l * C + c];
    }
    partial[(int64_t)blockIdx.x * C + c] = a;
    partial[((int64_t)gridDim.x + blockIdx.x) * C + c] = b;
  }
}

// dbias = sum g, dweight = rstd sum g (x - mean), over the blocks' partials
// in the finalize order of the forward.
__global__ void __launch_bounds__(kFinLanes * kFinSlices)
    bn_relu_train_bwd_finalize_kernel(const float* __restrict__ partial,
                                      int blocks, int C,
                                      const float* __restrict__ stats,
                                      float* __restrict__ dweight,
                                      float* __restrict__ dbias) {
  __shared__ float sh[2][kFinSlices][kFinLanes];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kFinLanes + tx;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int k0 = ty; k0 < blocks; k0 += kFinSlices * kFinDepth) {
      float pa[kFinDepth], pb[kFinDepth];
#pragma unroll
      for (int j = 0; j < kFinDepth; ++j) {
        const int k = k0 + j * kFinSlices;
        pa[j] = k < blocks ? partial[(int64_t)k * C + c] : 0.f;
        pb[j] = k < blocks ? partial[((int64_t)blocks + k) * C + c] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kFinDepth; ++j) {
        if (k0 + j * kFinSlices < blocks) {
          a += pa[j];
          b += pb[j];
        }
      }
    }
  }
  sh[0][ty][tx] = a;
  sh[1][ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int s = 1; s < kFinSlices; ++s) {
      a += sh[0][s][tx];
      b += sh[1][s][tx];
    }
    dbias[c] = a;
    dweight[c] = stats[C + c] * b;
  }
}

// dx = rstd gamma (g - dbeta / R - (x - mean) rstd dgamma / R), rounded to T.
template <class T, int V>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    bn_relu_train_bwd_apply_kernel(const T* __restrict__ dy,
                                   const T* __restrict__ x,
                                   const float* __restrict__ stats,
                                   const float* __restrict__ weight,
                                   const float* __restrict__ bias,
                                   const float* __restrict__ dweight,
                                   const float* __restrict__ dbias,
                                   T* __restrict__ dx, int64_t rows, int C,
                                   int row_lanes, int64_t per_block) {
  const int lanes = C / V;
  const int lane = threadIdx.x % lanes, rl = threadIdx.x / lanes;
  int64_t r0;
  const int64_t n_rows = block_rows(rows, per_block, blockIdx.x, &r0);
  const float inv_rows = 1.f / (float)rows;
  float mu[V], sc[V], be[V], c0[V], c2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int c = lane * V + i;
    const float rstd = stats[C + c];
    mu[i] = stats[c];
    sc[i] = rstd * weight[c];
    be[i] = bias[c];
    c0[i] = dbias[c] * inv_rows;
    c2[i] = rstd * dweight[c] * inv_rows;
  }
  const int64_t off = (r0 + rl) * C + lane * V;
  const T* pd = dy + off;
  const T* px = x + off;
  T* q = dx + off;
  const int64_t step = (int64_t)row_lanes * C;
  int64_t left = lane_rows(n_rows, rl, row_lanes);
  auto grad = [&](const float (&d)[V], float (&v)[V]) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float t = v[i] - mu[i];
      const float g =
          stored_positive<T>(pre_act(t, sc[i], be[i])) ? d[i] : 0.f;
      v[i] = sc[i] * (g - fmaf(t, c2[i], c0[i]));
    }
  };
  for (; left >= kUnroll; left -= kUnroll) {
    float d[kUnroll][V], v[kUnroll][V];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_vec<T, V>(pd + u * step, d[u]);
      load_vec<T, V>(px + u * step, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      grad(d[u], v[u]);
      store_vec<T, V>(q + u * step, v[u]);
    }
    pd += kUnroll * step;
    px += kUnroll * step;
    q += kUnroll * step;
  }
  for (; left > 0; --left) {
    float d[V], v[V];
    load_vec<T, V>(pd, d);
    load_vec<T, V>(px, v);
    grad(d, v);
    store_vec<T, V>(q, v);
    pd += step;
    px += step;
    q += step;
  }
}

// ---------------------------------------------------------------- launches

struct Plan {
  int64_t rows, per_block;
  int C, row_lanes, blocks, threads;
  size_t smem;
};

inline Plan make_plan(int64_t rows, int C, int vec, int row_lanes,
                      int64_t per_block, int blocks) {
  Plan p{rows, per_block, C, row_lanes, blocks,
         vec > 0 ? (C / vec) * row_lanes : 0,
         (size_t)2 * row_lanes * C * sizeof(float)};
  return p;
}

inline bool plan_ok(const Plan& p, int vec) {
  return p.rows > 0 && p.C > 0 && vec > 0 && p.C % vec == 0 &&
         p.row_lanes > 0 && p.threads <= kMaxThreads && p.blocks > 0 &&
         p.per_block > 0 && (int64_t)p.blocks * p.per_block >= p.rows &&
         p.smem <= 48 * 1024;
}

inline dim3 fin_grid(int C) {
  return dim3((unsigned)((C + kFinLanes - 1) / kFinLanes));
}

template <class T, int V>
int forward_launch(const void* x, const float* weight, const float* bias,
                   float* running_mean, float* running_var,
                   long long* batches, void* out, float* stats,
                   float* partial, const Plan& p, float eps,
                   cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  bn_relu_train_stats_kernel<T, V><<<p.blocks, p.threads, p.smem, s>>>(
      xt, partial, p.rows, p.C, p.row_lanes, p.per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_train_finalize_kernel<<<fin_grid(p.C), dim3(kFinLanes, kFinSlices),
                                  0, s>>>(partial, p.blocks, p.rows,
                                          p.per_block, p.C, eps, stats,
                                          running_mean, running_var,
                                          batches);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_train_apply_kernel<T, V><<<p.blocks, p.threads, 0, s>>>(
      xt, stats, weight, bias, static_cast<T*>(out), p.rows, p.C,
      p.row_lanes, p.per_block);
  return (int)cudaGetLastError();
}

template <class T, int V>
int backward_launch(const void* dy, const void* x, const float* stats,
                    const float* weight, const float* bias, void* dx,
                    float* dweight, float* dbias, float* partial,
                    const Plan& p, cudaStream_t s) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  bn_relu_train_bwd_stats_kernel<T, V><<<p.blocks, p.threads, p.smem, s>>>(
      dyt, xt, stats, weight, bias, partial, p.rows, p.C, p.row_lanes,
      p.per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_train_bwd_finalize_kernel<<<fin_grid(p.C),
                                      dim3(kFinLanes, kFinSlices), 0, s>>>(
      partial, p.blocks, p.C, stats, dweight, dbias);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_relu_train_bwd_apply_kernel<T, V><<<p.blocks, p.threads, 0, s>>>(
      dyt, xt, stats, weight, bias, dweight, dbias, static_cast<T*>(dx),
      p.rows, p.C, p.row_lanes, p.per_block);
  return (int)cudaGetLastError();
}

enum DType { kF32 = 0, kBF16 = 1 };

// The launch for (dtype, vec): bf16 takes 8, 4, 2 or 1 channels a load,
// float32 4, 2 or 1.
template <class F>
int dispatch(int dtype, int vec, F&& f) {
  if (dtype == kBF16) {
    switch (vec) {
      case 8: return f(__nv_bfloat16(), std::integral_constant<int, 8>());
      case 4: return f(__nv_bfloat16(), std::integral_constant<int, 4>());
      case 2: return f(__nv_bfloat16(), std::integral_constant<int, 2>());
      case 1: return f(__nv_bfloat16(), std::integral_constant<int, 1>());
    }
  } else if (dtype == kF32) {
    switch (vec) {
      case 4: return f(float(), std::integral_constant<int, 4>());
      case 2: return f(float(), std::integral_constant<int, 2>());
      case 1: return f(float(), std::integral_constant<int, 1>());
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace bnrelu

extern "C" {

// Forward of relu(batch_norm(x)) in train mode. x and out (rows, C)
// contiguous of dtype (0 float32, 1 bfloat16), 16-byte aligned where vec
// asks for it; weight, bias, running_mean, running_var (C,) float32;
// batches the int64 count of batches; stats (2, C) float32 out (mean,
// rstd); partial (2, blocks, C) float32 scratch. The plan (vec, row_lanes,
// per_block, blocks) is ops/bn_relu.py::bn_relu_plan's.
int bn_relu_train_forward(const void* x, const float* weight,
                          const float* bias, float* running_mean,
                          float* running_var, long long* batches, void* out,
                          float* stats, float* partial, int dtype,
                          int64_t rows, int C, int vec, int row_lanes,
                          int64_t per_block, int blocks, float eps,
                          void* stream) {
  const bnrelu::Plan p =
      bnrelu::make_plan(rows, C, vec, row_lanes, per_block, blocks);
  if (!bnrelu::plan_ok(p, vec)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bnrelu::dispatch(dtype, vec, [&](auto t, auto v) {
    return bnrelu::forward_launch<decltype(t), decltype(v)::value>(
        x, weight, bias, running_mean, running_var, batches, out, stats,
        partial, p, eps, s);
  });
}

// Backward: dy, x, dx (rows, C) of dtype; stats the forward's; dweight,
// dbias (C,) float32 out; partial (2, blocks, C) float32 scratch.
int bn_relu_train_backward(const void* dy, const void* x, const float* stats,
                           const float* weight, const float* bias, void* dx,
                           float* dweight, float* dbias, float* partial,
                           int dtype, int64_t rows, int C, int vec,
                           int row_lanes, int64_t per_block, int blocks,
                           void* stream) {
  const bnrelu::Plan p =
      bnrelu::make_plan(rows, C, vec, row_lanes, per_block, blocks);
  if (!bnrelu::plan_ok(p, vec)) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return bnrelu::dispatch(dtype, vec, [&](auto t, auto v) {
    return bnrelu::backward_launch<decltype(t), decltype(v)::value>(
        dy, x, stats, weight, bias, dx, dweight, dbias, partial, p, s);
  });
}

}  // extern "C"
