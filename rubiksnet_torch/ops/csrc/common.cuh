// Device code shared by the port's kernels (shift2d.cu, shift3d_bwd.cu,
// fused_block.cu, fused_block_tc.cu, fused_entry.cu, se_gate.cuh): dtype
// conversions, the per-axis taps of the shifts, a tiled GEMM whose operand
// loads and output stores are functors, and the loaders and stores the
// fused kernels plug into it.
//
// The GEMM here is the simple form: a block keeps its rows' whole A tile in
// shared memory and runs 64-wide column tiles against it, with 16-deep B
// slabs loaded one slab ahead; 128 threads each hold a 4x4 f32 accumulator
// (SIMT FMA). Its A loader is where the fused kernels put
// their prologues (bn/relu, the shift gather) and its store functor is
// where they put their epilogues (bn/relu, residual add), so neither
// intermediate makes an extra pass over device memory. It serves K2
// (fused_block.cu) and K3 (fused_entry.cu) in float32, where the products
// must stay full f32. What bounds it on the H100 is a serial chain per block,
// not arithmetic or bytes: scalar loads, two barriers per 16-deep slab of A
// and of B with nothing in flight across them, the weights re-read by every
// block through registers, the gather's nested loops. K2 and K3 in bfloat16
// left it for fused_block_tc.cu and fused_entry_tc.cu (tensor cores,
// resident weights, 16-byte loads: tc_core.cuh), which took that chain away.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rubiks {

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <class T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T's precision: the value a matmul operand of type T holds.
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The cells one axis of a trilinear shift reads, with their weights; an
// index of -1 marks a tap that reads nothing (outside the source, or a zero
// weight).
struct AxisTaps {
  int idx[2];
  float w[2];
};

// Four consecutive values p[0..3] (p 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}

constexpr int kBM = 32, kBN = 64, kBK = 16, kThreads = 128;
constexpr int kMaxTaps = 16;  // taps per axis, 2K+2 for K <= 7
constexpr int kAStride = kBM + 4;  // A row stride: aligned rows, 2-way banks

// out[m, n] = sum_k A(m, k) * B(k, n) for m < M, n < N, k < K, handed to
// epi(m, n, acc). The tile edges are zero-filled here, so K and N need not
// be multiples of the tile (C = 72 or 54 is not a multiple of 16).
//
// A block owns kBM rows. It loads their whole A tile (kBM x K) into shared
// memory once, in the operand type T, then runs its
// 64-wide column tiles against it: the A loader's work (the shift gather)
// is done once per element, not once per column tile. grid.y splits the
// column tiles only when there are too few row tiles to keep the SMs busy
// (small batches); each split redoes the A tile.
//
// An A loader has a Shared type (block-wide state in shared memory),
// rows(sh, m0, M) called once per block and slab(sh, k0) once per 16-deep
// K slab by every thread (a barrier follows each), and
// operator()(sh, mm, m, kk, k) = A(m, k), called only in range, where
// mm = m - m0 and kk = k - k0 index the tile.
template <class T, class ALoad, class BLoad, class Epi>
__global__ void __launch_bounds__(kThreads)
    gemm_kernel(int64_t M, int N, int K, int tiles_per_y, ALoad aload,
                BLoad bload, Epi epi) {
  extern __shared__ float4 a_smem[];
  T* As = reinterpret_cast<T*>(a_smem);  // [Kp][kAStride]
  __shared__ __align__(16) float Bs[kBK][kBN];
  __shared__ typename ALoad::Shared ash;
  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;

  aload.rows(ash, m0, M);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    aload.slab(ash, k0);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int i = tid + r * kThreads;
      const int kk = i % kBK, mm = i / kBK;
      const int64_t m = m0 + mm;
      const int k = k0 + kk;
      As[k * kAStride + mm] =
          from_f32<T>((m < M && k < K) ? aload(ash, mm, m, kk, k) : 0.f);
    }
    __syncthreads();
  }

  const int tx = tid % 16, ty = tid / 16;  // 4 columns x 4 rows each
  const int n_tiles = (N + kBN - 1) / kBN;
  const int t_end = min((int)blockIdx.y * tiles_per_y + tiles_per_y, n_tiles);
  for (int tile = blockIdx.y * tiles_per_y; tile < t_end; ++tile) {
    const int n0 = tile * kBN;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    // B slabs are loaded one slab ahead into registers, so the global
    // loads of slab k0 + kBK overlap the multiply-adds of slab k0.
    constexpr int kBPer = (kBK * kBN) / kThreads;
    float bnext[kBPer];
    auto load_b = [&](int k0) {
#pragma unroll
      for (int r = 0; r < kBPer; ++r) {
        const int i = tid + r * kThreads;
        const int n = n0 + i % kBN, k = k0 + i / kBN;
        bnext[r] = (n < N && k < K) ? bload(k, n) : 0.f;
      }
    };
    load_b(0);
    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int r = 0; r < kBPer; ++r) {
        const int i = tid + r * kThreads;
        Bs[i / kBN][i % kBN] = bnext[r];
      }
      __syncthreads();
      if (k0 + kBK < K) load_b(k0 + kBK);
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float av[4], bv[4];
        load4(&As[(k0 + kk) * kAStride + ty * 4], av);
        load4(&Bs[kk][tx * 4], bv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t m = m0 + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx * 4 + j;
        if (n < N) epi(m, n, acc[i][j]);
      }
    }
  }
}

inline int sm_count() {
  static const int count = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return count;
}

// Launch the GEMM with A held in shared memory as T.
template <class T, class ALoad, class BLoad, class Epi>
inline cudaError_t launch_gemm(int64_t M, int N, int K, ALoad aload,
                               BLoad bload, Epi epi, cudaStream_t stream) {
  const int64_t row_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  // Aim for 4 blocks per SM; each column split redoes the A tile.
  const int64_t want = (4LL * sm_count() + row_tiles - 1) / row_tiles;
  int ny = (int)(want < n_tiles ? want : n_tiles);
  const int per_y = (n_tiles + ny - 1) / ny;
  ny = (n_tiles + per_y - 1) / per_y;
  const size_t smem =
      (size_t)((K + kBK - 1) / kBK * kBK) * kAStride * sizeof(T);
  auto kernel = gemm_kernel<T, ALoad, BLoad, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)row_tiles, ny), kThreads, smem, stream>>>(
      M, N, K, per_y, aload, bload, epi);
  return cudaGetLastError();
}

struct NoShared {};

// A(m, k) = relu(scale[k] * x[m, k] + bias[k]) as a T operand: the folded
// bn1 + relu prologue of both fused kernels' first GEMM.
template <class T>
struct BnReluLoad {
  using Shared = NoShared;
  const T* x;
  const float* scale;
  const float* bias;
  int C;
  __device__ __forceinline__ void rows(Shared&, int64_t, int64_t) const {}
  __device__ __forceinline__ void slab(Shared&, int) const {}
  __device__ __forceinline__ float operator()(const Shared&, int, int64_t m,
                                              int, int k) const {
    const float v = fmaf(__ldg(scale + k), to_f32(x[m * C + k]),
                         __ldg(bias + k));
    return round_to<T>(fmaxf(v, 0.f));
  }
};

// Shared state of AqBnReluLoad: each tile row's frame index t.
struct AqShared {
  int t[kBM];
};

// The rubiks3d-aq prologue: with r = relu(scale . x + bias) as a T operand,
//   A(m, k) = w0[k] r[t-1] + w1[k] r[t] + w2[k] r[t+1]
// along the T axis of x (N, T, H, W, C), zero boundary frames (frame 0 of a
// clip never reads the clip before it: t comes from the row's (n, t, h, w)
// position, not from the flat row index), summed in f32 and rounded to T.
// aw: (3, C) attention taps.
template <class T>
struct AqBnReluLoad {
  using Shared = AqShared;
  const T* x;
  const float* scale;
  const float* bias;
  const float* aw;
  int C, T_, HW;
  __device__ __forceinline__ void rows(Shared& sh, int64_t m0,
                                       int64_t M) const {
    for (int i = threadIdx.x; i < kBM; i += blockDim.x) {
      const int64_t m = m0 + i < M ? m0 + i : M - 1;
      sh.t[i] = (int)((m / HW) % T_);
    }
  }
  __device__ __forceinline__ void slab(Shared&, int) const {}
  __device__ __forceinline__ float act(int64_t m, int k, float s,
                                       float b) const {
    return round_to<T>(fmaxf(fmaf(s, to_f32(x[m * C + k]), b), 0.f));
  }
  __device__ __forceinline__ float operator()(const Shared& sh, int mm,
                                              int64_t m, int, int k) const {
    const float s = __ldg(scale + k), b = __ldg(bias + k);
    const int t = sh.t[mm];
    float acc = 0.f;
    if (t > 0) acc = __ldg(aw + k) * act(m - HW, k, s, b);
    acc = fmaf(__ldg(aw + C + k), act(m, k, s, b), acc);
    if (t < T_ - 1) acc = fmaf(__ldg(aw + 2 * C + k), act(m + HW, k, s, b), acc);
    return round_to<T>(acc);
  }
};

// B(k, n) of a row-major (K, N) weight matrix (the 1x1 conv as (in, out)).
template <class T>
struct WeightLoad {
  const T* w;
  int N;
  __device__ __forceinline__ float operator()(int k, int n) const {
    return to_f32(w[(int64_t)k * N + n]);
  }
};

// out[m, n] = relu(scale[n] * acc + bias[n]): the folded bn2 + relu
// epilogue of the first GEMM.
template <class T>
struct BnReluStore {
  T* out;
  const float* scale;
  const float* bias;
  int N;
  __device__ __forceinline__ void operator()(int64_t m, int n,
                                             float acc) const {
    out[m * N + n] =
        from_f32<T>(fmaxf(fmaf(__ldg(scale + n), acc, __ldg(bias + n)), 0.f));
  }
};

// Shared state of ShiftLoad: each tile row's position, and the K slab's
// tap weights with the range [lo, hi] of non-zero taps per axis.
struct ShiftShared {
  int nt[kBM];  // n * T
  int t[kBM], h[kBM], w[kBM];  // output row's centre in mid coordinates
  float taps[3 * kMaxTaps][kBK];
  int lo[3][kBK], hi[3][kBK];
};

// A(m, k) = the shifted mid activation as a T operand, for output row m of
// an (N, T, Ho, Wo) grid sampling mid (N, T, H, W, C) at (t, S*ho, S*wo):
//   sum_{jt,jh,jw} wT[jt] wH[jh] wW[jw] mid[n, t+jt-K, S*ho+jh-K, S*wo+jw-K, k]
// with zero outside mid. taps holds 3*taps_n rows of C weights (T, then H,
// then W; tap j reads offset j-K), the layout of the JAX package's
// conv_backend._shift_kernel. Only the non-zero tap range of each axis is
// visited: two taps for a fractional shift, one for a quantized one, the
// same count in every lane of a warp. Row positions are decomposed once per
// block and the slab's taps staged once per slab, in shared memory. With a
// gate (N*T, C) f32 (the SE tiers, se_gate.cuh) the f32 sum is multiplied by
// gate[n * T + t, k] before it is rounded to T.
template <class T>
struct ShiftLoad {
  using Shared = ShiftShared;
  const T* mid;
  const float* taps;
  int T_, H, W, C, Ho, Wo, S, taps_n, K;
  const float* gate;  // nullptr: no SE

  __device__ __forceinline__ void rows(Shared& sh, int64_t m0,
                                       int64_t M) const {
    for (int i = threadIdx.x; i < kBM; i += blockDim.x) {
      const int64_t m = m0 + i < M ? m0 + i : M - 1;
      const int wo = (int)(m % Wo);
      const int64_t r = m / Wo;
      const int ho = (int)(r % Ho);
      const int nt = (int)(r / Ho);  // n * T + t
      sh.t[i] = nt % T_;
      sh.nt[i] = nt - sh.t[i];
      sh.h[i] = S * ho;
      sh.w[i] = S * wo;
    }
  }

  __device__ __forceinline__ void slab(Shared& sh, int k0) const {
    for (int i = threadIdx.x; i < 3 * taps_n * kBK; i += blockDim.x) {
      const int row = i / kBK, kk = i % kBK, k = k0 + kk;
      sh.taps[row][kk] = k < C ? __ldg(taps + row * C + k) : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * kBK; i += blockDim.x) {
      const int a = i / kBK, kk = i % kBK;
      int lo = taps_n, hi = -1;
      for (int j = 0; j < taps_n; ++j) {
        if (sh.taps[a * taps_n + j][kk] != 0.f) {
          lo = j < lo ? j : lo;
          hi = j;
        }
      }
      sh.lo[a][kk] = lo;
      sh.hi[a][kk] = hi;
    }
  }

  __device__ __forceinline__ float operator()(const Shared& sh, int mm,
                                              int64_t, int kk, int k) const {
    const int t = sh.t[mm], h0 = sh.h[mm], w0 = sh.w[mm], nt = sh.nt[mm];
    float acc = 0.f;
    for (int jt = sh.lo[0][kk]; jt <= sh.hi[0][kk]; ++jt) {
      const int ti = t + jt - K;
      if (ti < 0 || ti >= T_) continue;
      const float a = sh.taps[jt][kk];
      for (int jh = sh.lo[1][kk]; jh <= sh.hi[1][kk]; ++jh) {
        const int hi = h0 + jh - K;
        if (hi < 0 || hi >= H) continue;
        const float ab = a * sh.taps[taps_n + jh][kk];
        const T* row = mid + ((int64_t)((nt + ti) * H + hi) * W) * C + k;
        for (int jw = sh.lo[2][kk]; jw <= sh.hi[2][kk]; ++jw) {
          const int wi = w0 + jw - K;
          if (wi < 0 || wi >= W) continue;
          acc = fmaf(ab * sh.taps[2 * taps_n + jw][kk],
                     to_f32(row[(int64_t)wi * C]), acc);
        }
      }
    }
    if (gate != nullptr) acc *= __ldg(gate + (int64_t)(nt + t) * C + k);
    return round_to<T>(acc);
  }
};

}  // namespace rubiks
