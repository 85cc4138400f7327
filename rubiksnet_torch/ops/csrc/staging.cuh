// Staging of source rows in a shared-memory ring, shared by the kernels
// that walk a band of destination rows with one channel per thread
// (shift2d.cu, the 2D shift; shift3d_bwd.cu, the 3D shift's backward): the
// ring's geometry (slot of a source row, rows that must be live at once,
// how far the copies may run ahead) and the copies (16-byte and 4-byte
// cp.async, 2-byte plain loads), one source row of a channel group at a
// time.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rubiks {

constexpr int kMaxSmem = 232448;  // bytes a block can use on the H100
constexpr float kFloorClamp = 1.0e9f;
constexpr int kMaxAhead = 8;  // rows the copies may run ahead (cp_wait)

// Bytes from one ring row to the next: the row, rounded up to the 16 bytes
// of a copy. (Padding rows to start 16 banks apart was measured: no change.)
__host__ __device__ inline int ring_pitch(int row_bytes) {
  return (row_bytes + 15) & ~15;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  if (b == 1) return a;  // the forward, and stride 1: no division
  const int q = a / b;
  return (a % b != 0 && (a < 0)) ? q - 1 : q;
}

// Integer floor of a shift, clamped so that coordinate sums stay in int.
__device__ __forceinline__ float clamped_floor(float s) {
  return fminf(fmaxf(floorf(s), -kFloorClamp), kFloorClamp);
}

// q mod D for a source row q < 2^32 / D (a frame has fewer rows), by the
// multiplicative inverse inv = 2^32 / D + 1.
__device__ __forceinline__ int ring_slot(int q, int D, unsigned inv) {
  return q - D * (int)__umulhi((unsigned)q, inv);
}

// Ring rows that must be live at once for a floor range of `span`: the rows
// of destination row r and those r + 1 adds.
__device__ __forceinline__ int ring_need(int span, int mul, int div) {
  return (mul + span + 1) / div + 1;
}

// How many destination rows ahead of the one being computed a ring of D
// rows lets the copies run: rows [lo(r), hi(r + ahead)] fit it.
__device__ __forceinline__ int ring_ahead(int span, int mul, int div, int D) {
  return (D * div - span - 2) / mul;
}

template <int CB>
__device__ __forceinline__ void copy_in(char* smem, const char* gmem) {
  if constexpr (CB == 16) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                 "l"(gmem)
                 : "memory");
  } else if constexpr (CB == 4) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d),
                 "l"(gmem)
                 : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(smem) =
        *reinterpret_cast<const uint16_t*>(gmem);
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait until at most `pending` (< kMaxAhead) of the newest groups are in
// flight.
__device__ __forceinline__ void cp_wait(int pending) {
  switch (pending) {
    case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;" ::: "memory"); break;
    case 7: asm volatile("cp.async.wait_group 7;" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
  }
}

// One source row of a channel group from device memory into shared memory,
// in CB-byte pieces: `pixels` runs of `run` bytes, `gpitch` bytes apart in
// device memory and `spitch` in shared memory (one run when the group is all
// of C).
template <int CB>
__device__ __forceinline__ void copy_row(char* smem, const char* gmem,
                                         int pixels, int run, int gpitch,
                                         int spitch) {
  const int per = run / CB;
  if (pixels == 1) {
    for (int i = threadIdx.x; i < per; i += blockDim.x)
      copy_in<CB>(smem + i * CB, gmem + i * CB);
    return;
  }
  for (int i = threadIdx.x; i < pixels * per; i += blockDim.x) {
    const int px = i / per, k = (i - px * per) * CB;
    copy_in<CB>(smem + px * spitch + k, gmem + px * gpitch + k);
  }
}

}  // namespace rubiks
