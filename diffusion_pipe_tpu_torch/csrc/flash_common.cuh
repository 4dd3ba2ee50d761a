// Shared pieces of the three flash-attention kernels (forward, dQ, dK/dV)
// that are not Hopper-specific: the log2 e and mask-value constants, the
// rounding of two f32 values to a packed pair of the input type (the A
// fragment of a register-operand wgmma), the sums and maxima over the four
// threads that share an accumulator row, and the store of an accumulator's
// rows. The Hopper pieces (TMA, mbarriers, wgmma) are in hopper_common.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dpt {

constexpr float kLog2e = 1.4426950408889634f;
// Natural-log LSE written for a query row that has no valid key.
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

// The head dims the kernels take: 64, 128 and 256 at their own tiles; 96
// and 120 on the D 128 tiles, the columns past D zero-filled by TMA (kPad).
inline bool kernel_head_dim(int hd) {
  return hd == 64 || hd == 96 || hd == 120 || hd == 128 || hd == 256;
}

template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Writes rows r0, r0 + 8 (when < nrows) of a warp's slice of a 64-row wgmma
// accumulator of N columns, as T; under kPad only its first ncols columns
// (a multiple of 8).
template <typename T, int N, bool kPad = false>
__device__ __forceinline__ void store_acc(T* dst, int64_t row_stride, int r0, int nrows,
                                          const float (&acc)[N / 2], int t, int ncols = N) {
#pragma unroll
  for (int i = 0; i < N / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (kPad && c >= ncols) continue;
    if (r0 < nrows)
      *reinterpret_cast<uint32_t*>(dst + r0 * row_stride + c) =
          Elem<T>::pack(acc[4 * i], acc[4 * i + 1]);
    if (r0 + 8 < nrows)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * row_stride + c) =
          Elem<T>::pack(acc[4 * i + 2], acc[4 * i + 3]);
  }
}

}  // namespace dpt
