// Shared pieces of the three flash-attention kernels (forward, dQ, dK/dV)
// that are not Hopper-specific: the log2 e and mask-value constants, the
// rounding of two f32 values to a packed pair of the input type (the A
// fragment of a register-operand wgmma), and the sums and maxima over the
// four threads that share an accumulator row. The Hopper pieces (TMA,
// mbarriers, wgmma) are in hopper_common.cuh.
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

}  // namespace dpt
