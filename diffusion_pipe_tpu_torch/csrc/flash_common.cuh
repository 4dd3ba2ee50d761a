// Shared pieces of the three flash-attention kernels (forward, dQ, dK/dV).
//
// Tensor-core products are `mma.sync.m16n8k16` on bf16 or fp16 tiles with
// f32 accumulation: each warp owns 16 rows of the block's tile and loops
// over 8-column slices. Operands are staged in shared memory with a row
// pitch padded by 8 elements, so the 32-bit fragment reads of one warp fall
// on 32 distinct banks. Tiles are read from device memory in 16-byte
// vectors through the caller's strides ([B, S, H, D] with D contiguous) and
// rows past the sequence end are filled with zeros; the kernels mask those
// rows themselves, so any sequence length works without padding.
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

// d += a * b for one 16x8x16 tile; a in row layout, b in column layout.
template <typename T>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ uint32_t ld32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// smem[r][c] = g[r * row_stride + c] for r < ROWS, c < COLS; rows at or past
// `valid_rows` are zero. 16-byte vectors: COLS % 8 == 0, rows 16-byte aligned.
template <typename T, int ROWS, int COLS, int LD, int NTH>
__device__ __forceinline__ void load_rows(T* smem, const T* g,
                                          int64_t row_stride, int valid_rows) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTH) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      val = *reinterpret_cast<const uint4*>(g + r * row_stride + c);
    }
    *reinterpret_cast<uint4*>(smem + r * LD + c) = val;
  }
}

// smem_t[c][r] = g[r * row_stride + c]: the same tile, stored transposed.
template <typename T, int ROWS, int COLS, int LDT, int NTH>
__device__ __forceinline__ void load_rows_transposed(T* smem_t, const T* g,
                                                     int64_t row_stride,
                                                     int valid_rows) {
  constexpr int kChunks = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += NTH) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid_rows) {
      val = *reinterpret_cast<const uint4*>(g + r * row_stride + c);
    }
    const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) smem_t[(c + j) * LDT + r] = e[j];
  }
}

// acc[n] += A[16 x K] * B[NT*8 x K]^T for one warp. A and B are row-major in
// shared memory with pitches lda and ldb. acc is in the accumulator layout of
// m16n8k16: acc[n][0..1] -> row g, cols n*8 + 2t + {0,1}; acc[n][2..3] -> row
// g + 8 (g = lane / 4, t = lane % 4).
template <typename T, int NT, int K>
__device__ __forceinline__ void warp_mma_smem(float (&acc)[NT][4], const T* A,
                                              int lda, const T* B, int ldb,
                                              int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t a[4];
    a[0] = ld32(A + g * lda + kk + 2 * t);
    a[1] = ld32(A + (g + 8) * lda + kk + 2 * t);
    a[2] = ld32(A + g * lda + kk + 8 + 2 * t);
    a[3] = ld32(A + (g + 8) * lda + kk + 8 + 2 * t);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* bp = B + (n * 8 + g) * ldb + kk + 2 * t;
      mma16816<T>(acc[n], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// acc[n] += P[16 x 16*KS] * B[NT*8 x 16*KS]^T where P is a warp's f32 tile in
// the accumulator layout (as warp_mma_smem leaves it), rounded to T here.
template <typename T, int NT, int KS>
__device__ __forceinline__ void warp_mma_regs(float (&acc)[NT][4],
                                              const float (&p)[2 * KS][4],
                                              const T* B, int ldb, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t a[4];
    a[0] = Elem<T>::pack(p[2 * j][0], p[2 * j][1]);
    a[1] = Elem<T>::pack(p[2 * j][2], p[2 * j][3]);
    a[2] = Elem<T>::pack(p[2 * j + 1][0], p[2 * j + 1][1]);
    a[3] = Elem<T>::pack(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const T* bp = B + (n * 8 + g) * ldb + 16 * j + 2 * t;
      mma16816<T>(acc[n], a, ld32(bp), ld32(bp + 8));
    }
  }
}

// Writes a warp's [16 x NT*8] accumulator tile, rounded to T, to rows
// row0 + {g, g + 8} of a row-major destination (rows >= nrows skipped).
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* dst, int64_t row_stride,
                                           int row0, int nrows,
                                           const float (&acc)[NT][4],
                                           float scale0, float scale1,
                                           int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = row0 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < nrows) {
      *reinterpret_cast<uint32_t*>(dst + r0 * row_stride + c) =
          Elem<T>::pack(acc[n][0] * scale0, acc[n][1] * scale0);
    }
    if (r1 < nrows) {
      *reinterpret_cast<uint32_t*>(dst + r1 * row_stride + c) =
          Elem<T>::pack(acc[n][2] * scale1, acc[n][3] * scale1);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Strides are in elements; q/k/v/do are [B, S, H, D] with D contiguous.
struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* mask;  // [B, Skv], nonzero = valid key; may be null
  const float* lse;  // [B, H, Sq], natural log
  const float* di;   // [B, H, Sq], rowsum(dO * O)
  void* out0;        // O or dQ or dK, contiguous [B, S, H, D]
  void* out1;        // dV, contiguous [B, Skv, H, D]
  float* lse_out;    // [B, H, Sq]
  int b, h, sq, skv;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t do_sb, do_ss, do_sh;
  int64_t mask_sb;
  float scale;
};

template <typename Kernel>
inline cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem,
                          cudaStream_t stream, const AttnArgs& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace dpt
