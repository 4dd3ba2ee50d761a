// The quantization and the rescale around the W8A8 int8 product (H1, H2)
// for Hopper.
//
// Not the port of a Pallas kernel: the JAX package writes the int8 linears
// of diffusion_pipe_tpu/models/layers.py (int8_dot, int8_dot_bwd8,
// int8_pq_dot, int8_pq_dot_bwd8) as plain array code, which XLA fuses
// around its int8 dot_general. In PyTorch each of those passes would be its
// own launch (abs, amax, divide, maximum, divide, round, clamp, cast; two
// multiplies and a cast), so the two fused passes are written here and the
// product between them is torch._int_mm (cuBLASLt).
//
// H1 dpt_quant_rows: per row of x [M, K] (bf16 or f32, row stride ld),
// optionally times a per-column f32 vector c first (the fold of the weight's
// column scales into the cotangent in int8_pq_dot_bwd8):
//
//   v     = f32(x[m, k]) * c[k]
//   s[m]  = max_k |v| / 127            (IEEE division)
//   x8    = clamp(rint(v / max(s[m], 1e-12)), -127, 127)   as int8
//
// the JAX expression operand for operand: a true division (no reciprocal;
// the build has no fast-math), rint rounds half to even like jnp.round, and
// a NaN anywhere in the row makes s[m] NaN as jnp.max does. So H1 gives the
// same bits as its plain version (ops/int8_quant.py) on finite inputs.
//
// H2 dpt_rescale_i32: y [M, N] int32 (row stride ld) to
//   out[m, n] = (f32(y[m, n]) * r[m]) * c[n]     cast to bf16, fp16 or f32
// with r and c optional (a missing scale multiplies by 1, which is exact),
// the JAX rescale `y32.astype(f32) * x_scale * w_scale` in that order, and
// the cast the JAX LoraDense applies to the f32 result.
//
// What bounds them on the H100: one pass each, a few operations a byte, so
// device-memory bandwidth: H1 reads M*K*sizeof(x) and writes M*K + 4M bytes
// (it reads the row twice, the second time from L1/L2); H2 reads 4MN and
// writes MN*sizeof(out). At Flux's ff_in (M 2048, K 3072, bf16) H1 moves
// 18.9 MB, 5.6 us at 3.35 TB/s.
//
// Design. H1: one block of 256 threads a row; each thread takes 8 elements
// a step as 16-byte vectors (x) and writes 8 bytes; a NaN-propagating
// absmax over the warp by shuffles and over the block through shared
// memory; then the second pass. K must be a multiple of 8 with 16-byte
// aligned rows and column vector (the wrapper checks; torch._int_mm needs
// K % 8 == 0 anyway).
// H2: a grid of (column blocks, rows), 4 int32 a thread a step as one
// 16-byte vector, N a multiple of 4 with 16-byte aligned rows.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpt {

constexpr int kQuantThreads = 256;
constexpr int kRescaleThreads = 256;

// max(m, a) that keeps a NaN once one is seen (jnp.max propagates NaN)
__device__ __forceinline__ float nan_max(float m, float a) {
  return (a > m || a != a) ? a : m;
}

__device__ __forceinline__ void load8(const float* x, long long i, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(x + i);
  const float4 b = *reinterpret_cast<const float4*>(x + i + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* x, long long i, float v[8]) {
  union {
    uint4 u;
    __nv_bfloat16 h[8];
  } w;
  w.u = *reinterpret_cast<const uint4*>(x + i);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(w.h[j]);
}

// v[j] *= col[k + j] for 8 columns, col read as two 16-byte vectors
__device__ __forceinline__ void scale8(const float* col, long long k, float v[8]) {
  float c[8];
  load8(col, k, c);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] *= c[j];
}

template <typename T>
__global__ void __launch_bounds__(kQuantThreads)
    quant_rows_kernel(const T* __restrict__ x, long long ld, const float* __restrict__ col,
                      int8_t* __restrict__ out, float* __restrict__ scale, int K) {
  __shared__ float warp_max[kQuantThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * ld;
  float m = 0.0f;
  for (int k = threadIdx.x * 8; k < K; k += kQuantThreads * 8) {
    float v[8];
    load8(xr, k, v);
    if (col) scale8(col, k, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = nan_max(m, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kQuantThreads / 32; ++w) m = nan_max(m, warp_max[w]);

  const float s = m / 127.0f;
  const float d = s < 1e-12f ? 1e-12f : s;  // max(s, 1e-12) keeping a NaN s
  int8_t* orow = out + row * K;
  for (int k = threadIdx.x * 8; k < K; k += kQuantThreads * 8) {
    float v[8];
    load8(xr, k, v);
    if (col) scale8(col, k, v);
    union {
      uint2 u;
      int8_t b[8];
    } q;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float r = rintf(v[j] / d);
      q.b[j] = static_cast<int8_t>(fminf(fmaxf(r, -127.0f), 127.0f));
    }
    *reinterpret_cast<uint2*>(orow + k) = q.u;
  }
  if (threadIdx.x == 0) scale[row] = s;
}

__device__ __forceinline__ void store4(float* o, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* o, float a, float b, float c, float d) {
  union {
    uint2 u;
    __nv_bfloat162 h[2];
  } w;
  w.h[0] = __floats2bfloat162_rn(a, b);
  w.h[1] = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(o) = w.u;
}

__device__ __forceinline__ void store4(__half* o, float a, float b, float c, float d) {
  union {
    uint2 u;
    __half2 h[2];
  } w;
  w.h[0] = __floats2half2_rn(a, b);
  w.h[1] = __floats2half2_rn(c, d);
  *reinterpret_cast<uint2*>(o) = w.u;
}

template <typename O>
__global__ void __launch_bounds__(kRescaleThreads)
    rescale_kernel(const int32_t* __restrict__ y, long long ld, const float* __restrict__ rs,
                   const float* __restrict__ cs, O* __restrict__ out, int M, int N) {
  const int nvec = N / 4;
  for (int row = blockIdx.y; row < M; row += gridDim.y) {
    const float r = rs ? rs[row] : 1.0f;
    const int32_t* yr = y + static_cast<long long>(row) * ld;
    O* orow = out + static_cast<long long>(row) * N;
    for (int c = blockIdx.x * kRescaleThreads + threadIdx.x; c < nvec;
         c += gridDim.x * kRescaleThreads) {
      const int4 v = *reinterpret_cast<const int4*>(yr + 4 * c);
      const float4 s = cs ? *reinterpret_cast<const float4*>(cs + 4 * c)
                          : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
      store4(orow + 4 * c, __int2float_rn(v.x) * r * s.x, __int2float_rn(v.y) * r * s.y,
             __int2float_rn(v.z) * r * s.z, __int2float_rn(v.w) * r * s.w);
    }
  }
}

}  // namespace dpt

// H1. x: M rows of K values (f32 if x_is_f32 else bf16), row stride ld
// elements; col: K f32 or null; out: M x K int8, contiguous; scale: M f32.
// K % 8 == 0, x, every row and col 16-byte aligned. Returns the cudaError_t.
extern "C" int dpt_quant_rows(const void* x, int x_is_f32, long long ld, const float* col,
                              int8_t* out, float* scale, int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_f32) {
    dpt::quant_rows_kernel<float><<<M, dpt::kQuantThreads, 0, s>>>(
        static_cast<const float*>(x), ld, col, out, scale, K);
  } else {
    dpt::quant_rows_kernel<__nv_bfloat16><<<M, dpt::kQuantThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), ld, col, out, scale, K);
  }
  return static_cast<int>(cudaGetLastError());
}

// H2. y: M x N int32, row stride ld; rs: M f32 or null; cs: N f32 or null;
// out: M x N contiguous, out_kind 0 = f32, 1 = bf16, 2 = fp16. N % 4 == 0,
// y and every row 16-byte aligned. Returns the cudaError_t.
extern "C" int dpt_rescale_i32(const int32_t* y, long long ld, const float* rs,
                               const float* cs, void* out, int out_kind, int M, int N,
                               void* stream) {
  if (M <= 0 || N <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nvec = N / 4;
  int gx = (nvec + dpt::kRescaleThreads - 1) / dpt::kRescaleThreads;
  const dim3 grid(gx, M < 65535 ? M : 65535);
  if (out_kind == 0) {
    dpt::rescale_kernel<float><<<grid, dpt::kRescaleThreads, 0, s>>>(
        y, ld, rs, cs, static_cast<float*>(out), M, N);
  } else if (out_kind == 1) {
    dpt::rescale_kernel<__nv_bfloat16><<<grid, dpt::kRescaleThreads, 0, s>>>(
        y, ld, rs, cs, static_cast<__nv_bfloat16*>(out), M, N);
  } else {
    dpt::rescale_kernel<__half><<<grid, dpt::kRescaleThreads, 0, s>>>(
        y, ld, rs, cs, static_cast<__half*>(out), M, N);
  }
  return static_cast<int>(cudaGetLastError());
}
