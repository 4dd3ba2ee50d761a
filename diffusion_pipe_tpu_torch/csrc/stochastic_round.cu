// Stochastic rounding of a bf16 parameter update (K4) for Hopper.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/quant.py `_sr_kernel`
// (launched by `stochastic_round`), fused with the add that precedes it in
// diffusion_pipe_tpu/training/trainer.py `_apply_updates`:
//
//   p <- SR(f32(p) + f32(u))   in place, p bf16, u bf16 or f32.
//
// SR adds 16 random bits to the low half of x's f32 bit pattern and
// truncates to bf16, so x rounds away from zero with probability equal to
// its distance from the bf16 value below it over the gap. NaN becomes the
// bf16 NaN 0x7FC0; +-Inf and values exact in bf16 come out unchanged (their
// low half is zero, so the add never carries). The TPU kernel draws its bits
// from the hardware PRNG seeded per call; here they are a counter-based hash
// of (seed, element index): murmur3's fmix32 of (index xor key), with
// key = fmix32(seed + 0x9E3779B9). ops/quant.py computes the same bits with
// integer tensor ops, so this kernel and its plain version agree bit for bit.
//
// What bounds it on the H100: one pass over the tensor, 2 + sizeof(u) + 2
// bytes and one f32 add per element (plus ~12 integer operations for the
// hash), so device-memory bandwidth bounds it: 82.6 MB at the largest
// Wan2.1-1.3B leaf (ffn_in, 8960 x 1536, bf16 u), 25 us at 3.35 TB/s.
//
// Design: an elementwise grid-stride loop, 8 elements a thread a step, moved
// as 16-byte vectors (one for p, one or two for u); the n % 8 tail is one
// element a thread. The grid is at most 8 blocks of 256 threads an SM.
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpt {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ float bf16_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// the bf16 bit pattern of SR(x) for element `idx`
__device__ __forceinline__ uint16_t round_bits(float x, uint32_t idx, uint32_t key) {
  if (x != x) return 0x7FC0u;
  const uint32_t r = fmix32(idx ^ key) & 0xFFFFu;
  return static_cast<uint16_t>((__float_as_uint(x) + r) >> 16);
}

union Pack8 {
  uint4 v;
  uint16_t h[8];
};

__device__ __forceinline__ void load8(const float* u, long long vec, float out[8]) {
  const float4 a = reinterpret_cast<const float4*>(u)[2 * vec];
  const float4 b = reinterpret_cast<const float4*>(u)[2 * vec + 1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void load8(const uint16_t* u, long long vec, float out[8]) {
  Pack8 w;
  w.v = reinterpret_cast<const uint4*>(u)[vec];
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = bf16_to_float(w.h[j]);
}

__device__ __forceinline__ float load1(const float* u, long long i) { return u[i]; }
__device__ __forceinline__ float load1(const uint16_t* u, long long i) {
  return bf16_to_float(u[i]);
}

// U = float (f32 update) or uint16_t (bf16 update, as its bit pattern)
template <typename U>
__global__ void __launch_bounds__(kThreads)
    sr_add_kernel(uint16_t* __restrict__ p, const U* __restrict__ u, long long n,
                  uint32_t seed) {
  const uint32_t key = fmix32(seed + 0x9E3779B9u);
  const long long nvec = n / 8;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long vec = tid; vec < nvec; vec += stride) {
    Pack8 pw;
    pw.v = reinterpret_cast<const uint4*>(p)[vec];
    float uf[8];
    load8(u, vec, uf);
    const uint32_t base = static_cast<uint32_t>(vec * 8);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      pw.h[j] = round_bits(bf16_to_float(pw.h[j]) + uf[j], base + j, key);
    reinterpret_cast<uint4*>(p)[vec] = pw.v;
  }
  const long long i = nvec * 8 + tid;  // the ragged tail, n % 8 elements
  if (i < n) {
    p[i] = round_bits(bf16_to_float(p[i]) + load1(u, i), static_cast<uint32_t>(i), key);
  }
}

int grid_for(long long n) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  const long long vecs = (n + 7) / 8;
  long long blocks = (vecs + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace dpt

// p: n bf16 values, updated in place; u: n values, f32 if u_is_f32 else bf16.
// Both 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int dpt_sr_add(void* p, const void* u, long long n, int u_is_f32,
                          uint32_t seed, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int grid = dpt::grid_for(n);
  uint16_t* pp = static_cast<uint16_t*>(p);
  if (u_is_f32) {
    dpt::sr_add_kernel<float><<<grid, dpt::kThreads, 0, s>>>(
        pp, static_cast<const float*>(u), n, seed);
  } else {
    dpt::sr_add_kernel<uint16_t><<<grid, dpt::kThreads, 0, s>>>(
        pp, static_cast<const uint16_t*>(u), n, seed);
  }
  return static_cast<int>(cudaGetLastError());
}
