// Flash-attention backward, dQ part (K2), for Hopper.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_dq_kernel` / `_dq_kernel_nomask`, launched by `_flash_backward`.
//
// Recomputes P = exp(scale * Q K^T - LSE) from the stored natural-log LSE,
// then dS = P * (dO V^T - D) * scale and dQ = dS K, with D = rowsum(dO * O)
// computed by the caller. Masked keys get P = 0.
//
// What bounds it on the H100: three products of 2*S^2*D flops per (b, h) --
// 8.7e10 flops at Flux-dev shapes against 38 MB of inputs and output -- so
// the tensor cores bound it (88 us at 989 TFLOP/s).
//
// Design: one thread block per (query tile of 64 rows, head, batch) looping
// over KV tiles of 64, so each block owns its dQ rows and no atomics are
// needed: the result is deterministic. Four warps each hold 16 rows of dQ in
// f32 registers. K is staged twice in shared memory, row-major for Q K^T and
// transposed for dS K, so every mma.sync operand is a 32-bit shared-memory
// read. dS is rounded to the input type for the dS K product, as on the TPU.
#include "flash_common.cuh"

namespace dpt {

template <typename T, int HD>
struct DqTile {
  static constexpr int kBM = 64;
  static constexpr int kBN = 64;
  static constexpr int kThreads = 128;
  static constexpr int kLD = HD + 8;
  static constexpr int kLDT = kBN + 8;
  static constexpr int kSmem =
      (2 * kBM * kLD + 2 * kBN * kLD + HD * kLDT) * (int)sizeof(T) +
      (2 * kBM + kBN) * (int)sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(128) flash_bwd_dq_kernel(AttnArgs a) {
  using C = DqTile<T, HD>;
  constexpr int BM = C::kBM, BN = C::kBN, LD = C::kLD, LDT = C::kLDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sdO = sQ + BM * LD;
  T* sK = sdO + BM * LD;
  T* sV = sK + BN * LD;
  T* sKt = sV + BN * LD;
  float* sLse2 = reinterpret_cast<float*>(sKt + HD * LDT);
  float* sDi = sLse2 + BM;
  int* sValid = reinterpret_cast<int*>(sDi + BM);

  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const int* mask = a.mask ? a.mask + b * a.mask_sb : nullptr;
  const float* lse = a.lse + ((int64_t)b * a.h + h) * a.sq;
  const float* di = a.di + ((int64_t)b * a.h + h) * a.sq;

  const int mvalid = min(BM, a.sq - m0);
  load_rows<T, BM, HD, LD, C::kThreads>(sQ, q + m0 * a.q_ss, a.q_ss, mvalid);
  load_rows<T, BM, HD, LD, C::kThreads>(sdO, dout + m0 * a.do_ss, a.do_ss,
                                        mvalid);
  for (int i = threadIdx.x; i < BM; i += C::kThreads) {
    // rows past the end get P = 0 (LSE = +inf) and D = 0
    sLse2[i] = i < mvalid ? lse[m0 + i] * kLog2e : INFINITY;
    sDi[i] = i < mvalid ? di[m0 + i] : 0.f;
  }
  __syncthreads();
  const int lr0 = warp * 16 + g;
  const float lse2[2] = {sLse2[lr0], sLse2[lr0 + 8]};
  const float dsum[2] = {sDi[lr0], sDi[lr0 + 8]};

  float dq[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float sc = a.scale * kLog2e;

  for (int n0 = 0; n0 < a.skv; n0 += BN) {
    __syncthreads();
    const int nvalid = min(BN, a.skv - n0);
    load_rows<T, BN, HD, LD, C::kThreads>(sK, k + n0 * a.k_ss, a.k_ss, nvalid);
    load_rows<T, BN, HD, LD, C::kThreads>(sV, v + n0 * a.v_ss, a.v_ss, nvalid);
    load_rows_transposed<T, BN, HD, LDT, C::kThreads>(sKt, k + n0 * a.k_ss,
                                                       a.k_ss, nvalid);
    for (int i = threadIdx.x; i < BN; i += C::kThreads) {
      sValid[i] = (i < nvalid) && (mask == nullptr || mask[n0 + i] != 0);
    }
    __syncthreads();

    float s[BN / 8][4];
    float dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      dp[n][0] = dp[n][1] = dp[n][2] = dp[n][3] = 0.f;
    }
    warp_mma_smem<T, BN / 8, HD>(s, sQ + warp * 16 * LD, LD, sK, LD, lane);
    warp_mma_smem<T, BN / 8, HD>(dp, sdO + warp * 16 * LD, LD, sV, LD, lane);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t + (c & 1);
        const int r = c >> 1;
        const float p = sValid[col] ? exp2f(s[n][c] * sc - lse2[r]) : 0.f;
        dp[n][c] = p * (dp[n][c] - dsum[r]) * a.scale;
      }
    }
    warp_mma_regs<T, HD / 8, BN / 16>(dq, dp, sKt, LDT, lane);
  }

  T* out = static_cast<T*>(a.out0) + (int64_t)b * a.sq * a.h * HD + h * HD;
  store_rows<T, HD / 8>(out, (int64_t)a.h * HD, m0 + warp * 16, a.sq, dq, 1.f,
                        1.f, lane);
}

template <typename T, int HD>
cudaError_t run_dq(const AttnArgs& a, cudaStream_t stream) {
  using C = DqTile<T, HD>;
  dim3 grid((a.sq + C::kBM - 1) / C::kBM, a.h, a.b);
  return launch(flash_bwd_dq_kernel<T, HD>, grid, C::kThreads, C::kSmem, stream,
                a);
}

template <typename T>
cudaError_t run_dq_hd(const AttnArgs& a, int hd, cudaStream_t stream) {
  if (hd == 64) return run_dq<T, 64>(a, stream);
  if (hd == 128) return run_dq<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dpt

extern "C" int dpt_flash_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* mask, void* dq, int b, int h,
    int sq, int skv, int hd, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, long long mask_sb, float scale, int is_fp16,
    void* stream) {
  dpt::AttnArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.mask = static_cast<const int*>(mask);
  a.out0 = dq;
  a.b = b;
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.mask_sb = mask_sb;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_fp16 ? dpt::run_dq_hd<__half>(a, hd, s)
                            : dpt::run_dq_hd<__nv_bfloat16>(a, hd, s);
  return static_cast<int>(err);
}
