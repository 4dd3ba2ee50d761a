// Flash-attention forward (K1) for Hopper.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_fwd_kernel` / `_fwd_kernel_nomask`, launched by `_flash_forward`.
//
// Computes O = softmax(scale * Q K^T) V and the natural-log LSE per query row,
// with an optional [B, Skv] key mask (nonzero = valid). A query row with no
// valid key gets O = 0 and LSE = -0.7 * FLT_MAX.
//
// What bounds it on the H100: at Flux-dev shapes (B=2, H=24, S=1536, D=128)
// it does 4*B*H*S^2*D = 5.8e10 flops over 38 MB of q/k/v/o, 1500 flops per
// byte, so the tensor cores bound it (59 us at 989 TFLOP/s), not memory.
//
// Design: one thread block per (query tile of 64 rows, head, batch); the TPU
// kernel's sequential fourth grid axis over KV tiles becomes a loop inside
// the block. Four warps each own 16 query rows, keep the running max, the
// running sum and the O accumulator in registers in f32, and issue
// mma.sync.m16n8k16 for S = Q K^T and O += P V. Scores are scaled by
// scale*log2(e) in f32 and exponentiated with exp2; q is not pre-rounded.
// P is rounded to the input type for the PV product, as on the TPU. Q, K and
// V are read through their [B, S, H, D] strides, so the model's layout needs
// no transpose, and the last Q and KV tiles are bounded in the kernel.
// Simple first version: no cp.async/TMA pipelining and no wgmma yet.
#include "flash_common.cuh"

namespace dpt {

template <typename T, int HD>
struct FwdTile {
  static constexpr int kBM = 64;  // query rows per block (16 per warp)
  static constexpr int kBN = 64;  // keys per loop step
  static constexpr int kThreads = 128;
  static constexpr int kLD = HD + 8;    // pitch of Q and K tiles
  static constexpr int kLDT = kBN + 8;  // pitch of the transposed V tile
  static constexpr int kSmem =
      (kBM * kLD + kBN * kLD + HD * kLDT) * (int)sizeof(T) + kBN * (int)sizeof(int);
};

template <typename T, int HD>
__global__ void __launch_bounds__(128) flash_fwd_kernel(AttnArgs a) {
  using C = FwdTile<T, HD>;
  constexpr int BM = C::kBM, BN = C::kBN, LD = C::kLD, LDT = C::kLDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BM * LD;
  T* sVt = sK + BN * LD;
  int* sValid = reinterpret_cast<int*>(sVt + HD * LDT);

  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* mask = a.mask ? a.mask + b * a.mask_sb : nullptr;

  load_rows<T, BM, HD, LD, C::kThreads>(sQ, q + m0 * a.q_ss, a.q_ss,
                                        min(BM, a.sq - m0));

  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  const float sc = a.scale * kLog2e;

  for (int n0 = 0; n0 < a.skv; n0 += BN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int nvalid = min(BN, a.skv - n0);
    load_rows<T, BN, HD, LD, C::kThreads>(sK, k + n0 * a.k_ss, a.k_ss, nvalid);
    load_rows_transposed<T, BN, HD, LDT, C::kThreads>(sVt, v + n0 * a.v_ss,
                                                       a.v_ss, nvalid);
    for (int i = threadIdx.x; i < BN; i += C::kThreads) {
      sValid[i] = (i < nvalid) && (mask == nullptr || mask[n0 + i] != 0);
    }
    __syncthreads();

    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    warp_mma_smem<T, BN / 8, HD>(s, sQ + warp * 16 * LD, LD, sK, LD, lane);

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t + (c & 1);
        const float x = sValid[col] ? s[n][c] * sc : -INFINITY;
        s[n][c] = x;
        mx[c >> 1] = fmaxf(mx[c >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
      // a row with no valid key so far keeps m = -inf; exponentiate against 0
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = exp2f(s[n][c] - m_use[c >> 1]);
        s[n][c] = e;
        rs[c >> 1] += e;
      }
    }
    l_run[0] = l_run[0] * alpha[0] + rs[0];
    l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    warp_mma_regs<T, HD / 8, BN / 16>(o, s, sVt, LDT, lane);
  }

  float inv[2];
  float lse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(l_run[r]);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
    lse[r] = l > 0.f ? m_run[r] / kLog2e + logf(l) : kMaskValue;
  }
  const int row0 = m0 + warp * 16;
  T* out = static_cast<T*>(a.out0) + (int64_t)b * a.sq * a.h * HD + h * HD;
  store_rows<T, HD / 8>(out, (int64_t)a.h * HD, row0, a.sq, o, inv[0], inv[1],
                        lane);
  if (t == 0) {
    float* lse_out = a.lse_out + ((int64_t)b * a.h + h) * a.sq;
    const int r0 = row0 + (lane >> 2);
    if (r0 < a.sq) lse_out[r0] = lse[0];
    if (r0 + 8 < a.sq) lse_out[r0 + 8] = lse[1];
  }
}

template <typename T, int HD>
cudaError_t run_fwd(const AttnArgs& a, cudaStream_t stream) {
  using C = FwdTile<T, HD>;
  dim3 grid((a.sq + C::kBM - 1) / C::kBM, a.h, a.b);
  return launch(flash_fwd_kernel<T, HD>, grid, C::kThreads, C::kSmem, stream, a);
}

template <typename T>
cudaError_t run_fwd_hd(const AttnArgs& a, int hd, cudaStream_t stream) {
  if (hd == 64) return run_fwd<T, 64>(a, stream);
  if (hd == 128) return run_fwd<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dpt

extern "C" int dpt_flash_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int b, int h, int sq, int skv, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long mask_sb, float scale, int is_fp16, void* stream) {
  dpt::AttnArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.mask = static_cast<const int*>(mask);
  a.out0 = o;
  a.lse_out = static_cast<float*>(lse);
  a.b = b;
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.mask_sb = mask_sb;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_fp16 ? dpt::run_fwd_hd<__half>(a, hd, s)
                            : dpt::run_fwd_hd<__nv_bfloat16>(a, hd, s);
  return static_cast<int>(err);
}
