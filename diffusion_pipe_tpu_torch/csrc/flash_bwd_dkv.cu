// Flash-attention backward, dK/dV part (K3), for Hopper.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_dkv_kernel` / `_dkv_kernel_nomask`, launched by `_flash_backward`.
//
// Recomputes P^T = exp(scale * K Q^T - LSE) and forms dV = P^T dO and
// dK = dS^T Q with dS^T = P^T * (V dO^T - D) * scale. Masked keys and key rows
// past the sequence end get P = 0, so their dK and dV rows are 0. (The JAX
// kernel's ln 2 factor only undoes its pre-scaled q; here q is unscaled.)
//
// What bounds it on the H100: four products of 2*S^2*D flops per (b, h) --
// 1.16e11 flops at Flux-dev shapes against 44 MB of inputs and outputs -- so
// the tensor cores bound it (117 us at 989 TFLOP/s).
//
// Design: one thread block per (KV tile of 64 rows, head, batch) looping over
// query tiles of 32, so each block owns its dK and dV rows: no atomics, and a
// deterministic result. Four warps each hold 16 rows of dK and of dV in f32
// registers (128 registers a thread), which is why the query tile is 32 and
// not 64. Q and dO are staged row-major (for K Q^T and V dO^T) and transposed
// (for dS^T Q and P^T dO). P and dS are rounded to the input type before their
// products, as on the TPU.
#include "flash_common.cuh"

namespace dpt {

template <typename T, int HD>
struct DkvTile {
  static constexpr int kBN = 64;  // keys owned by the block (16 per warp)
  static constexpr int kBM = 32;  // query rows per loop step
  static constexpr int kThreads = 128;
  static constexpr int kLD = HD + 8;
  static constexpr int kLDT = kBM + 8;
  static constexpr int kSmem =
      (2 * kBN * kLD + 2 * kBM * kLD + 2 * HD * kLDT) * (int)sizeof(T) +
      2 * kBM * (int)sizeof(float);
};

template <typename T, int HD>
__global__ void __launch_bounds__(128) flash_bwd_dkv_kernel(AttnArgs a) {
  using C = DkvTile<T, HD>;
  constexpr int BN = C::kBN, BM = C::kBM, LD = C::kLD, LDT = C::kLDT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sK = reinterpret_cast<T*>(smem_raw);
  T* sV = sK + BN * LD;
  T* sQ = sV + BN * LD;
  T* sdO = sQ + BM * LD;
  T* sQt = sdO + BM * LD;
  T* sdOt = sQt + HD * LDT;
  float* sLse2 = reinterpret_cast<float*>(sdOt + HD * LDT);
  float* sDi = sLse2 + BM;

  const int n0 = blockIdx.x * BN;
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
  const float* lse = a.lse + ((int64_t)b * a.h + h) * a.sq;
  const float* di = a.di + ((int64_t)b * a.h + h) * a.sq;

  const int nvalid = min(BN, a.skv - n0);
  load_rows<T, BN, HD, LD, C::kThreads>(sK, k + n0 * a.k_ss, a.k_ss, nvalid);
  load_rows<T, BN, HD, LD, C::kThreads>(sV, v + n0 * a.v_ss, a.v_ss, nvalid);

  // validity of this thread's two key rows (n0 + warp*16 + g, + 8)
  bool kv_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = n0 + warp * 16 + g + 8 * r;
    kv_ok[r] = j < a.skv &&
               (a.mask == nullptr || a.mask[b * a.mask_sb + j] != 0);
  }

  float dk[HD / 8][4];
  float dv[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }
  const float sc = a.scale * kLog2e;

  for (int m0 = 0; m0 < a.sq; m0 += BM) {
    __syncthreads();
    const int mvalid = min(BM, a.sq - m0);
    load_rows<T, BM, HD, LD, C::kThreads>(sQ, q + m0 * a.q_ss, a.q_ss, mvalid);
    load_rows<T, BM, HD, LD, C::kThreads>(sdO, dout + m0 * a.do_ss, a.do_ss,
                                          mvalid);
    load_rows_transposed<T, BM, HD, LDT, C::kThreads>(sQt, q + m0 * a.q_ss,
                                                       a.q_ss, mvalid);
    load_rows_transposed<T, BM, HD, LDT, C::kThreads>(
        sdOt, dout + m0 * a.do_ss, a.do_ss, mvalid);
    for (int i = threadIdx.x; i < BM; i += C::kThreads) {
      sLse2[i] = i < mvalid ? lse[m0 + i] * kLog2e : INFINITY;
      sDi[i] = i < mvalid ? di[m0 + i] : 0.f;
    }
    __syncthreads();

    // P^T tile: rows = this warp's 16 keys, cols = BM queries
    float p[BM / 8][4];
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) p[n][0] = p[n][1] = p[n][2] = p[n][3] = 0.f;
    warp_mma_smem<T, BM / 8, HD>(p, sK + warp * 16 * LD, LD, sQ, LD, lane);
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t + (c & 1);
        p[n][c] = kv_ok[c >> 1] ? exp2f(p[n][c] * sc - sLse2[col]) : 0.f;
      }
    }
    warp_mma_regs<T, HD / 8, BM / 16>(dv, p, sdOt, LDT, lane);

    float ds[BM / 8][4];
#pragma unroll
    for (int n = 0; n < BM / 8; ++n)
      ds[n][0] = ds[n][1] = ds[n][2] = ds[n][3] = 0.f;
    warp_mma_smem<T, BM / 8, HD>(ds, sV + warp * 16 * LD, LD, sdO, LD, lane);
#pragma unroll
    for (int n = 0; n < BM / 8; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = n * 8 + 2 * t + (c & 1);
        ds[n][c] = p[n][c] * (ds[n][c] - sDi[col]) * a.scale;
      }
    }
    warp_mma_regs<T, HD / 8, BM / 16>(dk, ds, sQt, LDT, lane);
  }

  const int64_t row_stride = (int64_t)a.h * HD;
  const int64_t base = (int64_t)b * a.skv * a.h * HD + h * HD;
  store_rows<T, HD / 8>(static_cast<T*>(a.out0) + base, row_stride,
                        n0 + warp * 16, a.skv, dk, 1.f, 1.f, lane);
  store_rows<T, HD / 8>(static_cast<T*>(a.out1) + base, row_stride,
                        n0 + warp * 16, a.skv, dv, 1.f, 1.f, lane);
}

template <typename T, int HD>
cudaError_t run_dkv(const AttnArgs& a, cudaStream_t stream) {
  using C = DkvTile<T, HD>;
  dim3 grid((a.skv + C::kBN - 1) / C::kBN, a.h, a.b);
  return launch(flash_bwd_dkv_kernel<T, HD>, grid, C::kThreads, C::kSmem,
                stream, a);
}

template <typename T>
cudaError_t run_dkv_hd(const AttnArgs& a, int hd, cudaStream_t stream) {
  if (hd == 64) return run_dkv<T, 64>(a, stream);
  if (hd == 128) return run_dkv<T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

}  // namespace dpt

extern "C" int dpt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* mask, void* dk, void* dv,
    int b, int h, int sq, int skv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long mask_sb, float scale,
    int is_fp16, void* stream) {
  dpt::AttnArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.mask = static_cast<const int*>(mask);
  a.out0 = dk;
  a.out1 = dv;
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
  cudaError_t err = is_fp16 ? dpt::run_dkv_hd<__half>(a, hd, s)
                            : dpt::run_dkv_hd<__nv_bfloat16>(a, hd, s);
  return static_cast<int>(err);
}
