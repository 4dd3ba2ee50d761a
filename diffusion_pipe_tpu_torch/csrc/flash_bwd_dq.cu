// Flash-attention backward, dQ part (K2), for Hopper: wgmma with TMA tile
// copies.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_dq_kernel` / `_dq_kernel_nomask` (lines 217 and 258), launched by
// `_flash_backward`.
//
// Recomputes P = exp(scale * Q K^T - LSE) from the stored natural-log LSE,
// then dS = P * (dO V^T - D) * scale and dQ = dS K, with D = rowsum(dO * O)
// computed by the caller. A key that is masked or past Skv gets P = 0, so a
// query row with no valid key gets dQ = 0. dS is rounded to the input type
// for dS K, as on the TPU.
//
// What bounds it on the H100: three products of 2*Sq*Skv*D flops per (b, h)
// against (3*Sq + 2*Skv)*D*2 bytes, so the tensor cores: 4.309 ms at
// 989 TFLOP/s for Wan2.1's self-attention (H 12, S 21504, D 128), 0.088 ms
// for Flux-dev (B 2, H 24, S 1536), 0.709 ms for AuraFlow (B 2, H 12,
// S 4360, D 256).
//
// Design, on the pattern of K1 (csrc/flash_fwd.cu): one block of three
// warpgroups per (query tile of 128 rows, head, batch). Warpgroup 2 is the
// producer: it gives up its registers (setmaxnreg 24) and its first warp
// issues the TMA copies, the Q and dO tiles once and then K and V tiles of
// 64 keys into a ring of 3 stages, each stage with a full and an empty
// mbarrier; with each K/V stage it writes the stage's key-validity bits
// (key < Skv and the mask), 2 words of 32 keys, so the mask's loads never
// hold up the math. Warpgroups 0 and 1 (setmaxnreg 240) each own 64 query
// rows and hold their dQ in f32 registers across the loop over key steps,
// so the block owns its dQ rows: no atomics, the same bits on every launch.
// Each consumer thread loads the LSE (times log2 e) and D of its two rows
// once. A step is three wgmma products: S = Q K^T and dP = dO V^T
// (m64n64k16, both operands K-major) in two commit groups, so the
// exponentials of P run while dP is still in the tensor cores; then dS in
// f32 registers, rounded to the input type as the A operand of dQ += dS K
// (m64nDk16), with the K tile read as an MN-major B operand, so no tile is
// transposed (this is K1's O += P V with K in place of V).
// Tiles: 128 query rows x 64 keys a step, 3 stages. Shared memory at
// D = 128: Q, dO 32 KB each + 3 x (K, V 16 KB each) = 160 KB. Registers:
// 168 at entry (384 threads), the bound within which ptxas places the
// wgmmas: a consumer thread holds dQ (64 f32 at D = 128), S and dP (32
// each) and dS (16), with no spill and every wgmma in flight. A 128-key
// step would hold 192 f32 and so needs K3's layout (two warpgroups, no
// producer, 256 threads); that version was no faster unmasked and slower
// with a key mask (PERF.md).
//
// Against the first design of this kernel (mma.sync on 64x64 tiles, one
// warpgroup, synchronous 16-byte loads, K staged twice, once transposed
// element by element): TMA copies run ahead of the math, the products are
// wgmma on 128-row query tiles, and K is copied once and never transposed. Ragged
// Sq and Skv come free: TMA fills rows past the end with zeros, the
// validity bits mask keys past Skv, rows past Sq get LSE = +inf (P = 0) and
// are not stored.
//
// Head dim 256 (DqTile<256>): 128 query rows x 48 keys a step, 2 stages, so
// Q, dO 64 KB each + 2 x (K, V 24 KB each) = 224 KB of shared memory (230,456
// bytes with the barriers and the alignment; a 64-key step does not fit
// beside the resident Q and dO). S and dP are wgmma m64n48k16 (24 f32 each a
// thread), dQ += dS K one m64n256k16 a k-step with dS from registers (dQ is
// 128 f32 a thread); 214 registers, no spill. S and dP read their A operand
// (64 rows of Q or dO) from shared memory on every k-step, so shared-memory
// bandwidth, not the tensor cores, sets their pace: an m64n48k16 reads 3.5 KB
// for 48 K multiply-adds, an m64n32k16 3 KB for 32 K, and 48 keys in 2
// stages ran 1.31x faster than 32 keys in 3 stages at AuraFlow's shape (on
// an NVIDIA H100 80GB HBM3 at 700 W, tools/compare_flash_kernels.py). There
// is no producer warpgroup, as in K1's FwdTile<256>: ptxas places the
// wgmmas within the launch bound's registers, 168 a thread at 384 or 288
// threads whatever setmaxnreg grants, and serializes them (C7512) when they
// do not fit. So the block is the two consumer warpgroups (256 threads) and
// warp 0 issues the copies: Q and dO and the first two stages before its
// first step, each later stage once both warpgroups have freed it at the
// end of warp 0's step, with that stage's mask read a step ahead so that
// the read does not stall warp 0's warpgroup (2 validity words a stage, of
// which the step reads 48 bits). Against the first design at
// D 256 (mma.sync m16n8k16, one warp per 16 rows, every A and B fragment
// reloaded by ldmatrix, cp.async copies issued by the warps that do the
// math into 2 stages of 32 keys, a __syncthreads() twice a step, 241
// registers): wgmma on 64-row operands read from shared memory by the
// tensor cores, TMA copies that run ahead of the math, 48 keys a step
// where it took 32, and no block-wide barrier in the loop.
//
// Head dims 96 and 120 run the D 128 tiles (kPad), as K1 does: the tensor
// maps carry the true D, TMA zero-fills the columns past it (zero columns
// of Q, K, V and dO add nothing to S, dP or D's rows, and give zero columns
// of dQ), and the epilogue stores the true D's columns at its row stride.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dpt {

using namespace hopper;

struct DqArgs {
  const float* lse;  // [B, H, Sq], natural log
  const float* di;   // [B, H, Sq], rowsum(dO * O)
  const int* mask;   // [B, Skv], nonzero = valid key; may be null
  long long mask_sb;
  void* dq;          // contiguous [B, Sq, H, D]
  int h, sq, skv;
  float scale;
  int d;             // the true head dim: HD, or under kPad less (96, 120)
};

template <int HD>
struct DqTile {
  static constexpr int kBM = 128;  // query rows a block (64 a consumer warpgroup)
  // keys a step and stages; at D 256, 48 keys in 2 stages, so that K and V
  // fit beside the resident Q and dO
  static constexpr int kBN = HD == 256 ? 48 : 64;
  static constexpr int kStages = HD == 256 ? 2 : 3;
  static constexpr int kWords = (kBN + 31) / 32;  // validity words a stage
  static constexpr int kQBytes = kBM * HD * 2;   // one of Q or dO
  static constexpr int kKVBytes = kBN * HD * 2;  // one of K or V, a stage
  static constexpr int kOffDO = kQBytes;
  static constexpr int kOffK = 2 * kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;  // q, full[S], empty[S]
  static constexpr int kOffWords = kOffBar + 8 * (1 + 2 * kStages);  // [S][NW]
  static constexpr int kSmem = kOffWords + 4 * kStages * kWords + 1024;  // + alignment
  // D 64 and 128: producer warpgroup 2 hands its registers to the consumers
  // (setmaxnreg). D 256: no producer; warp 0 issues the copies between its
  // steps, so that the launch bound of 256 threads lets a consumer thread
  // hold dQ's 128 f32.
  static constexpr bool kProducerWarpgroup = HD != 256;
  static constexpr int kThreads = kProducerWarpgroup ? 384 : 256;
  static_assert(kSmem <= 232448, "shared memory a block may hold");
};

template <typename T, int HD, bool kPad>
__global__ void __launch_bounds__(DqTile<HD>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do, const DqArgs a) {
  using C = DqTile<HD>;
  constexpr int BM = C::kBM, BN = C::kBN, S = C::kStages, NW = C::kWords;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bar_q = base + C::kOffBar;  // the Q and dO tiles
  const uint32_t bar_full = bar_q + 8;       // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * S;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + C::kOffWords);

  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_steps = (a.skv + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The copies, by one warp: Q and dO once (load_q), then K and V of key
  // step j into stage j % S once both consumer warpgroups have freed it,
  // with the stage's key-validity bits (load_kv), NW words of 32 keys from
  // each lane's key_ok (key < Skv and the mask: nonzero is valid; read into
  // the registers with no test, so that a read ahead does not wait).
  const CUtensorMap* pq = &tm_q;
  const CUtensorMap* pk = &tm_k;
  const CUtensorMap* pv = &tm_v;
  const CUtensorMap* pdo = &tm_do;
  const int* mask = a.mask ? a.mask + b * a.mask_sb : nullptr;
  auto load_q = [&](int lane) {
    if (lane == 0) {
      prefetch_tensor_map(pk);
      prefetch_tensor_map(pv);
      mbar_arrive_expect_tx(bar_q, 2 * C::kQBytes);
#pragma unroll
      for (int hf = 0; hf < HD / 64; ++hf) {
        tma_load_4d(base + hf * BM * 128, pq, bar_q, hf * 64, h, m0, b);
        tma_load_4d(base + C::kOffDO + hf * BM * 128, pdo, bar_q, hf * 64, h, m0, b);
      }
    }
  };
  auto key_ok = [&](int j, int lane, int (&ok)[NW]) {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      const int key = j * BN + 32 * i + lane;
      ok[i] = key < a.skv;
      if (mask != nullptr && key < a.skv) ok[i] = mask[key];
    }
  };
  auto load_kv = [&](int j, int lane, const int (&ok)[NW]) {
    const int s = j % S;
    const int n0 = j * BN;
    uint32_t w[NW];
#pragma unroll
    for (int i = 0; i < NW; ++i) w[i] = __ballot_sync(0xffffffffu, ok[i] != 0);
    mbar_wait(bar_empty + 8 * s, ((j / S) & 1) ^ 1);
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NW; ++i) words[s * NW + i] = w[i];
      const uint32_t bar = bar_full + 8 * s;
      mbar_arrive_expect_tx(bar, 2 * C::kKVBytes);
      const uint32_t dk = base + C::kOffK + s * C::kKVBytes;
      const uint32_t dv = base + C::kOffV + s * C::kKVBytes;
#pragma unroll
      for (int hf = 0; hf < HD / 64; ++hf) {
        tma_load_4d(dk + hf * BN * 128, pk, bar, hf * 64, h, n0, b);
        tma_load_4d(dv + hf * BN * 128, pv, bar, hf * 64, h, n0, b);
      }
    }
    __syncwarp();
  };

  if (threadIdx.x >= 256) {
    // ---- producer warpgroup 2 (D 64, 128): its first warp issues the
    // copies ----
    if constexpr (C::kProducerWarpgroup) {
      setmaxnreg_dec<24>();
      if (threadIdx.x < 256 + 32) {
        const int lane = threadIdx.x - 256;
        load_q(lane);
        for (int j = 0; j < n_steps; ++j) {
          int ok[NW];
          key_ok(j, lane, ok);
          load_kv(j, lane, ok);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns query rows m0 + 64 cw + [0, 64) ----
    if constexpr (C::kProducerWarpgroup) {
      setmaxnreg_inc<240>();
    } else if (threadIdx.x < 32) {
      // D 256: warp 0 issues the copies, the first S stages now and each
      // later one after one of its own steps (below)
      load_q(threadIdx.x);
      for (int j = 0; j < min(S, n_steps); ++j) {
        int ok[NW];
        key_ok(j, threadIdx.x, ok);
        load_kv(j, threadIdx.x, ok);
      }
    }
    const int cw = threadIdx.x / 128;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31;
    const int t = lane & 3;

    // this thread's rows r0 and r0 + 8: LSE times log2 e (+inf past Sq, so
    // P = 0 there) and D
    const int r0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
    float neg_lse2[2], dsum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      const int64_t i = ((int64_t)b * a.h + h) * a.sq + row;
      neg_lse2[r] = row < a.sq ? -a.lse[i] * kLog2e : -INFINITY;
      dsum[r] = row < a.sq ? a.di[i] : 0.f;
    }

    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    const float sc = a.scale * kLog2e;
    const uint32_t q_rows = base + cw * 64 * 128;
    const uint32_t do_rows = base + C::kOffDO + cw * 64 * 128;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_steps; ++j) {
      const int s = j % S;
      // D 256: warp 0 reads the mask of the step it loads after this one
      // now, so that the read's latency hides behind this step
      int ok_next[NW];
      if constexpr (!C::kProducerWarpgroup) {
        if (threadIdx.x < 32 && j + S < n_steps) key_ok(j + S, lane, ok_next);
      }
      mbar_wait(bar_full + 8 * s, (j / S) & 1);
      const uint32_t sk = base + C::kOffK + s * C::kKVBytes;
      const uint32_t sv = base + C::kOffV + s * C::kKVBytes;

      // S = Q K^T, then dP = dO V^T, as two groups in flight together
      float sacc[BN / 2], dp[BN / 2];
      fence_regs(sacc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 elements a k-step
        wgmma_ss<T, BN>(sacc, desc_k_major(q_rows + (kk / 4) * BM * 128 + off),
                        desc_k_major(sk + (kk / 4) * BN * 128 + off), kk > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T, BN>(dp, desc_k_major(do_rows + (kk / 4) * BM * 128 + off),
                        desc_k_major(sv + (kk / 4) * BN * 128 + off), kk > 0);
      }
      wgmma_commit();

      // P = exp2(S * scale * log2 e - LSE * log2 e) while dP is computed. A
      // key that is masked or past Skv gets P = 0 by a select, not a
      // multiply: a row with no valid key has LSE = -0.7 f32max, whose log2
      // overflows to -inf, so its exponent is +inf and 0 * inf would be NaN
      wgmma_wait<1>();
      fence_regs(sacc);
      uint32_t w[NW];
      uint32_t all = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        w[i] = words[s * NW + i];
        all &= w[i];
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i)
        sacc[i] = exp2_approx(fmaf(sacc[i], sc, neg_lse2[(i >> 1) & 1]));
      if (all != 0xffffffffu) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int bit = 8 * (i % 4) + 2 * t + (c & 1);
            sacc[4 * i + c] = ((w[i / 4] >> bit) & 1u) ? sacc[4 * i + c] : 0.f;
          }
        }
      }

      // dS = P * (dP - D) * scale, rounded to T as the A fragments of
      // dQ += dS K, 16 keys a k-step
      wgmma_wait<0>();
      fence_regs(dp);
      uint32_t dsa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float d = dsum[r & 1];
          dsa[kk][r] = Elem<T>::pack(sacc[i] * (dp[i] - d) * a.scale,
                                     sacc[i + 1] * (dp[i + 1] - d) * a.scale);
        }
      }
      fence_regs(dq);
      fence_regs(dsa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<T, HD>(dq, dsa[kk], desc_mn_major(sk + kk * 16 * 128, BN * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(dsa);
      mbar_arrive(bar_empty + 8 * s);
      if constexpr (!C::kProducerWarpgroup) {
        // D 256: once both warpgroups have freed stage s, refill it
        if (threadIdx.x < 32 && j + S < n_steps) load_kv(j + S, lane, ok_next);
      }
    }

    const int dcols = kPad ? a.d : HD;  // dQ's columns
    const int64_t row_stride = (int64_t)a.h * dcols;
    T* out = static_cast<T*>(a.dq) + (int64_t)b * a.sq * row_stride + h * dcols;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (kPad && c >= dcols) continue;
      if (r0 < a.sq)
        *reinterpret_cast<uint32_t*>(out + r0 * row_stride + c) =
            Elem<T>::pack(dq[4 * i], dq[4 * i + 1]);
      if (r0 + 8 < a.sq)
        *reinterpret_cast<uint32_t*>(out + (r0 + 8) * row_stride + c) =
            Elem<T>::pack(dq[4 * i + 2], dq[4 * i + 3]);
    }
  }
}

// Whether each instance's shared-memory limit is set, per device. File-local
// on purpose: a function-local static of a template is one object across all
// loaded libraries (STB_GNU_UNIQUE), so a second build of this kernel in the
// same process would skip the call.
namespace {
bool g_smem_set[8][64];
template <typename T, int HD, bool kPad>
constexpr int smem_flag() {
  return (std::is_same<T, __half>::value ? 4 : 0) +
         (kPad ? 3 : HD == 64 ? 0 : HD == 128 ? 1 : 2);
}
}  // namespace

template <typename T, int HD, bool kPad = false>
cudaError_t run_dq(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                   const CUtensorMap& tdo, const DqArgs& a, int b, cudaStream_t stream) {
  using C = DqTile<HD>;
  cudaError_t err = set_smem_once(flash_bwd_dq_kernel<T, HD, kPad>, C::kSmem,
                                  g_smem_set[smem_flag<T, HD, kPad>()]);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + C::kBM - 1) / C::kBM, a.h, b);
  flash_bwd_dq_kernel<T, HD, kPad><<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo,
                                                                            a);
  return cudaGetLastError();
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
  if (!dpt::kernel_head_dim(hd)) return static_cast<int>(cudaErrorInvalidValue);
  // the tile's rows: 128 queries, and keys a step (DqTile<64> is DqTile<128>'s)
  const int bm = dpt::DqTile<128>::kBM;
  const int bn = hd == 256 ? dpt::DqTile<256>::kBN : dpt::DqTile<128>::kBN;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err =
      dpt::hopper::make_bshd_map(&tq, q, is_fp16, b, sq, h, hd, q_sb, q_ss, q_sh, bm);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tdo, dout, is_fp16, b, sq, h, hd, do_sb, do_ss,
                                     do_sh, bm);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tk, k, is_fp16, b, skv, h, hd, k_sb, k_ss, k_sh, bn);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tv, v, is_fp16, b, skv, h, hd, v_sb, v_ss, v_sh, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  dpt::DqArgs a = {};
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.mask = static_cast<const int*>(mask);
  a.mask_sb = mask_sb;
  a.dq = dq;
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.d = hd;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    err = is_fp16 ? dpt::run_dq<__half, 64>(tq, tk, tv, tdo, a, b, s)
                  : dpt::run_dq<__nv_bfloat16, 64>(tq, tk, tv, tdo, a, b, s);
  else if (hd < 128)
    err = is_fp16 ? dpt::run_dq<__half, 128, true>(tq, tk, tv, tdo, a, b, s)
                  : dpt::run_dq<__nv_bfloat16, 128, true>(tq, tk, tv, tdo, a, b, s);
  else if (hd == 128)
    err = is_fp16 ? dpt::run_dq<__half, 128>(tq, tk, tv, tdo, a, b, s)
                  : dpt::run_dq<__nv_bfloat16, 128>(tq, tk, tv, tdo, a, b, s);
  else
    err = is_fp16 ? dpt::run_dq<__half, 256>(tq, tk, tv, tdo, a, b, s)
                  : dpt::run_dq<__nv_bfloat16, 256>(tq, tk, tv, tdo, a, b, s);
  return static_cast<int>(err);
}
