// Flash-attention forward (K1) for Hopper: wgmma with TMA tile copies.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_fwd_kernel` / `_fwd_kernel_nomask` (lines 59 and 204), launched by
// `_flash_forward`.
//
// Computes O = softmax(scale * Q K^T) V and the natural-log LSE per query row,
// with an optional [B, Skv] key mask (nonzero = valid). A query row with no
// valid key gets O = 0 and LSE = -0.7 * FLT_MAX.
//
// What bounds it on the H100: 4*B*H*Sq*Skv*D flops over 2*(2*Sq + 2*Skv)*B*H*D
// bytes, so the tensor cores: 2.873 ms at 989 TFLOP/s for Wan2.1's
// self-attention (B 1, H 12, S 21504, D 128), 0.059 ms for Flux-dev (B 2,
// H 24, S 1536), 0.472 ms for AuraFlow (B 2, H 12, S 4360, D 256).
//
// Design: one block of three warpgroups per (query tile of 128 rows, head,
// batch). Warpgroup 2 is the producer: it gives up its registers
// (setmaxnreg 24) and its first warp issues the TMA copies, the Q tile once
// and then K and V tiles of 128 keys into a ring of 2 stages, each stage
// with a full and an empty mbarrier; with each K/V stage it writes the
// stage's key-validity bits (key < Skv and the mask), 4 words of 32 keys.
// Warpgroups 0 and 1 (setmaxnreg 240) each own 64 query rows: S = Q K^T is a
// wgmma m64n128k16 with Q and K K-major in 128-byte-swizzled shared memory;
// the online softmax runs in f32 registers in the exp2 domain (ex2.approx);
// P is rounded to the input type and fed from registers as wgmma's A operand
// for O += P V, with V read as an MN-major B operand, so no tile is
// transposed. The two consumer warpgroups are not scheduled against each
// other: one's softmax overlaps the other's products as the SM interleaves
// them.
// Tiles: 128 query rows x 128 keys a step, 2 stages. Shared memory at
// D = 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB. Registers: 168 at
// entry (384 threads), 240 for a consumer thread, which holds S (64 f32),
// O (64 f32 at D = 128) and P (32); ptxas keeps every wgmma in flight (no
// serialization) and spills nothing.
//
// Against the first design of this kernel (mma.sync on 64x64 tiles, one
// warpgroup, synchronous 16-byte loads, V stored transposed element by
// element): the copies run asynchronously ahead of the math, the
// tensor-core products are wgmma (the only path to the full bf16 rate on
// Hopper), the tile is 128 x 128, and the transposed V copy is gone. Ragged Sq and Skv come free: TMA
// fills rows past the end with zeros, the validity bits mask keys past Skv,
// and rows past Sq are not stored.
//
// Head dim 256 (FwdTile<256>): 128 query rows x 64 keys a step, 2 stages,
// so Q 64 KB + 2 x (K 32 KB + V 32 KB) = 192 KB of shared memory. S is a
// wgmma m64n64k16 (32 f32 a thread), O += P V one m64n256k16 a k-step with
// P from registers (O is 128 f32 a thread). There is no producer
// warpgroup: ptxas places the wgmmas within the launch bound's registers,
// 168 a thread at 384 threads (and at 288: three warps share an SM
// sub-partition's 16K registers) whatever setmaxnreg grants, which spilled
// and serialized every wgmma (C7512). So the block is the two consumer
// warpgroups (256 threads, 200 registers, no spill) and warp 0 issues the
// copies: Q and the first two stages before its first step, each later
// stage once both warpgroups have freed it at the end of warp 0's step,
// with that stage's mask read a step ahead so that the read does not stall
// warp 0's warpgroup. Against the first design at D 256 (mma.sync
// m16n8k16, 64 queries x 32 keys a block step, one warp per 16 rows,
// cp.async by the warps that do the math, formerly in flash_d256.cu):
// wgmma, TMA,
// twice the keys a step and twice the rows a block.
//
// Head dims 96 and 120 (Lumina 2's and OmniGen2's) run the D 128 tiles
// (kPad): the tensor maps carry the true D, so TMA fills the columns of the
// second 64-wide box past D with zeros. Zero columns of Q and K add nothing
// to S, and zero columns of V give zero columns of O, which the epilogue
// does not store: it writes the true D's columns at the true row stride.
// The products do 128 / D of the useful work (1.33x at D 96, 1.07x at 120).
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dpt {

using namespace hopper;

struct FwdArgs {
  const int* mask;  // [B, Skv], nonzero = valid key; may be null
  long long mask_sb;
  void* out;        // contiguous [B, Sq, H, D]
  float* lse;       // [B, H, Sq]
  int h, sq, skv;
  float scale;
  int d;            // the true head dim: HD, or under kPad less (96, 120)
};

template <int HD>
struct FwdTile {
  static constexpr int kBM = 128;  // query rows a block (64 a consumer warpgroup)
  // keys a step; at D 256, 64, so that two stages of K and V fit beside Q
  static constexpr int kBN = HD == 256 ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr int kWords = kBN / 32;  // validity words a stage
  static constexpr int kQBytes = kBM * HD * 2;
  static constexpr int kKVBytes = kBN * HD * 2;  // one of K or V
  static constexpr int kOffK = kQBytes;
  static constexpr int kOffV = kOffK + kStages * kKVBytes;
  static constexpr int kOffBar = kOffV + kStages * kKVBytes;  // q, full[S], empty[S]
  static constexpr int kOffWords = kOffBar + 8 * (1 + 2 * kStages);
  static constexpr int kSmem = kOffWords + 4 * kStages * kWords + 1024;  // + alignment
  // D 64 and 128: producer warpgroup 2 hands its registers to the consumers
  // (setmaxnreg). D 256: no producer; warp 0 issues the copies between its
  // steps, so that the launch bound of 256 threads lets a consumer thread
  // hold O's 128 f32 (ptxas places the wgmmas within the launch bound's
  // registers, 168 at 384 threads whatever setmaxnreg grants).
  static constexpr bool kProducerWarpgroup = HD != 256;
  static constexpr int kThreads = kProducerWarpgroup ? 384 : 256;
  static_assert(kSmem <= 232448, "shared memory a block may hold");
};

template <typename T, int HD, bool kPad>
__global__ void __launch_bounds__(FwdTile<HD>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const FwdArgs a) {
  using C = FwdTile<HD>;
  constexpr int BM = C::kBM, BN = C::kBN, S = C::kStages, NW = C::kWords;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bar_q = base + C::kOffBar;
  const uint32_t bar_full = bar_q + 8;       // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * S;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + C::kOffWords);

  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (a.skv + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 256);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The copies, by one warp: Q once (load_q), then K and V of key step j
  // into stage j % S once both consumer warpgroups have freed it, with the
  // stage's key-validity bits (load_kv), NW words of 32 keys from each
  // lane's key_ok (key < Skv and the mask: nonzero is valid; read into the
  // registers with no test, so that a read ahead does not wait).
  const CUtensorMap* pq = &tm_q;
  const CUtensorMap* pk = &tm_k;
  const CUtensorMap* pv = &tm_v;
  const int* mask = a.mask ? a.mask + b * a.mask_sb : nullptr;
  auto load_q = [&](int lane) {
    if (lane == 0) {
      prefetch_tensor_map(pq);
      prefetch_tensor_map(pk);
      prefetch_tensor_map(pv);
      mbar_arrive_expect_tx(bar_q, C::kQBytes);
#pragma unroll
      for (int hf = 0; hf < HD / 64; ++hf)
        tma_load_4d(base + hf * BM * 128, pq, bar_q, hf * 64, h, m0, b);
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
        for (int j = 0; j < n_tiles; ++j) {
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
      // later one after its own step (below)
      load_q(threadIdx.x);
      for (int j = 0; j < min(S, n_tiles); ++j) {
        int ok[NW];
        key_ok(j, threadIdx.x, ok);
        load_kv(j, threadIdx.x, ok);
      }
    }
    const int cw = threadIdx.x / 128;
    const int tid = threadIdx.x % 128;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int t = lane & 3;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m_run[2] = {-INFINITY, -INFINITY};  // running max, scaled to log2
    float l_run[2] = {0.f, 0.f};              // this thread's partial row sums
    const float sc = a.scale * kLog2e;
    const uint32_t q_rows = base + cw * 64 * 128;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % S;
      // D 256: warp 0 reads the mask of the step it loads after this one
      // now, so that the read's latency hides behind this step
      int ok_next[NW];
      if constexpr (!C::kProducerWarpgroup) {
        if (threadIdx.x < 32 && j + S < n_tiles) key_ok(j + S, lane, ok_next);
      }
      mbar_wait(bar_full + 8 * s, (j / S) & 1);
      const uint32_t sk = base + C::kOffK + s * C::kKVBytes;
      const uint32_t sv = base + C::kOffV + s * C::kKVBytes;

      float sacc[BN / 2];
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 elements a k-step
        wgmma_ss<T, BN>(sacc, desc_k_major(q_rows + (kk / 4) * BM * 128 + off),
                        desc_k_major(sk + (kk / 4) * BN * 128 + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // keys past Skv or masked out score -inf
      uint32_t w[NW];
      uint32_t all = 0xffffffffu;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        w[i] = words[s * NW + i];
        all &= w[i];
      }
      if (all != 0xffffffffu) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int bit = 8 * (i % 4) + 2 * t + (c & 1);
            if (!((w[i / 4] >> bit) & 1u)) sacc[4 * i + c] = -INFINITY;
          }
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]) * sc);
        // a row with no valid key so far keeps m = -inf; exponentiate against 0
        m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[r] = exp2_approx(m_run[r] - m_use[r]);
        m_run[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        const float e = exp2_approx(fmaf(sacc[i], sc, -m_use[r]));
        sacc[i] = e;
        rs[r] += e;
      }
      l_run[0] = l_run[0] * alpha[0] + rs[0];
      l_run[1] = l_run[1] * alpha[1] + rs[1];
#pragma unroll
      for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // P (rounded to T) as the A fragments of O += P V, 16 keys a k-step
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = Elem<T>::pack(sacc[8 * kk + 0], sacc[8 * kk + 1]);
        pa[kk][1] = Elem<T>::pack(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pa[kk][2] = Elem<T>::pack(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pa[kk][3] = Elem<T>::pack(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wgmma_rs<T, HD>(o, pa[kk], desc_mn_major(sv + kk * 16 * 128, BN * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(bar_empty + 8 * s);
      if constexpr (!C::kProducerWarpgroup) {
        // D 256: once both warpgroups have freed stage s, refill it
        if (threadIdx.x < 32 && j + S < n_tiles) load_kv(j + S, lane, ok_next);
      }
    }

    float inv[2], lse[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l = quad_sum(l_run[r]);
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      lse[r] = l > 0.f ? m_run[r] / kLog2e + logf(l) : kMaskValue;
    }
    const int r0 = m0 + cw * 64 + warp * 16 + (lane >> 2);
    const int r1 = r0 + 8;
    // O's columns: HD, or under kPad the true D (a multiple of 8, so no
    // packed pair straddles it)
    const int dcols = kPad ? a.d : HD;
    const int64_t row_stride = (int64_t)a.h * dcols;
    T* out = static_cast<T*>(a.out) + (int64_t)b * a.sq * row_stride + h * dcols;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int c = 8 * i + 2 * t;
      if (kPad && c >= dcols) continue;
      if (r0 < a.sq)
        *reinterpret_cast<uint32_t*>(out + r0 * row_stride + c) =
            Elem<T>::pack(o[4 * i] * inv[0], o[4 * i + 1] * inv[0]);
      if (r1 < a.sq)
        *reinterpret_cast<uint32_t*>(out + r1 * row_stride + c) =
            Elem<T>::pack(o[4 * i + 2] * inv[1], o[4 * i + 3] * inv[1]);
    }
    if (t == 0) {
      float* lse_out = a.lse + ((int64_t)b * a.h + h) * a.sq;
      if (r0 < a.sq) lse_out[r0] = lse[0];
      if (r1 < a.sq) lse_out[r1] = lse[1];
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
cudaError_t run_fwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                    const FwdArgs& a, int b, cudaStream_t stream) {
  using C = FwdTile<HD>;
  cudaError_t err = set_smem_once(flash_fwd_kernel<T, HD, kPad>, C::kSmem,
                                  g_smem_set[smem_flag<T, HD, kPad>()]);
  if (err != cudaSuccess) return err;
  dim3 grid((a.sq + C::kBM - 1) / C::kBM, a.h, b);
  flash_fwd_kernel<T, HD, kPad><<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

}  // namespace dpt

extern "C" int dpt_flash_fwd(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int b, int h, int sq, int skv, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long mask_sb, float scale, int is_fp16, void* stream) {
  if (!dpt::kernel_head_dim(hd)) return static_cast<int>(cudaErrorInvalidValue);
  // the tile's rows: 128 queries, and keys a step (FwdTile<64> is FwdTile<128>'s)
  const int bm = dpt::FwdTile<128>::kBM;
  const int bn = hd == 256 ? dpt::FwdTile<256>::kBN : dpt::FwdTile<128>::kBN;
  CUtensorMap tq, tk, tv;
  cudaError_t err =
      dpt::hopper::make_bshd_map(&tq, q, is_fp16, b, sq, h, hd, q_sb, q_ss, q_sh, bm);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tk, k, is_fp16, b, skv, h, hd, k_sb, k_ss, k_sh, bn);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tv, v, is_fp16, b, skv, h, hd, v_sb, v_ss, v_sh, bn);
  if (err != cudaSuccess) return static_cast<int>(err);
  dpt::FwdArgs a = {};
  a.mask = static_cast<const int*>(mask);
  a.mask_sb = mask_sb;
  a.out = o;
  a.lse = static_cast<float*>(lse);
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.d = hd;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    err = is_fp16 ? dpt::run_fwd<__half, 64>(tq, tk, tv, a, b, s)
                  : dpt::run_fwd<__nv_bfloat16, 64>(tq, tk, tv, a, b, s);
  else if (hd < 128)
    err = is_fp16 ? dpt::run_fwd<__half, 128, true>(tq, tk, tv, a, b, s)
                  : dpt::run_fwd<__nv_bfloat16, 128, true>(tq, tk, tv, a, b, s);
  else if (hd == 128)
    err = is_fp16 ? dpt::run_fwd<__half, 128>(tq, tk, tv, a, b, s)
                  : dpt::run_fwd<__nv_bfloat16, 128>(tq, tk, tv, a, b, s);
  else
    err = is_fp16 ? dpt::run_fwd<__half, 256>(tq, tk, tv, a, b, s)
                  : dpt::run_fwd<__nv_bfloat16, 256>(tq, tk, tv, a, b, s);
  return static_cast<int>(err);
}
