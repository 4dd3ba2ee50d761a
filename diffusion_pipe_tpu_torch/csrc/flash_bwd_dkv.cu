// Flash-attention backward, dK/dV part (K3), for Hopper: wgmma with TMA tile
// copies.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_dkv_kernel` / `_dkv_kernel_nomask` (line 264), launched by
// `_flash_backward`.
//
// Recomputes P^T = exp(scale * K Q^T - LSE) and forms dV = P^T dO and
// dK = dS^T Q with dS^T = P^T * (V dO^T - D) * scale. Masked keys and key rows
// past the sequence end get P = 0, so their dK and dV rows are 0. (The JAX
// kernel's ln 2 factor only undoes its pre-scaled q; here q is unscaled.)
//
// What bounds it on the H100: four products of 2*Sq*Skv*D flops per (b, h)
// against (2*Sq + 4*Skv)*D*2 bytes per (b, h), so the tensor cores: 5.745 ms
// at 989 TFLOP/s for Wan2.1's self-attention (H 12, S 21504, D 128),
// 0.117 ms for Flux-dev (B 2, H 24, S 1536).
//
// Design: one block of two warpgroups per (key tile of 128 rows, head,
// batch, query split); warpgroup cw owns 64 keys and holds their dK and dV
// rows in f32 registers across the loop over query tiles (128 registers a
// thread at D = 128). Thread 0 copies the K and V tiles once with TMA, then
// Q and dO tiles of 64 queries into a ring of 3 stages, each with an
// mbarrier that the copy completes; the stage's LSE (times log2 e) and D
// values are loaded by 64 threads one ring-depth ahead and stored beside the
// tiles. A step is four wgmma products: S^T = K Q^T and dP^T = V dO^T
// (m64n64k16, both operands K-major, in flight together), then P^T and dS^T
// in f32 registers, then dV += P^T dO and dK += dS^T Q (m64nDk16) with P^T
// and dS^T, rounded to the input type, taken from registers as the A operand
// and dO and Q read as MN-major B operands, so each of Q and dO is copied
// once a step and never transposed. After the step a named barrier over
// both warpgroups frees the stage and thread 0 refills it three steps ahead.
// Tiles: 128 keys x 64 queries a step, 3 stages. Shared memory at D = 128:
// K, V 32 KB each + 3 x (Q, dO 16 KB each) + LSE and D = 162 KB.
// Registers: 244 a thread at D = 128 (launch bound 256 threads), no spills,
// every wgmma of a group in flight. There is no producer warpgroup on
// purpose: with a third warpgroup (384 threads, setmaxnreg 24 / 240) ptxas
// still held the consumers to the 168 registers of the launch bound when it
// placed the wgmmas, found dK, dV, S^T and dP^T (192 registers) too many,
// spilled 272 bytes and serialized every wgmma (C7512); that version took
// 14.2 ms at Wan2.1's self-attention shape, this one 9.5-9.8 (PERF.md).
//
// Short key sequences: when the key tiles (x heads x batch) are fewer than
// the SMs, the wrapper splits the query loop over `splits` blocks per key
// tile. Each writes its f32 dK/dV partial to a workspace; the last block of a
// tile to finish (a counter in global memory) sums the partials in split
// order and writes dK/dV in the input type, so the result is the same bits
// from run to run. No atomics touch dK/dV.
//
// Against the first design of this kernel (mma.sync, one warpgroup of 64
// keys, 32 queries a step, Q and dO loaded twice a step, once transposed
// element by element, no overlap of copies and math, 96 blocks on 132 SMs
// at Skv 512): TMA copies
// run ahead of the math, the products are wgmma, the key tile is 128 and the
// query step 64, Q and dO are read once a step, and the query split fills
// the card at short Skv.
//
// Head dims 96 and 120 run the D 128 tiles (kPad), as K1 and K2 do: the
// tensor maps carry the true D and TMA zero-fills the columns past it, so
// dK and dV get zero columns there, which neither the epilogue nor the
// query split's workspace (rows of the true D) stores.
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dpt {

using namespace hopper;

struct DkvArgs {
  const float* lse;  // [B, H, Sq], natural log
  const float* di;   // [B, H, Sq], rowsum(dO * O)
  const int* mask;   // [B, Skv], nonzero = valid key; may be null
  long long mask_sb;
  void* dk;          // contiguous [B, Skv, H, D]
  void* dv;
  float* ws;         // [tiles, splits, 2, 128, D] f32 when splits > 1
  int* counters;     // [tiles], zero on entry, when splits > 1
  int h, sq, skv;
  int splits, tiles_per_split;
  float scale;
  int d;             // the true head dim: HD, or under kPad less (96, 120)
};

template <int HD>
struct DkvTile {
  static constexpr int kBN = 128;  // keys a block (64 a consumer warpgroup)
  static constexpr int kBM = 64;   // queries a step
  static constexpr int kHD = HD;
  static constexpr int kStages = 3;
  static constexpr int kKVBytes = kBN * HD * 2;  // one of K or V
  static constexpr int kQBytes = kBM * HD * 2;   // one of Q or dO, a stage
  static constexpr int kOffV = kKVBytes;
  static constexpr int kOffQ = 2 * kKVBytes;
  static constexpr int kOffDO = kOffQ + kStages * kQBytes;
  static constexpr int kOffLse = kOffDO + kStages * kQBytes;
  static constexpr int kOffDi = kOffLse + kStages * kBM * 4;
  static constexpr int kOffBar = kOffDi + kStages * kBM * 4;  // kv, full[S]
  static constexpr int kOffFlag = kOffBar + 8 * (1 + kStages);
  static constexpr int kSmem = kOffFlag + 16 + 1024;  // + alignment
  static constexpr int kThreads = 256;  // two warpgroups
};

// Thread 0 issues the TMA copies of query step `step` (Q and dO tiles) into
// stage `s`; they complete a transaction on the stage's full barrier.
template <typename C>
__device__ __forceinline__ void load_step(const CUtensorMap* tm_q, const CUtensorMap* tm_do,
                                          uint32_t base, uint32_t bar, int s, int m0,
                                          int h, int b) {
  mbar_arrive_expect_tx(bar, 2 * C::kQBytes);
  const uint32_t dq = base + C::kOffQ + s * C::kQBytes;
  const uint32_t ddo = base + C::kOffDO + s * C::kQBytes;
#pragma unroll
  for (int hf = 0; hf < C::kHD / 64; ++hf) {
    tma_load_4d(dq + hf * C::kBM * 128, tm_q, bar, hf * 64, h, m0, b);
    tma_load_4d(ddo + hf * C::kBM * 128, tm_do, bar, hf * 64, h, m0, b);
  }
}

template <typename T, int HD, bool kPad>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const DkvArgs a) {
  using C = DkvTile<HD>;
  constexpr int BN = C::kBN, BM = C::kBM, S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bar_kv = base + C::kOffBar;
  const uint32_t bar_full = bar_kv + 8;  // + 8 * stage
  float* s_lse = reinterpret_cast<float*>(sm + C::kOffLse);  // [S][BM], times log2 e
  float* s_di = reinterpret_cast<float*>(sm + C::kOffDi);    // [S][BM]
  int* s_flag = reinterpret_cast<int*>(sm + C::kOffFlag);

  const int kv_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int n0 = kv_tile * BN;
  const int q_tiles = (a.sq + BM - 1) / BM;
  const int t_begin = split * a.tiles_per_split;
  const int n_steps = max(0, min(q_tiles, t_begin + a.tiles_per_split) - t_begin);
  const int tid = threadIdx.x;  // 0..255 over both warpgroups
  const int64_t row0 = ((int64_t)b * a.h + h) * a.sq;

  // LSE (times log2 e) and D of query step `step`, row tid (< BM); rows past
  // Sq get P = exp2(-inf) = 0, so they add nothing
  auto lse_of = [&](int step) {
    const int i = (t_begin + step) * BM + tid;
    return i < a.sq ? a.lse[row0 + i] * kLog2e : INFINITY;
  };
  auto di_of = [&](int step) {
    const int i = (t_begin + step) * BM + tid;
    return i < a.sq ? a.di[row0 + i] : 0.f;
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) mbar_init(bar_full + 8 * s, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    prefetch_tensor_map(&tm_q);
    prefetch_tensor_map(&tm_do);
    mbar_arrive_expect_tx(bar_kv, 2 * C::kKVBytes);
#pragma unroll
    for (int hf = 0; hf < HD / 64; ++hf) {
      tma_load_4d(base + hf * BN * 128, &tm_k, bar_kv, hf * 64, h, n0, b);
      tma_load_4d(base + C::kOffV + hf * BN * 128, &tm_v, bar_kv, hf * 64, h, n0, b);
    }
    for (int j = 0; j < min(S, n_steps); ++j)
      load_step<C>(&tm_q, &tm_do, base, bar_full + 8 * j, j, (t_begin + j) * BM, h, b);
  }
  if (tid < BM) {
    for (int j = 0; j < min(S, n_steps); ++j) {
      s_lse[j * BM + tid] = lse_of(j);
      s_di[j * BM + tid] = di_of(j);
    }
  }
  __syncthreads();

  // warpgroup cw owns keys n0 + 64 cw + [0, 64)
  const int cw = tid / 128;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int t = lane & 3;
  const int lr0 = cw * 64 + warp * 16 + (lane >> 2);  // this thread's rows in the tile
  // a key that is masked or past Skv has P = 0. A select, not a multiply:
  // a row with no valid key has LSE = -0.7 f32max, whose log2 overflows to
  // -inf, so its exponent is +inf and 0 * inf would be NaN
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + lr0 + 8 * r;
    ok[r] = key < a.skv && (a.mask == nullptr || a.mask[b * a.mask_sb + key] != 0);
  }

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
  const float sc = a.scale * kLog2e;
  const uint32_t k_rows = base + cw * 64 * 128;
  const uint32_t v_rows = base + C::kOffV + cw * 64 * 128;

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_steps; ++j) {
    const int s = j % S;
    // this step's LSE and D for step j + S, loaded now and stored once the
    // stage is free, so their latency hides behind this step
    float l_next = 0.f, d_next = 0.f;
    const bool refill = j + S < n_steps;
    if (refill && tid < BM) {
      l_next = lse_of(j + S);
      d_next = di_of(j + S);
    }
    mbar_wait(bar_full + 8 * s, (j / S) & 1);
    const uint32_t sq_s = base + C::kOffQ + s * C::kQBytes;
    const uint32_t sdo_s = base + C::kOffDO + s * C::kQBytes;

    // S^T = K Q^T and dP^T = V dO^T, both in flight together
    float st[BM / 2], dpt[BM / 2];
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 elements a k-step
      wgmma_ss<T, BM>(st, desc_k_major(k_rows + (kk / 4) * BN * 128 + off),
                      desc_k_major(sq_s + (kk / 4) * BM * 128 + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss<T, BM>(dpt, desc_k_major(v_rows + (kk / 4) * BN * 128 + off),
                      desc_k_major(sdo_s + (kk / 4) * BM * 128 + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp2(S^T * scale * log2 e - LSE * log2 e) in f32 (in st), and
    // dS^T = P^T * (dP^T - D) * scale (in dpt)
    const float* lse2 = s_lse + s * BM;
    const float* dd = s_di + s * BM;
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * i + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(dd + 8 * i + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = exp2_approx(fmaf(st[4 * i + c], sc, -((c & 1) ? l.y : l.x)));
        const float p = ok[c >> 1] ? e : 0.f;
        dpt[4 * i + c] = p * (dpt[4 * i + c] - ((c & 1) ? d.y : d.x)) * a.scale;
        st[4 * i + c] = p;
      }
    }
    // both rounded to T as A fragments: dV += P^T dO and dK += dS^T Q
    uint32_t pa[BM / 16][4], dsa[BM / 16][4];
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = Elem<T>::pack(st[8 * kk + 2 * r], st[8 * kk + 2 * r + 1]);
        dsa[kk][r] = Elem<T>::pack(dpt[8 * kk + 2 * r], dpt[8 * kk + 2 * r + 1]);
      }
    }
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<T, HD>(dv, pa[kk], desc_mn_major(sdo_s + kk * 16 * 128, BM * 128));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_rs<T, HD>(dk, dsa[kk], desc_mn_major(sq_s + kk * 16 * 128, BM * 128));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(dsa);

    // both warpgroups are done with stage s: refill it with step j + S
    named_barrier_sync(1, 256);
    if (refill) {
      if (tid < BM) {
        s_lse[s * BM + tid] = l_next;
        s_di[s * BM + tid] = d_next;
      }
      if (tid == 0)
        load_step<C>(&tm_q, &tm_do, base, bar_full + 8 * s, s, (t_begin + j + S) * BM, h, b);
    }
  }

  const int dcols = kPad ? a.d : HD;  // dK's and dV's columns
  const int64_t row_stride = (int64_t)a.h * dcols;
  const int64_t out_base = (int64_t)b * a.skv * row_stride + h * dcols;
  T* dk_out = static_cast<T*>(a.dk) + out_base;
  T* dv_out = static_cast<T*>(a.dv) + out_base;
  if (a.splits == 1) {
    store_acc<T, HD, kPad>(dk_out, row_stride, n0 + lr0, a.skv, dk, t, dcols);
    store_acc<T, HD, kPad>(dv_out, row_stride, n0 + lr0, a.skv, dv, t, dcols);
    return;
  }

  // query split: write this block's f32 partial; the last block of the
  // key tile sums all partials in split order
  const int tile = (b * a.h + h) * gridDim.x + kv_tile;
  const int64_t part = (int64_t)BN * dcols;  // floats of one of dK or dV
  float* mine = a.ws + ((int64_t)tile * a.splits + split) * 2 * part;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (kPad && c >= dcols) continue;
    *reinterpret_cast<float2*>(mine + lr0 * dcols + c) = make_float2(dk[4 * i], dk[4 * i + 1]);
    *reinterpret_cast<float2*>(mine + (lr0 + 8) * dcols + c) =
        make_float2(dk[4 * i + 2], dk[4 * i + 3]);
    *reinterpret_cast<float2*>(mine + part + lr0 * dcols + c) =
        make_float2(dv[4 * i], dv[4 * i + 1]);
    *reinterpret_cast<float2*>(mine + part + (lr0 + 8) * dcols + c) =
        make_float2(dv[4 * i + 2], dv[4 * i + 3]);
  }
  __threadfence();
  named_barrier_sync(1, 256);
  if (tid == 0) {
    const int done = atomicAdd(a.counters + tile, 1);
    *s_flag = done == a.splits - 1;
  }
  named_barrier_sync(1, 256);
  if (!*s_flag) return;
  __threadfence();
  const float* first = a.ws + (int64_t)tile * a.splits * 2 * part;
#pragma unroll 1
  for (int i = 0; i < HD / 8; ++i) {
    const int c = 8 * i + 2 * t;
    if (kPad && c >= dcols) continue;
    float2 k0 = make_float2(0.f, 0.f), k1 = k0, v0 = k0, v1 = k0;
    for (int sp = 0; sp < a.splits; ++sp) {
      const float* p = first + (int64_t)sp * 2 * part;
      const float2 x0 = __ldcg(reinterpret_cast<const float2*>(p + lr0 * dcols + c));
      const float2 x1 = __ldcg(reinterpret_cast<const float2*>(p + (lr0 + 8) * dcols + c));
      const float2 y0 = __ldcg(reinterpret_cast<const float2*>(p + part + lr0 * dcols + c));
      const float2 y1 =
          __ldcg(reinterpret_cast<const float2*>(p + part + (lr0 + 8) * dcols + c));
      k0.x += x0.x; k0.y += x0.y; k1.x += x1.x; k1.y += x1.y;
      v0.x += y0.x; v0.y += y0.y; v1.x += y1.x; v1.y += y1.y;
    }
    const int r0 = n0 + lr0, r1 = r0 + 8;
    if (r0 < a.skv) {
      *reinterpret_cast<uint32_t*>(dk_out + r0 * row_stride + c) = Elem<T>::pack(k0.x, k0.y);
      *reinterpret_cast<uint32_t*>(dv_out + r0 * row_stride + c) = Elem<T>::pack(v0.x, v0.y);
    }
    if (r1 < a.skv) {
      *reinterpret_cast<uint32_t*>(dk_out + r1 * row_stride + c) = Elem<T>::pack(k1.x, k1.y);
      *reinterpret_cast<uint32_t*>(dv_out + r1 * row_stride + c) = Elem<T>::pack(v1.x, v1.y);
    }
  }
}

// Whether each instance's shared-memory limit is set, per device. File-local
// on purpose: a function-local static of a template is one object across all
// loaded libraries (STB_GNU_UNIQUE), so a second build of this kernel in the
// same process would skip the call.
namespace {
bool g_smem_set[6][64];
template <typename T, int HD, bool kPad>
constexpr int smem_flag() {
  return (std::is_same<T, __half>::value ? 3 : 0) + (kPad ? 2 : HD == 128 ? 1 : 0);
}
}  // namespace

template <typename T, int HD, bool kPad = false>
cudaError_t run_dkv(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                    const CUtensorMap& tdo, const DkvArgs& a, int b, cudaStream_t stream) {
  using C = DkvTile<HD>;
  cudaError_t err = set_smem_once(flash_bwd_dkv_kernel<T, HD, kPad>, C::kSmem,
                                  g_smem_set[smem_flag<T, HD, kPad>()]);
  if (err != cudaSuccess) return err;
  dim3 grid((a.skv + C::kBN - 1) / C::kBN, a.h, b * a.splits);
  flash_bwd_dkv_kernel<T, HD, kPad><<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo,
                                                                             a);
  return cudaGetLastError();
}

}  // namespace dpt

// splits: blocks a key tile's query loop is split over (1: none); with
// splits > 1, ws holds splits * 2 * 128 * hd floats per key tile (key tiles
// of 128 rows, over heads and batch) and counters one zeroed int per key
// tile. hd: 64 or 128, or 96 or 120 on the D 128 tiles.
extern "C" int dpt_flash_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* mask, void* dk, void* dv,
    int b, int h, int sq, int skv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long mask_sb, float scale,
    int is_fp16, void* stream, int splits, void* ws, void* counters) {
  using Tile = dpt::DkvTile<128>;
  if (!dpt::kernel_head_dim(hd) || hd > 128) return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = dpt::hopper::make_bshd_map(&tq, q, is_fp16, b, sq, h, hd, q_sb, q_ss,
                                               q_sh, Tile::kBM);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tdo, dout, is_fp16, b, sq, h, hd, do_sb, do_ss,
                                     do_sh, Tile::kBM);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tk, k, is_fp16, b, skv, h, hd, k_sb, k_ss, k_sh,
                                     Tile::kBN);
  if (err == cudaSuccess)
    err = dpt::hopper::make_bshd_map(&tv, v, is_fp16, b, skv, h, hd, v_sb, v_ss, v_sh,
                                     Tile::kBN);
  if (err != cudaSuccess) return static_cast<int>(err);
  dpt::DkvArgs a = {};
  a.lse = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.mask = static_cast<const int*>(mask);
  a.mask_sb = mask_sb;
  a.dk = dk;
  a.dv = dv;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.h = h;
  a.sq = sq;
  a.skv = skv;
  a.d = hd;
  a.splits = splits;
  const int q_tiles = (sq + Tile::kBM - 1) / Tile::kBM;
  a.tiles_per_split = (q_tiles + splits - 1) / splits;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 64)
    err = is_fp16 ? dpt::run_dkv<__half, 64>(tq, tk, tv, tdo, a, b, s)
                  : dpt::run_dkv<__nv_bfloat16, 64>(tq, tk, tv, tdo, a, b, s);
  else if (hd < 128)
    err = is_fp16 ? dpt::run_dkv<__half, 128, true>(tq, tk, tv, tdo, a, b, s)
                  : dpt::run_dkv<__nv_bfloat16, 128, true>(tq, tk, tv, tdo, a, b, s);
  else
    err = is_fp16 ? dpt::run_dkv<__half, 128>(tq, tk, tv, tdo, a, b, s)
                  : dpt::run_dkv<__nv_bfloat16, 128>(tq, tk, tv, tdo, a, b, s);
  return static_cast<int>(err);
}
