// Flash-attention backward, dK/dV part (K3), at head dim 256 for Hopper:
// wgmma with TMA tile copies.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_dkv_kernel` / `_dkv_kernel_nomask` (lines 264 and 315, pallas_call at
// 396), launched by `_flash_backward`, at D = 256 (AuraFlow's head dim; the
// TPU kernels take any D that is a multiple of 128). flash_bwd_dkv.cu keeps
// D 64 and 128.
//
// Computes what flash_bwd_dkv.cu computes: P^T = exp(scale * K Q^T - LSE),
// dV = P^T dO and dK = dS^T Q with dS^T = P^T * (V dO^T - D) * scale. Masked
// keys and key rows past the sequence end get P = 0 (a select, never a
// product with a value that may be infinite), so their dK and dV rows are 0,
// and so are a batch element's whose keys are all masked.
//
// What bounds it on the H100: the tensor cores, four products of
// 2*Sq*Skv*D flops per (b, h): 0.945 ms at 989 TFLOP/s at AuraFlow's shape
// (B 2, H 12, S 4,360).
//
// Design: one block of two warpgroups (256 threads) per (key tile of 64
// rows at the full D, head, batch, query split). Warp 0 issues the copies
// with TMA: K and V once, then Q and dO tiles of 64 queries into a ring of
// 2 stages (full and empty mbarriers), each stage refilled once both
// warpgroups have freed it at the end of warp 0's step, its 32 lanes
// writing the step's LSE (times log2 e) and D rows beside it, read a step
// ahead. A step does each of the four products once, in two parts:
// 1. split by queries: warpgroup w computes S^T = K Q_w^T and dP^T = V dO_w^T
//    for its 32 of the 64 queries (m64n32k16, both operands K-major, in
//    flight together), forms P^T and dS^T in f32 registers and writes them,
//    rounded to the input type, into a 64 x 64 tile each, swizzled as wgmma
//    reads a K-major A operand;
// 2. split by D, after a named barrier over both warpgroups: warpgroup w
//    does dV[:, w half] += P^T dO[:, w half] and dK[:, w half] += dS^T
//    Q[:, w half] (m64n128k16, A and B from shared memory, B MN-major), so
//    dK and dV stay in registers, 64 + 64 f32 a thread.
// The P^T / dS^T tiles are double-buffered: a warpgroup that writes step
// j + 2's into a buffer has passed step j + 1's barrier, after which the
// other warpgroup has finished step j's products. Shared memory: K, V
// 32 KB each + 2 x (Q, dO 32 KB each) + 2 x (P^T, dS^T 8 KB each) + LSE
// and D = 225 KB. There is no producer warpgroup or warp: ptxas places the
// wgmmas within the launch bound's registers, 168 a thread at 288 or 384
// threads whatever setmaxnreg grants, which spilled and serialized every
// wgmma (C7512); at 256 threads it takes 194 registers and spills nothing.
//
// Short key sequences: when the key tiles (x heads x batch) are fewer than
// the SMs, the wrapper splits the query loop over `splits` blocks per key
// tile; each writes its f32 dK/dV partial to a workspace and the last block
// of a tile to finish (a counter in global memory) sums the partials in
// split order, as flash_bwd_dkv.cu does, so the result is the same bits
// from run to run.
//
// Against the first design at D 256 (mma.sync m16n8k16, formerly in
// flash_d256.cu: one warp per 16 rows, cp.async copies by every warp, a
// block of 128 keys and one half of D, 32 queries a step): the products are
// wgmma, the copies are TMA from one lane, and S^T and dP^T are computed
// once a step instead of once for each half of D (4 products, not 6).
#include "flash_common.cuh"
#include "hopper_common.cuh"

namespace dpt {

using namespace hopper;

struct Dkv256Args {
  const float* lse;  // [B, H, Sq], natural log
  const float* di;   // [B, H, Sq], rowsum(dO * O)
  const int* mask;   // [B, Skv], nonzero = valid key; may be null
  long long mask_sb;
  void* dk;          // contiguous [B, Skv, H, 256]
  void* dv;
  float* ws;         // [tiles, splits, 2, 64, 256] f32 when splits > 1
  int* counters;     // [tiles], zero on entry, when splits > 1
  int h, sq, skv;
  int splits, tiles_per_split;
  float scale;
};

struct Dkv256Tile {
  static constexpr int kD = 256;
  static constexpr int kBN = 64;  // keys a block
  static constexpr int kBM = 64;  // queries a step (32 a warpgroup in part 1)
  static constexpr int kStages = 2;
  static constexpr int kBox = 64 * 128;         // 64 rows x 64 columns: one TMA box
  static constexpr int kTile = (kD / 64) * kBox;  // 64 rows x D: K, V, or a stage's Q or dO
  static constexpr int kOffV = kTile;
  static constexpr int kOffQ = 2 * kTile;
  static constexpr int kOffDO = kOffQ + kStages * kTile;
  static constexpr int kOffP = kOffDO + kStages * kTile;  // P^T, 2 buffers of one box
  static constexpr int kOffDS = kOffP + 2 * kBox;         // dS^T, the same
  static constexpr int kOffLse = kOffDS + 2 * kBox;       // [S][BM] f32, times log2 e
  static constexpr int kOffDi = kOffLse + kStages * kBM * 4;
  static constexpr int kOffBar = kOffDi + kStages * kBM * 4;  // kv, full[S], empty[S]
  static constexpr int kOffFlag = kOffBar + 8 * (1 + 2 * kStages);
  static constexpr int kSmem = kOffFlag + 16 + 1024;  // + alignment
  static constexpr int kThreads = 256;  // two warpgroups
  static_assert(kSmem <= 232448, "shared memory a block may hold");
};

template <typename T>
__global__ void __launch_bounds__(256, 1)
    flash_bwd_dkv_d256_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const Dkv256Args a) {
  using C = Dkv256Tile;
  constexpr int BN = C::kBN, BM = C::kBM, S = C::kStages, D = C::kD;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sm = smem_raw + (base - raw);
  const uint32_t bar_kv = base + C::kOffBar;
  const uint32_t bar_full = bar_kv + 8;  // + 8 * stage
  const uint32_t bar_empty = bar_full + 8 * S;
  float* s_lse = reinterpret_cast<float*>(sm + C::kOffLse);
  float* s_di = reinterpret_cast<float*>(sm + C::kOffDi);
  int* s_flag = reinterpret_cast<int*>(sm + C::kOffFlag);

  const int kv_tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / a.splits;
  const int split = blockIdx.z % a.splits;
  const int n0 = kv_tile * BN;
  const int q_tiles = (a.sq + BM - 1) / BM;
  const int t_begin = split * a.tiles_per_split;
  const int n_steps = max(0, min(q_tiles, t_begin + a.tiles_per_split) - t_begin);

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);  // the copies' arrival + 32 lanes' rows
      mbar_init(bar_empty + 8 * s, 8);      // one lane of each of the 8 warps
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The copies, by warp 0 between its steps: K and V once (lane 0), then
  // the Q and dO tiles of query step j into stage j % S once both
  // warpgroups have freed it (load_step), with the step's LSE (times
  // log2 e) and D rows beside them, read a step ahead (rows_of); rows past
  // Sq get P = exp2(-inf) = 0 and D = 0, so they add nothing
  const CUtensorMap* pq = &tm_q;
  const CUtensorMap* pdo = &tm_do;
  const int64_t row0 = ((int64_t)b * a.h + h) * a.sq;
  // (read into the registers with no arithmetic, so that a read ahead does
  // not wait; load_step scales the LSE)
  auto rows_of = [&](int j, int lane, float (&l)[2], float (&d)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = (t_begin + j) * BM + lane + 32 * r;
      l[r] = INFINITY;
      d[r] = 0.f;
      if (i < a.sq) {
        l[r] = a.lse[row0 + i];
        d[r] = a.di[row0 + i];
      }
    }
  };
  auto load_step = [&](int j, int lane, const float (&l)[2], const float (&d)[2]) {
    const int s = j % S;
    const int m0 = (t_begin + j) * BM;
    mbar_wait(bar_empty + 8 * s, ((j / S) & 1) ^ 1);
    const uint32_t bar = bar_full + 8 * s;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar, 2 * C::kTile);
      const uint32_t dq = base + C::kOffQ + s * C::kTile;
      const uint32_t ddo = base + C::kOffDO + s * C::kTile;
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        tma_load_4d(dq + hf * C::kBox, pq, bar, hf * 64, h, m0, b);
        tma_load_4d(ddo + hf * C::kBox, pdo, bar, hf * 64, h, m0, b);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s_lse[s * BM + lane + 32 * r] = l[r] * kLog2e;
      s_di[s * BM + lane + 32 * r] = d[r];
    }
    mbar_arrive(bar);
  };
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      prefetch_tensor_map(pq);
      prefetch_tensor_map(pdo);
      mbar_arrive_expect_tx(bar_kv, 2 * C::kTile);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        tma_load_4d(base + hf * C::kBox, &tm_k, bar_kv, hf * 64, h, n0, b);
        tma_load_4d(base + C::kOffV + hf * C::kBox, &tm_v, bar_kv, hf * 64, h, n0, b);
      }
    }
    for (int j = 0; j < min(S, n_steps); ++j) {
      float l[2], d[2];
      rows_of(j, threadIdx.x, l, d);
      load_step(j, threadIdx.x, l, d);
    }
  }

  // ---- the math: warpgroup cw takes queries 32 cw + [0, 32) of a step in
  // part 1 and columns 128 cw + [0, 128) of dK and dV in part 2 ----
  const int cw = threadIdx.x / 128;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int lr0 = warp * 16 + (lane >> 2);  // this thread's key rows lr0, lr0 + 8
  // a key that is masked or past Skv has P = 0. A select, not a multiply:
  // a row with no valid key has LSE = -0.7 f32max, whose log2 overflows to
  // -inf, so its exponent is +inf and 0 * inf would be NaN
  bool ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = n0 + lr0 + 8 * r;
    ok[r] = key < a.skv && (a.mask == nullptr || a.mask[b * a.mask_sb + key] != 0);
  }

  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  const float sc = a.scale * kLog2e;
  const uint32_t q_rows = cw * 32 * 128;     // this warpgroup's queries in a box
  const uint32_t d_half = 2 * cw * C::kBox;  // this warpgroup's boxes of D

  mbar_wait(bar_kv, 0);
  for (int j = 0; j < n_steps; ++j) {
    const int s = j % S;
    const int pb = j & 1;  // P^T / dS^T buffer
    float l_next[2], d_next[2];  // warp 0: the rows of the step it loads after this one
    if (threadIdx.x < 32 && j + S < n_steps) rows_of(j + S, lane, l_next, d_next);
    mbar_wait(bar_full + 8 * s, (j / S) & 1);
    const uint32_t sq_s = base + C::kOffQ + s * C::kTile;
    const uint32_t sdo_s = base + C::kOffDO + s * C::kTile;

    // part 1: S^T = K Q^T and dP^T = V dO^T on this warpgroup's 32 queries
    float st[16], dpt[16];
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::kBox + (kk % 4) * 32;  // 16 elements a k-step
      wgmma_ss<T, 32>(st, desc_k_major(base + off), desc_k_major(sq_s + q_rows + off), kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk / 4) * C::kBox + (kk % 4) * 32;
      wgmma_ss<T, 32>(dpt, desc_k_major(base + C::kOffV + off),
                      desc_k_major(sdo_s + q_rows + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // P^T = exp2(S^T * scale * log2 e - LSE * log2 e) and dS^T = P^T *
    // (dP^T - D) * scale in f32, rounded to T into the K-major A tiles:
    // element (key r, query c) at byte r * 128 + ((c / 8) ^ (r % 8)) * 16 +
    // (c % 8) * 2
    const float* lse2 = s_lse + s * BM + cw * 32;
    const float* dd = s_di + s * BM + cw * 32;
    unsigned char* p_tile = sm + C::kOffP + pb * C::kBox;
    unsigned char* ds_tile = sm + C::kOffDS + pb * C::kBox;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 l = *reinterpret_cast<const float2*>(lse2 + 8 * i + 2 * t);
      const float2 d = *reinterpret_cast<const float2*>(dd + 8 * i + 2 * t);
      float p[4], ds[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = exp2_approx(fmaf(st[4 * i + c], sc, -((c & 1) ? l.y : l.x)));
        p[c] = ok[c >> 1] ? e : 0.f;
        ds[c] = p[c] * (dpt[4 * i + c] - ((c & 1) ? d.y : d.x)) * a.scale;
      }
      const int chunk = 4 * cw + i;  // queries 32 cw + 8 i + [0, 8)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lr0 + 8 * r;
        const int at = row * 128 + ((chunk ^ (row & 7)) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(p_tile + at) = Elem<T>::pack(p[2 * r], p[2 * r + 1]);
        *reinterpret_cast<uint32_t*>(ds_tile + at) = Elem<T>::pack(ds[2 * r], ds[2 * r + 1]);
      }
    }
    fence_proxy_async();
    named_barrier_sync(1, 256);

    // part 2: dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half]
    const uint32_t pa = base + C::kOffP + pb * C::kBox;
    const uint32_t dsa = base + C::kOffDS + pb * C::kBox;
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_ss_mn<T, 128>(dv, desc_k_major(pa + kk * 32),
                          desc_mn_major(sdo_s + d_half + kk * 16 * 128, C::kBox));
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      wgmma_ss_mn<T, 128>(dk, desc_k_major(dsa + kk * 32),
                          desc_mn_major(sq_s + d_half + kk * 16 * 128, C::kBox));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    if (threadIdx.x < 32 && j + S < n_steps) load_step(j + S, lane, l_next, d_next);
  }

  const int64_t row_stride = (int64_t)a.h * D;
  const int64_t out_base = (int64_t)b * a.skv * row_stride + h * D + cw * 128;
  T* dk_out = static_cast<T*>(a.dk) + out_base;
  T* dv_out = static_cast<T*>(a.dv) + out_base;
  if (a.splits == 1) {
    store_acc<T, 128>(dk_out, row_stride, n0 + lr0, a.skv, dk, t);
    store_acc<T, 128>(dv_out, row_stride, n0 + lr0, a.skv, dv, t);
    return;
  }

  // query split: write this block's f32 partial; the last block of the key
  // tile sums all partials in split order
  const int tile = (b * a.h + h) * gridDim.x + kv_tile;
  const int64_t part = (int64_t)BN * D;  // floats of one of dK or dV
  float* mine = a.ws + ((int64_t)tile * a.splits + split) * 2 * part + cw * 128;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t at = (int64_t)(lr0 + 8 * r) * D + c;
      *reinterpret_cast<float2*>(mine + at) = make_float2(dk[4 * i + 2 * r], dk[4 * i + 2 * r + 1]);
      *reinterpret_cast<float2*>(mine + part + at) =
          make_float2(dv[4 * i + 2 * r], dv[4 * i + 2 * r + 1]);
    }
  }
  __threadfence();
  named_barrier_sync(1, 256);
  if (threadIdx.x == 0) *s_flag = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  named_barrier_sync(1, 256);
  if (!*s_flag) return;
  __threadfence();
  const float* first = a.ws + (int64_t)tile * a.splits * 2 * part + cw * 128;
#pragma unroll 1
  for (int i = 0; i < 16; ++i) {
    const int c = 8 * i + 2 * t;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t at = (int64_t)(lr0 + 8 * r) * D + c;
      float2 ks = make_float2(0.f, 0.f), vs = ks;
      for (int sp = 0; sp < a.splits; ++sp) {
        const float* p = first + (int64_t)sp * 2 * part;
        const float2 x = __ldcg(reinterpret_cast<const float2*>(p + at));
        const float2 y = __ldcg(reinterpret_cast<const float2*>(p + part + at));
        ks.x += x.x;
        ks.y += x.y;
        vs.x += y.x;
        vs.y += y.y;
      }
      const int row = n0 + lr0 + 8 * r;
      if (row < a.skv) {
        *reinterpret_cast<uint32_t*>(dk_out + row * row_stride + c) = Elem<T>::pack(ks.x, ks.y);
        *reinterpret_cast<uint32_t*>(dv_out + row * row_stride + c) = Elem<T>::pack(vs.x, vs.y);
      }
    }
  }
}

// Whether each instance's shared-memory limit is set, per device (file-local:
// see flash_bwd_dkv.cu).
namespace {
bool g_smem_set[2][64];
}  // namespace

template <typename T>
cudaError_t run_dkv_d256(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         const CUtensorMap& tdo, const Dkv256Args& a, int b,
                         cudaStream_t stream) {
  using C = Dkv256Tile;
  cudaError_t err = set_smem_once(flash_bwd_dkv_d256_kernel<T>, C::kSmem,
                                  g_smem_set[std::is_same<T, __half>::value ? 1 : 0]);
  if (err != cudaSuccess) return err;
  dim3 grid((a.skv + C::kBN - 1) / C::kBN, a.h, b * a.splits);
  flash_bwd_dkv_d256_kernel<T><<<grid, C::kThreads, C::kSmem, stream>>>(tq, tk, tv, tdo, a);
  return cudaGetLastError();
}

}  // namespace dpt

// splits: blocks a key tile's query loop is split over (1: none); with
// splits > 1, ws holds splits * 2 * 64 * 256 floats per key tile (key tiles
// of 64 rows, over heads and batch) and counters one zeroed int per key tile.
extern "C" int dpt_flash_bwd_dkv_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* mask, void* dk, void* dv,
    int b, int h, int sq, int skv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long mask_sb, float scale,
    int is_fp16, void* stream, int splits, void* ws, void* counters) {
  using Tile = dpt::Dkv256Tile;
  if (hd != Tile::kD) return static_cast<int>(cudaErrorInvalidValue);
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
  dpt::Dkv256Args a = {};
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
  a.splits = splits;
  const int q_tiles = (sq + Tile::kBM - 1) / Tile::kBM;
  a.tiles_per_split = (q_tiles + splits - 1) / splits;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_fp16 ? dpt::run_dkv_d256<__half>(tq, tk, tv, tdo, a, b, s)
                : dpt::run_dkv_d256<__nv_bfloat16>(tq, tk, tv, tdo, a, b, s);
  return static_cast<int>(err);
}
