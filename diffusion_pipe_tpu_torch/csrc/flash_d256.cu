// Flash attention at head dim 256 (K1, K2 and K3) for Hopper: mma.sync with
// cp.async tile copies.
//
// Replaces the Pallas TPU kernels of diffusion_pipe_tpu/ops/flash_attention.py
// at D = 256 (the TPU kernels take any D that is a multiple of 128): the
// forward `_fwd_kernel` / `_fwd_kernel_nomask` (lines 59 and 204, launched by
// `_flash_forward`), the dQ kernel `_dq_kernel` / `_dq_kernel_nomask` (217,
// 258) and the dK/dV kernel `_dkv_kernel` / `_dkv_kernel_nomask` (264, 315),
// launched by `_flash_backward`. The three compute what flash_fwd.cu,
// flash_bwd_dq.cu and flash_bwd_dkv.cu compute at D 64 and 128, with the
// same mask, all-masked-row and query-split conventions; those files keep
// their wgmma kernels for D 64 and 128.
//
// What bounds them on the H100: the tensor cores. Per (b, h) the forward
// does 2 products of 2*Sq*Skv*D flops, dQ 3 and dK/dV 4, against
// (2*Sq + 2*Skv)*D*2 bytes or so: at AuraFlow's shape (B 2, H 12, S 4,360)
// 0.47 / 0.71 / 0.94 ms at 989 TFLOP/s.
//
// Why not the D 128 tiles: the wgmma kernels hold a 64-row accumulator of D
// columns per consumer warpgroup and stage 128-key K and V tiles; at D 256
// the O / dQ accumulator alone is 128 f32 a thread, K3's dK and dV would be
// 256, and the staged tiles pass the 227 KB a block may hold. So this file
// is a first design that is right and simple: mma.sync m16n8k16 (f32
// accumulators), one warp per 16 rows, tiles copied with cp.async into
// XOR-swizzled shared memory (16-byte chunk c of row r at c ^ (r & 7), so
// ldmatrix reads 8 rows without bank conflicts) in a ring of 2 stages.
//
// K1 (flash_fwd_d256): a block of 4 warps owns 64 query rows and steps over
// 32 keys; S = Q K^T, the online softmax in the exp2 domain, O += P V with P
// rounded to the input type and taken from registers. O is 128 f32 a thread.
// Shared memory: Q 32 KB + 2 x (K, V 16 KB each) = 96 KB, two blocks an SM.
//
// K2 (flash_bwd_dq_d256): a block of 8 warps owns 128 query rows and steps
// over 32 keys; S = Q K^T and dP = dO V^T, P = exp(scale S - LSE), dS =
// P (dP - D) scale rounded to the input type, dQ += dS K. dQ is 128 f32 a
// thread. Shared memory: Q, dO 64 KB each + 2 x (K, V 16 KB each) = 192 KB.
//
// K3 (flash_bwd_dkv_d256): a block of 8 warps owns 128 keys and one half of
// D (128 columns) of their dK and dV, and steps over 32 queries: S^T = K
// Q^T and dP^T = V dO^T over the full D, then dV += P^T dO and dK += dS^T Q
// over its half. dK and dV are 64 f32 each a thread. The two halves of a key
// tile recompute S^T and dP^T each, so K3 does 6 products where 4 would do:
// the price of keeping dK and dV in registers. (A version that split the
// work between pairs of warps, one computing P^T and dV, the other dP^T, dS^T
// and dK, so that no product was done twice, was within a few percent of
// this one's time at AuraFlow's shape and spilled registers: at 8 warps an
// SM these kernels wait on latency more than on their products.) Shared
// memory: K, V 64 KB
// each + 2 x (Q, dO 16 KB each) = 192 KB. When the key tiles (x halves x
// heads x batch) do not fill the card the wrapper splits the query loop
// over `splits` blocks; each writes its f32 partial to a workspace and the
// last block of the tile to finish sums them in split order, as in
// flash_bwd_dkv.cu, so the result is the same bits from run to run.
//
// Masked keys, keys past Skv and query rows past Sq get P = 0 (a select,
// never a product with a value that may be infinite); rows past the ends
// are copied as zeros and never stored. A query row with no valid key gets
// O = 0 and LSE = -0.7 * FLT_MAX in K1 and zero gradients in K2 and K3.
#include <initializer_list>

#include "flash_common.cuh"

namespace dpt {
namespace d256 {

constexpr int kD = 256;
constexpr int kRowBytes = kD * 2;  // one row of a tile
constexpr int kChunks = kD / 8;    // 16-byte chunks a row

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `c` of row `r` in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * kRowBytes + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// ldmatrix row address of lane `lane` for an A fragment (rows r0..r0+15,
// chunks kc, kc+1 of a row-major [row][k] tile); the same address gives, with
// .trans, the B fragments of two 8-column blocks (chunks kc, kc+1) over the
// 16 k rows r0..r0+15 of a [k][n] tile.
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int kc, int lane) {
  return tile + swz(r0 + (lane & 7) + ((lane >> 3) & 1) * 8, kc + (lane >> 4));
}

// ldmatrix row address for the B fragments of two 8-row blocks n0..n0+15 of
// an [n][k] tile (K-major B) at chunks kc, kc+1: regs 0, 1 are block 0's b0,
// b1 and regs 2, 3 block 1's.
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int n0, int kc, int lane) {
  return tile + swz(n0 + (lane & 7) + (lane >> 4) * 8, kc + ((lane >> 3) & 1));
}

// cp.async of rows [row0, row0 + rows) of a [S, D] head view (row stride in
// elements) into a swizzled tile; rows at or past `limit` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(uint32_t tile, const T* src, long long stride,
                                          int row0, int rows, int limit, int tid,
                                          int threads) {
  for (int i = tid; i < rows * kChunks; i += threads) {
    const int r = i / kChunks, c = i % kChunks;
    const int g = row0 + r;
    const bool ok = g < limit;
    cp_async16(tile + swz(r, c), src + (ok ? (long long)g * stride : 0) + c * 8, ok);
  }
}

// 32 key-validity bits of keys key0..key0+31 (key < skv and the mask), by
// one whole warp
__device__ __forceinline__ uint32_t key_bits(const int* mask, int key0, int skv, int lane) {
  const int key = key0 + lane;
  const bool ok = key < skv && (mask == nullptr || mask[key] != 0);
  return __ballot_sync(0xffffffffu, ok);
}

// S[16 x 32] += A-tile rows r0.. (all of D) times the 32 rows of a K-major B tile
template <typename T>
__device__ __forceinline__ void rows_x_keys(float (&acc)[4][4], uint32_t a_tile, int r0,
                                            uint32_t b_tile, int lane) {
#pragma unroll
  for (int kc = 0; kc < kChunks; kc += 2) {
    uint32_t af[4];
    ldsm_x4(a_addr(a_tile, r0, kc, lane), af);
#pragma unroll
    for (int nb = 0; nb < 4; nb += 2) {
      uint32_t bf[4];
      ldsm_x4(b_addr(b_tile, nb * 8, kc, lane), bf);
      Mma<T>::run(acc[nb], af, bf[0], bf[1]);
      Mma<T>::run(acc[nb + 1], af, bf[2], bf[3]);
    }
  }
}

// the A fragments of a 16 x 32 accumulator rounded to T (two k-steps of 16)
template <typename T>
__device__ __forceinline__ void to_a_frags(const float (&p)[4][4], uint32_t (&a)[2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    a[k][0] = Elem<T>::pack(p[2 * k][0], p[2 * k][1]);
    a[k][1] = Elem<T>::pack(p[2 * k][2], p[2 * k][3]);
    a[k][2] = Elem<T>::pack(p[2 * k + 1][0], p[2 * k + 1][1]);
    a[k][3] = Elem<T>::pack(p[2 * k + 1][2], p[2 * k + 1][3]);
  }
}

// acc[NB x 8 columns from chunk c0] += A (16 x 32, from registers) times the
// 32 rows of a [k][n] tile, columns from chunk c0 on
template <typename T, int NB>
__device__ __forceinline__ void frags_x_rows(float (&acc)[NB][4], const uint32_t (&a)[2][4],
                                             uint32_t tile, int c0, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t bf[4];
      ldsm_x4_t(a_addr(tile, 16 * k, c0 + n, lane), bf);
      Mma<T>::run(acc[n], a[k], bf[0], bf[1]);
      Mma<T>::run(acc[n + 1], a[k], bf[2], bf[3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *di;
  const int* mask;
  void *out0, *out1;  // K1: O; K2: dQ; K3: dK, dV
  float* lse;         // K1's LSE
  float* ws;          // K3's split partials
  int* counters;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, mask_sb;
  int h, sq, skv, splits, tiles_per_split;
  float scale;
};

// ---- K1 -------------------------------------------------------------------

constexpr int kFwdBM = 64, kFwdBN = 32, kFwdThreads = 128;
constexpr int kFwdQ = kFwdBM * kRowBytes, kFwdKV = kFwdBN * kRowBytes;
constexpr int kFwdSmem = kFwdQ + 4 * kFwdKV + 16;

template <typename T>
__global__ void __launch_bounds__(kFwdThreads, 2) flash_fwd_d256(const Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t s_q = smem_addr(sm), s_k = s_q + kFwdQ, s_v = s_k + 2 * kFwdKV;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + kFwdQ + 4 * kFwdKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kFwdBM, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* mask = a.mask ? a.mask + b * a.mask_sb : nullptr;
  const int n_tiles = (a.skv + kFwdBN - 1) / kFwdBN;

  auto load_kv = [&](int j, int s) {
    load_rows(s_k + s * kFwdKV, k, a.k_ss, j * kFwdBN, kFwdBN, a.skv, tid, kFwdThreads);
    load_rows(s_v + s * kFwdKV, v, a.v_ss, j * kFwdBN, kFwdBN, a.skv, tid, kFwdThreads);
    if (warp == 0) {
      const uint32_t bits = key_bits(mask, j * kFwdBN, a.skv, lane);
      if (lane == 0) words[s] = bits;
    }
  };
  load_rows(s_q, q, a.q_ss, m0, kFwdBM, a.sq, tid, kFwdThreads);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  float o[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  const float sl2 = a.scale * kLog2e;
  const int r0 = warp * 16;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    cp_async_wait<1>();
    __syncthreads();
    float sacc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    rows_x_keys<T>(sacc, s_q, r0, s_k + s * kFwdKV, lane);

    const uint32_t bits = words[s];
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        sacc[n][e] = (bits >> col) & 1u ? sacc[n][e] * sl2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[n][e]);
      }
    float base[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      base[i] = mx[i] == -INFINITY ? 0.f : mx[i];
      alpha[i] = ex2(m_run[i] - base[i]);
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sacc[n][e] = ex2(sacc[n][e] - base[e >> 1]);
        sum[e >> 1] += sacc[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + sum[i];
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    uint32_t pa[2][4];
    to_a_frags<T>(sacc, pa);
    frags_x_rows<T, 32>(o, pa, s_v + s * kFwdKV, 0, lane);
    __syncthreads();
    if (j + 2 < n_tiles) load_kv(j + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const long long row_stride = (long long)a.h * kD;
  T* out = static_cast<T*>(a.out0) + (long long)b * a.sq * row_stride + h * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = quad_sum(l_run[i]);
    const int row = m0 + r0 + g + 8 * i;
    if (row >= a.sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      *reinterpret_cast<uint32_t*>(out + row * row_stride + n * 8 + 2 * t) =
          Elem<T>::pack(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (t == 0)
      a.lse[((long long)b * a.h + h) * a.sq + row] =
          l > 0.f ? (m_run[i] + __log2f(l)) * 0.6931471805599453f : kMaskValue;
  }
}

// ---- K2 -------------------------------------------------------------------

constexpr int kDqBM = 128, kDqBN = 32, kDqThreads = 256;
constexpr int kDqQ = kDqBM * kRowBytes, kDqKV = kDqBN * kRowBytes;
constexpr int kDqSmem = 2 * kDqQ + 4 * kDqKV + 16;

template <typename T>
__global__ void __launch_bounds__(kDqThreads, 1) flash_bwd_dq_d256(const Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t s_q = smem_addr(sm), s_do = s_q + kDqQ, s_k = s_do + kDqQ,
                 s_v = s_k + 2 * kDqKV;
  uint32_t* words = reinterpret_cast<uint32_t*>(sm + 2 * kDqQ + 4 * kDqKV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.x * kDqBM, h = blockIdx.y, b = blockIdx.z;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const int* mask = a.mask ? a.mask + b * a.mask_sb : nullptr;
  const int n_tiles = (a.skv + kDqBN - 1) / kDqBN;

  auto load_kv = [&](int j, int s) {
    load_rows(s_k + s * kDqKV, k, a.k_ss, j * kDqBN, kDqBN, a.skv, tid, kDqThreads);
    load_rows(s_v + s * kDqKV, v, a.v_ss, j * kDqBN, kDqBN, a.skv, tid, kDqThreads);
    if (warp == 0) {
      const uint32_t bits = key_bits(mask, j * kDqBN, a.skv, lane);
      if (lane == 0) words[s] = bits;
    }
  };
  load_rows(s_q, q, a.q_ss, m0, kDqBM, a.sq, tid, kDqThreads);
  load_rows(s_do, dout, a.do_ss, m0, kDqBM, a.sq, tid, kDqThreads);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 1) load_kv(1, 1);
  cp_async_commit();

  const int r0 = warp * 16;
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + r0 + g + 8 * i;
    const long long at = ((long long)b * a.h + h) * a.sq + row;
    lse2[i] = row < a.sq ? a.lse_in[at] * kLog2e : 0.f;
    di[i] = row < a.sq ? a.di[at] : 0.f;
  }
  float dq[32][4];
#pragma unroll
  for (int n = 0; n < 32; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  const float sl2 = a.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j & 1;
    cp_async_wait<1>();
    __syncthreads();
    float sacc[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = dp[n][e] = 0.f;
    rows_x_keys<T>(sacc, s_q, r0, s_k + s * kDqKV, lane);
    rows_x_keys<T>(dp, s_do, r0, s_v + s * kDqKV, lane);
    const uint32_t bits = words[s];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const int i = e >> 1;
        const float p = (bits >> col) & 1u ? ex2(sacc[n][e] * sl2 - lse2[i]) : 0.f;
        sacc[n][e] = p * (dp[n][e] - di[i]) * a.scale;
      }
    uint32_t dsa[2][4];
    to_a_frags<T>(sacc, dsa);
    frags_x_rows<T, 32>(dq, dsa, s_k + s * kDqKV, 0, lane);
    __syncthreads();
    if (j + 2 < n_tiles) load_kv(j + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const long long row_stride = (long long)a.h * kD;
  T* out = static_cast<T*>(a.out0) + (long long)b * a.sq * row_stride + h * kD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + r0 + g + 8 * i;
    if (row >= a.sq) continue;
#pragma unroll
    for (int n = 0; n < 32; ++n)
      *reinterpret_cast<uint32_t*>(out + row * row_stride + n * 8 + 2 * t) =
          Elem<T>::pack(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

// ---- K3 -------------------------------------------------------------------

constexpr int kDkvBN = 128, kDkvBM = 32, kDkvThreads = 256, kHalf = kD / 2;
constexpr int kDkvK = kDkvBN * kRowBytes, kDkvQ = kDkvBM * kRowBytes;
constexpr int kDkvOffRows = 2 * kDkvK + 4 * kDkvQ;  // LSE * log2 e, D: [2][32] f32 each
constexpr int kDkvSmem = kDkvOffRows + 4 * 2 * kDkvBM * 4 + 16;

template <typename T>
__global__ void __launch_bounds__(kDkvThreads, 1) flash_bwd_dkv_d256(const Args a) {
  extern __shared__ __align__(128) unsigned char sm[];
  const uint32_t s_k = smem_addr(sm), s_v = s_k + kDkvK, s_q = s_v + kDkvK,
                 s_do = s_q + 2 * kDkvQ;
  float* s_lse = reinterpret_cast<float*>(sm + kDkvOffRows);  // [2][32]
  float* s_di = s_lse + 2 * kDkvBM;                          // [2][32]
  int* s_flag = reinterpret_cast<int*>(s_di + 2 * kDkvBM);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv_tile = blockIdx.x >> 1, half = blockIdx.x & 1;
  const int n0 = kv_tile * kDkvBN, h = blockIdx.y;
  const int b = blockIdx.z / a.splits, split = blockIdx.z % a.splits;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const long long row_at = ((long long)b * a.h + h) * a.sq;
  const int q_tiles = (a.sq + kDkvBM - 1) / kDkvBM;
  const int t_begin = split * a.tiles_per_split;
  const int t_end = min(q_tiles, t_begin + a.tiles_per_split);
  const int n_steps = max(0, t_end - t_begin);

  auto load_q = [&](int j, int s) {
    const int row0 = (t_begin + j) * kDkvBM;
    load_rows(s_q + s * kDkvQ, q, a.q_ss, row0, kDkvBM, a.sq, tid, kDkvThreads);
    load_rows(s_do + s * kDkvQ, dout, a.do_ss, row0, kDkvBM, a.sq, tid, kDkvThreads);
    if (tid < kDkvBM) {
      const int row = row0 + tid;
      s_lse[s * kDkvBM + tid] = row < a.sq ? a.lse_in[row_at + row] * kLog2e : 0.f;
      s_di[s * kDkvBM + tid] = row < a.sq ? a.di[row_at + row] : 0.f;
    }
  };
  load_rows(s_k, k, a.k_ss, n0, kDkvBN, a.skv, tid, kDkvThreads);
  load_rows(s_v, v, a.v_ss, n0, kDkvBN, a.skv, tid, kDkvThreads);
  if (n_steps > 0) load_q(0, 0);
  cp_async_commit();
  if (n_steps > 1) load_q(1, 1);
  cp_async_commit();

  const int r0 = warp * 16;
  bool kvalid[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = n0 + r0 + g + 8 * i;
    kvalid[i] = key < a.skv && (a.mask == nullptr || a.mask[b * a.mask_sb + key] != 0);
  }
  float dk[16][4], dv[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const float sl2 = a.scale * kLog2e;
  const int c0 = half * (kHalf / 8);

  for (int j = 0; j < n_steps; ++j) {
    const int s = j & 1;
    cp_async_wait<1>();
    __syncthreads();
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    rows_x_keys<T>(st, s_k, r0, s_q + s * kDkvQ, lane);
    rows_x_keys<T>(dpt, s_v, r0, s_do + s * kDkvQ, lane);
    const int qrow0 = (t_begin + j) * kDkvBM;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        const bool ok = kvalid[e >> 1] && qrow0 + col < a.sq;
        const float p = ok ? ex2(st[n][e] * sl2 - s_lse[s * kDkvBM + col]) : 0.f;
        st[n][e] = p;
        dpt[n][e] = p * (dpt[n][e] - s_di[s * kDkvBM + col]) * a.scale;
      }
    uint32_t pa[2][4], dsa[2][4];
    to_a_frags<T>(st, pa);
    to_a_frags<T>(dpt, dsa);
    frags_x_rows<T, 16>(dv, pa, s_do + s * kDkvQ, c0, lane);
    frags_x_rows<T, 16>(dk, dsa, s_q + s * kDkvQ, c0, lane);
    __syncthreads();
    if (j + 2 < n_steps) load_q(j + 2, s);
    cp_async_commit();
  }
  cp_async_wait<0>();

  const long long row_stride = (long long)a.h * kD;
  const long long out_base = (long long)b * a.skv * row_stride + h * kD + half * kHalf;
  T* dk_out = static_cast<T*>(a.out0) + out_base;
  T* dv_out = static_cast<T*>(a.out1) + out_base;
  const int lr0 = r0 + g;  // rows lr0 and lr0 + 8 of the key tile
  if (a.splits == 1) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = n0 + lr0 + 8 * i;
      if (row >= a.skv) continue;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int c = n * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(dk_out + row * row_stride + c) =
            Elem<T>::pack(dk[n][2 * i], dk[n][2 * i + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + row * row_stride + c) =
            Elem<T>::pack(dv[n][2 * i], dv[n][2 * i + 1]);
      }
    }
    return;
  }

  // query split: this block's f32 partial, then the last block of the tile
  // sums all partials in split order
  const int tile = (b * a.h + h) * gridDim.x + blockIdx.x;
  const long long part = (long long)kDkvBN * kHalf;  // floats of one of dK or dV
  float* mine = a.ws + ((long long)tile * a.splits + split) * 2 * part;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr0 + 8 * i;
      *reinterpret_cast<float2*>(mine + r * kHalf + c) = make_float2(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<float2*>(mine + part + r * kHalf + c) =
          make_float2(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_flag = atomicAdd(a.counters + tile, 1) == a.splits - 1;
  __syncthreads();
  if (!*s_flag) return;
  __threadfence();
  const float* first = a.ws + (long long)tile * a.splits * 2 * part;
#pragma unroll 1
  for (int n = 0; n < 16; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = lr0 + 8 * i;
      float2 ks = make_float2(0.f, 0.f), vs = ks;
      for (int sp = 0; sp < a.splits; ++sp) {
        const float* p = first + (long long)sp * 2 * part;
        const float2 x = __ldcg(reinterpret_cast<const float2*>(p + r * kHalf + c));
        const float2 y = __ldcg(reinterpret_cast<const float2*>(p + part + r * kHalf + c));
        ks.x += x.x;
        ks.y += x.y;
        vs.x += y.x;
        vs.y += y.y;
      }
      const int row = n0 + r;
      if (row < a.skv) {
        *reinterpret_cast<uint32_t*>(dk_out + row * row_stride + c) = Elem<T>::pack(ks.x, ks.y);
        *reinterpret_cast<uint32_t*>(dv_out + row * row_stride + c) = Elem<T>::pack(vs.x, vs.y);
      }
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, int threads, int smem, const Args& a,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// strides must be multiples of 8 elements (16-byte copies)
inline bool aligned(std::initializer_list<long long> strides) {
  for (long long s : strides)
    if (s % 8 != 0) return false;
  return true;
}

}  // namespace d256
}  // namespace dpt

using dpt::d256::Args;

extern "C" int dpt_flash_fwd_d256(
    const void* q, const void* k, const void* v, const void* mask, void* o,
    void* lse, int b, int h, int sq, int skv, int hd, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long mask_sb, float scale, int is_fp16, void* stream) {
  namespace K = dpt::d256;
  if (hd != K::kD || !K::aligned({q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh}))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.q = q; a.k = k; a.v = v;
  a.mask = static_cast<const int*>(mask);
  a.out0 = o;
  a.lse = static_cast<float*>(lse);
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.mask_sb = mask_sb;
  a.h = h; a.sq = sq; a.skv = skv; a.scale = scale;
  dim3 grid((sq + K::kFwdBM - 1) / K::kFwdBM, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_fp16
      ? K::launch(K::flash_fwd_d256<__half>, grid, K::kFwdThreads, K::kFwdSmem, a, s)
      : K::launch(K::flash_fwd_d256<__nv_bfloat16>, grid, K::kFwdThreads, K::kFwdSmem, a, s);
  return static_cast<int>(err);
}

static Args bwd_args(const void* q, const void* k, const void* v, const void* dout,
                     const void* lse, const void* di, const void* mask, int h, int sq, int skv,
                     long long q_sb, long long q_ss, long long q_sh, long long k_sb,
                     long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                     long long v_sh, long long do_sb, long long do_ss, long long do_sh,
                     long long mask_sb, float scale) {
  Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.mask = static_cast<const int*>(mask);
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.mask_sb = mask_sb;
  a.h = h; a.sq = sq; a.skv = skv; a.scale = scale;
  a.splits = 1;
  return a;
}

extern "C" int dpt_flash_bwd_dq_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* mask, void* dq,
    int b, int h, int sq, int skv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long mask_sb, float scale,
    int is_fp16, void* stream) {
  namespace K = dpt::d256;
  if (hd != K::kD ||
      !K::aligned({q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh}))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = bwd_args(q, k, v, dout, lse, di, mask, h, sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss,
                    k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, mask_sb, scale);
  a.out0 = dq;
  dim3 grid((sq + K::kDqBM - 1) / K::kDqBM, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_fp16
      ? K::launch(K::flash_bwd_dq_d256<__half>, grid, K::kDqThreads, K::kDqSmem, a, s)
      : K::launch(K::flash_bwd_dq_d256<__nv_bfloat16>, grid, K::kDqThreads, K::kDqSmem, a, s);
  return static_cast<int>(err);
}

// splits: blocks a key tile's query loop is split over (1: none); with
// splits > 1, ws holds splits * 2 * 128 * 128 floats per (key tile of 128
// rows, half of D), over heads and batch, and counters one zeroed int each.
extern "C" int dpt_flash_bwd_dkv_d256(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* di, const void* mask, void* dk, void* dv,
    int b, int h, int sq, int skv, int hd, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, long long mask_sb, float scale,
    int is_fp16, void* stream, int splits, void* ws, void* counters) {
  namespace K = dpt::d256;
  if (hd != K::kD ||
      !K::aligned({q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh}))
    return static_cast<int>(cudaErrorInvalidValue);
  if (splits < 1 || (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = bwd_args(q, k, v, dout, lse, di, mask, h, sq, skv, q_sb, q_ss, q_sh, k_sb, k_ss,
                    k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, mask_sb, scale);
  a.out0 = dk;
  a.out1 = dv;
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.splits = splits;
  const int q_tiles = (sq + K::kDkvBM - 1) / K::kDkvBM;
  a.tiles_per_split = (q_tiles + splits - 1) / splits;
  dim3 grid(2 * ((skv + K::kDkvBN - 1) / K::kDkvBN), h, b * splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_fp16
      ? K::launch(K::flash_bwd_dkv_d256<__half>, grid, K::kDkvThreads, K::kDkvSmem, a, s)
      : K::launch(K::flash_bwd_dkv_d256<__nv_bfloat16>, grid, K::kDkvThreads, K::kDkvSmem, a, s);
  return static_cast<int>(err);
}
