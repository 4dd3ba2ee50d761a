// Flash-attention backward, dQ part (K2), at head dim 256 for Hopper:
// mma.sync with cp.async tile copies.
//
// Replaces the Pallas TPU kernel diffusion_pipe_tpu/ops/flash_attention.py
// `_dq_kernel` / `_dq_kernel_nomask` (lines 217 and 258, pallas_call at 359),
// launched by `_flash_backward`, at D = 256 (AuraFlow's head dim; the TPU
// kernels take any D that is a multiple of 128). It computes what
// flash_bwd_dq.cu computes at D 64 and 128, with the same mask and
// all-masked-row conventions. K1 and K3 at D 256 are wgmma kernels:
// flash_fwd.cu's at FwdTile<256> and flash_bwd_dkv_d256.cu.
//
// What bounds it on the H100: the tensor cores. Per (b, h) it does 3
// products of 2*Sq*Skv*D flops against (2*Sq + 2*Skv)*D*2 bytes or so: at
// AuraFlow's shape (B 2, H 12, S 4,360) 0.71 ms at 989 TFLOP/s.
//
// Why not flash_bwd_dq.cu's tiles: its wgmma kernel holds a 64-row dQ
// accumulator of D columns per consumer warpgroup and stages 64-key K and V
// tiles in three stages; at D 256 that is 128 f32 a thread and more shared
// memory than a block may hold. So this is a first design that is right and
// simple: mma.sync m16n8k16 (f32 accumulators), one warp per 16 rows, tiles
// copied with cp.async into XOR-swizzled shared memory (16-byte chunk c of
// row r at c ^ (r & 7), so ldmatrix reads 8 rows without bank conflicts) in
// a ring of 2 stages.
//
// A block of 8 warps owns 128 query rows and steps over 32 keys; S = Q K^T
// and dP = dO V^T, P = exp(scale S - LSE), dS = P (dP - D) scale rounded to
// the input type, dQ += dS K. dQ is 128 f32 a thread. Shared memory: Q, dO
// 64 KB each + 2 x (K, V 16 KB each) = 192 KB.
//
// Masked keys, keys past Skv and query rows past Sq get P = 0 (a select,
// never a product with a value that may be infinite); rows past the ends
// are copied as zeros and never stored. A query row with no valid key gets
// a zero gradient.
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

// acc[NB x 8 columns] += A (16 x 32, from registers) times the 32 rows of a
// [k][n] tile
template <typename T, int NB>
__device__ __forceinline__ void frags_x_rows(float (&acc)[NB][4], const uint32_t (&a)[2][4],
                                             uint32_t tile, int lane) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int n = 0; n < NB; n += 2) {
      uint32_t bf[4];
      ldsm_x4_t(a_addr(tile, 16 * k, n, lane), bf);
      Mma<T>::run(acc[n], a[k], bf[0], bf[1]);
      Mma<T>::run(acc[n + 1], a[k], bf[2], bf[3]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *di;
  const int* mask;
  void* out0;  // dQ
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, mask_sb;
  int h, sq, skv;
  float scale;
};

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
    frags_x_rows<T, 32>(dq, dsa, s_k + s * kDqKV, lane);
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
  K::Args a = {};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.di = static_cast<const float*>(di);
  a.mask = static_cast<const int*>(mask);
  a.out0 = dq;
  a.q_sb = q_sb; a.q_ss = q_ss; a.q_sh = q_sh;
  a.k_sb = k_sb; a.k_ss = k_ss; a.k_sh = k_sh;
  a.v_sb = v_sb; a.v_ss = v_ss; a.v_sh = v_sh;
  a.do_sb = do_sb; a.do_ss = do_ss; a.do_sh = do_sh;
  a.mask_sb = mask_sb;
  a.h = h; a.sq = sq; a.skv = skv; a.scale = scale;
  dim3 grid((sq + K::kDqBM - 1) / K::kDqBM, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_fp16
      ? K::launch(K::flash_bwd_dq_d256<__half>, grid, K::kDqThreads, K::kDqSmem, a, s)
      : K::launch(K::flash_bwd_dq_d256<__nv_bfloat16>, grid, K::kDqThreads, K::kDqSmem, a, s);
  return static_cast<int>(err);
}
