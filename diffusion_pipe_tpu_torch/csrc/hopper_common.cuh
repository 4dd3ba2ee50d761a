// Hopper pieces of the flash-attention forward (K1), dQ (K2) and dK/dV (K3)
// kernels: TMA tile loads through 4-D tensor maps, mbarriers, wgmma
// descriptors and the fence/commit/wait wrappers, register hand-over between
// warpgroups and the once-per-device shared-memory attribute. Built for
// sm_90a only.
//
// Shared-memory tiles are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: rows of 64 16-bit elements (128 bytes), the 16-byte chunk c of row
// r stored at chunk c ^ (r % 8), tiles 1024-byte aligned. A tile with D = 128
// or 256 columns is two or four such 64-column boxes, one after the other.
// wgmma reads them with 128-byte-swizzle descriptors:
// - K-major (the reduction index runs along the 128-byte rows: Q and K in
//   S = Q K^T, dO and V in dP = dO V^T): 8-row groups 1024 bytes apart
//   (SBO); a k-step of 16 elements moves the start address by 32 bytes
//   inside a box;
// - MN-major (the output column runs along the rows: V in O = P V, K in
//   dQ = dS K, dO and Q in dV = P^T dO and dK = dS^T Q): 8-row groups along
//   k 1024 bytes apart (SBO), 64-column boxes one box apart (LBO); a
//   k-step of 16 rows moves the start by 2048 bytes. No tile is ever stored
//   transposed.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace dpt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarrier ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Arrives and adds `bytes` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Returns once the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 passes at once. A wait of more than
// about 2^35 cycles (some 20 s) traps: a fault in a pipeline then ends the
// kernel with an error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > (1ll << 35)) __trap();
  }
}

// --- TMA ----------------------------------------------------------------------

// Copies the box at (c0, c1, c2, c3) of the tensor map into shared memory at
// dst; the bytes complete a transaction on `bar`. Parts of the box outside
// the tensor are filled with zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// --- warpgroups -----------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Barrier `id` (1-15; 0 is __syncthreads) over `count` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x in one MUFU instruction (denormal results flush to 0; -inf gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- wgmma -------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's ordinary shared-memory writes visible to the async
// proxy, so that a wgmma issued after a barrier reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma uses across the fence/commit/wait that guard it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
  }
}

// Shared-memory matrix descriptor with 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo_bytes,
                                              uint32_t sbo_bytes) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// K-major operand: rows of the tile are M (or N), the 128-byte rows run
// along K. `addr` is the tile half holding this k-step, plus 32 bytes a
// k-step inside it.
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}

// MN-major operand: rows of the tile are K, the 128-byte rows run along N;
// `half_bytes` apart are its 64-column boxes (N 64-127, 128-191, ...).
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t half_bytes) {
  return make_desc(addr, half_bytes, 1024);
}

// d[64 x N] (+)= A[64 x 16] * B[16 x N], both from shared memory, K-major.
// The accumulator layout: thread t of the warpgroup holds row
// 16 * (t / 32) + (t % 32) / 4 (+8) and columns 8 i + 2 (t % 4) (+1):
// d[4 i + {0, 1}] on the first row, d[4 i + {2, 3}] on the second.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                                         int scale_d);

// d[64 x N] += A[64 x 16] * B[16 x N], A from registers in the layout of
// mma.m16n8k16's A fragment (a warp's 16 rows), B from shared memory
// MN-major.
template <typename T, int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db);

// d[64 x N] += A[64 x 16] * B[16 x N], both from shared memory, A K-major
// and B MN-major.
template <typename T, int N>
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[N / 2], uint64_t da, uint64_t db);

// The instances below, for bf16 and fp16, come from one macro per (N, kind)
// whose parameters are the element type and its PTX name: SS at N 32, 48,
// 64 and 128, SS with an MN-major B at N 128, RS at N 64, 128 and 256.
// Operands: the accumulator d[0 .. N/2) is %0 .. %(N/2 - 1); for SS the A
// and B descriptors follow and then the scale-d flag (a 1, accumulate, for
// the MN-major SS); for RS the four registers of the A fragment, the B
// descriptor and a 1. After the predicate come scale-a and scale-b (1) and
// the transpose bits: 0, 0 for K-major A and B in SS, 0, 1 for the
// MN-major SS, 1 for MN-major B in RS.
#define DPT_ACC32_REGS                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DPT_ACC64_REGS                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, " \
  "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "  \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "  \
  "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "  \
  "%62, %63}"
#define DPT_ACC32_OPS \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define DPT_ACC64_OPS DPT_ACC32_OPS, \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define DPT_ACC16_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15}"
#define DPT_ACC128_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"
#define DPT_ACC16_OPS "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
#define DPT_ACC24_REGS \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23}"
#define DPT_ACC24_OPS DPT_ACC16_OPS, \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
#define DPT_ACC128_OPS DPT_ACC64_OPS, \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define DPT_WGMMA_SS_64(T, PTX)                                                       \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_ss<T, 64>(float (&d)[32], uint64_t da,        \
                                                  uint64_t db, int scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " "        \
                 DPT_ACC32_REGS ", %32, %33, p, 1, 1, 0, 0;\n}\n"                      \
                 : DPT_ACC32_OPS                                                      \
                 : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define DPT_WGMMA_RS_64(T, PTX)                                                       \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_rs<T, 64>(float (&d)[32], const uint32_t (&a)[4], \
                                                  uint64_t db) {                      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." PTX "." PTX " "        \
                 DPT_ACC32_REGS ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"        \
                 : DPT_ACC32_OPS                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
  }

#define DPT_WGMMA_SS_128(T, PTX)                                                      \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_ss<T, 128>(float (&d)[64], uint64_t da,       \
                                                   uint64_t db, int scale_d) {        \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "       \
                 DPT_ACC64_REGS ", %64, %65, p, 1, 1, 0, 0;\n}\n"                      \
                 : DPT_ACC64_OPS                                                      \
                 : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define DPT_WGMMA_RS_128(T, PTX)                                                      \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_rs<T, 128>(float (&d)[64], const uint32_t (&a)[4], \
                                                   uint64_t db) {                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "       \
                 DPT_ACC64_REGS ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"        \
                 : DPT_ACC64_OPS                                                      \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
  }

#define DPT_WGMMA_SS_32(T, PTX)                                                       \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_ss<T, 32>(float (&d)[16], uint64_t da,        \
                                                  uint64_t db, int scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." PTX "." PTX " "        \
                 DPT_ACC16_REGS ", %16, %17, p, 1, 1, 0, 0;\n}\n"                      \
                 : DPT_ACC16_OPS                                                      \
                 : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define DPT_WGMMA_SS_48(T, PTX)                                                       \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_ss<T, 48>(float (&d)[24], uint64_t da,        \
                                                  uint64_t db, int scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32." PTX "." PTX " "        \
                 DPT_ACC24_REGS ", %24, %25, p, 1, 1, 0, 0;\n}\n"                      \
                 : DPT_ACC24_OPS                                                      \
                 : "l"(da), "l"(db), "r"(scale_d));                                   \
  }

#define DPT_WGMMA_SS_MN_128(T, PTX)                                                   \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_ss_mn<T, 128>(float (&d)[64], uint64_t da,    \
                                                      uint64_t db) {                  \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                         \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." PTX "." PTX " "       \
                 DPT_ACC64_REGS ", %64, %65, p, 1, 1, 0, 1;\n}\n"                      \
                 : DPT_ACC64_OPS                                                      \
                 : "l"(da), "l"(db), "r"(1));                                         \
  }

#define DPT_WGMMA_RS_256(T, PTX)                                                      \
  template <>                                                                         \
  __device__ __forceinline__ void wgmma_rs<T, 256>(float (&d)[128], const uint32_t (&a)[4], \
                                                   uint64_t db) {                     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                        \
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32." PTX "." PTX " "       \
                 DPT_ACC128_REGS ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"  \
                 : DPT_ACC128_OPS                                                     \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));      \
  }

DPT_WGMMA_SS_64(__nv_bfloat16, "bf16")
DPT_WGMMA_RS_64(__nv_bfloat16, "bf16")
DPT_WGMMA_SS_128(__nv_bfloat16, "bf16")
DPT_WGMMA_RS_128(__nv_bfloat16, "bf16")
DPT_WGMMA_SS_64(__half, "f16")
DPT_WGMMA_RS_64(__half, "f16")
DPT_WGMMA_SS_128(__half, "f16")
DPT_WGMMA_RS_128(__half, "f16")
DPT_WGMMA_SS_32(__nv_bfloat16, "bf16")
DPT_WGMMA_SS_32(__half, "f16")
DPT_WGMMA_SS_48(__nv_bfloat16, "bf16")
DPT_WGMMA_SS_48(__half, "f16")
DPT_WGMMA_SS_MN_128(__nv_bfloat16, "bf16")
DPT_WGMMA_SS_MN_128(__half, "f16")
DPT_WGMMA_RS_256(__nv_bfloat16, "bf16")
DPT_WGMMA_RS_256(__half, "f16")

#undef DPT_WGMMA_SS_64
#undef DPT_WGMMA_RS_64
#undef DPT_WGMMA_SS_128
#undef DPT_WGMMA_RS_128
#undef DPT_WGMMA_SS_32
#undef DPT_WGMMA_SS_48
#undef DPT_WGMMA_SS_MN_128
#undef DPT_WGMMA_RS_256
#undef DPT_ACC16_REGS
#undef DPT_ACC128_REGS
#undef DPT_ACC16_OPS
#undef DPT_ACC24_REGS
#undef DPT_ACC24_OPS
#undef DPT_ACC128_OPS
#undef DPT_ACC32_REGS
#undef DPT_ACC64_REGS
#undef DPT_ACC32_OPS
#undef DPT_ACC64_OPS

// --- host side -------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver, found through the runtime so the
// library needs no link against libcuda.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiledFn>(p);
    }
  }
  return fn;
}

// A tensor map over a [B, S, H, D] tensor (D contiguous, other strides in
// elements) as the 4-D (D, H, S, B), with a box of 64 x 1 x rows x 1 and
// 128-byte swizzle. Rows past S read as zeros.
inline cudaError_t make_bshd_map(CUtensorMap* map, const void* base, bool fp16, int b,
                                 int s, int h, int d, long long sb, long long ss,
                                 long long sh, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const uint64_t esz = 2;
  cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s, (cuuint64_t)b};
  // a dimension of size 1 is never stepped over; give it a stride TMA takes
  cuuint64_t strides[3] = {(cuuint64_t)sh * esz, (cuuint64_t)ss * esz,
                           (cuuint64_t)sb * esz};
  if (h == 1) strides[0] = (cuuint64_t)d * esz;
  if (s == 1) strides[1] = strides[0];
  if (b == 1) strides[2] = strides[1];
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  CUresult r = fn(map, fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  4, const_cast<void*>(base), dims, strides, box, estr,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Sets a kernel's dynamic shared-memory limit once per device.
template <typename Kernel>
inline cudaError_t set_smem_once(Kernel kernel, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev >= 0 && dev < 64) done[dev] = true;
  return err;
}

}  // namespace hopper
}  // namespace dpt
