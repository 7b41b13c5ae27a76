// Building blocks shared by the port's Hopper kernels (sm_90a): 16-byte
// cp.async copies, ldmatrix, the bf16 mma.sync m16n8k16 tile product, the
// passes that cast f32 rows and weights to padded bf16 operands, and the
// pieces of the warp-specialised kernels: mbarriers, bulk copies, wgmma
// with its swizzled shared-memory images, the stage ring of two producer
// warpgroups and two consumer warpgroups, the casts that write those
// images, and the window conv of sorted rows that the k3 conv and the
// window probe share (one kernel template on where the windows come from).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// internal linkage: each source builds into a library of its own
namespace {

// 16 bytes from global to shared memory; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

// the same, to a shared-memory address already in the shared window
__device__ __forceinline__ void cp_async16_s(uint32_t dst, const void* src,
                                             int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// xb[r, c] = bf16(x[r, c]) for c < cin, 0 for cin <= c < cinp (cinp a
// multiple of 8): each thread casts 8 channels of one row and stores them
// as one 16-byte piece
__global__ void cast_rows_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ xb, int64_t n,
                                 int cin, int cinp) {
  const int per_row = cinp / 8;
  const int64_t total = n * per_row;
  // rows 32-byte aligned: two float4 loads
  const bool vec = cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / per_row;
    const int c0 = static_cast<int>(e - r * per_row) * 8;
    const float* src = x + r * cin + c0;
    float v[8];
    if (vec && c0 < cin) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = c0 + i < cin ? src[i] : 0.f;
    }
    uint4 out;
    uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      o[i] = *reinterpret_cast<const uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(xb + r * cinp + c0) = out;
  }
}

// wt[j, o, c] = bf16(w[j, c, o]) for c < cin, 0 for cin <= c < cinp
__global__ void cast_weights_kernel(const float* __restrict__ w,
                                    __nv_bfloat16* __restrict__ wt, int k,
                                    int cin, int cinp, int cout) {
  const int64_t total = (int64_t)k * cout * cinp;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t jo = e / cinp;
    const int c = static_cast<int>(e - jo * cinp);
    const int64_t j = jo / cout;
    const int o = static_cast<int>(jo - j * cout);
    wt[e] = __float2bfloat16_rn(c < cin ? w[(j * cin + c) * cout + o] : 0.f);
  }
}

// blocks of 256 threads for a grid-stride pass over `total` elements
inline int grid_for(int64_t total) {
  const int64_t blocks = (total + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}


// ---------------------------------------------------------------------------
// Hopper pieces of the warp-specialised kernels: mbarriers, bulk copies,
// wgmma and its shared-memory images
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// the barriers' initialisation, visible to the bulk copies (the async proxy)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrive, and expect `bytes` more from bulk copies in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// generic-proxy writes (cp.async, st.shared) made visible to wgmma and bulk
// copies (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Descriptor of a wgmma operand in shared memory with the 128-byte swizzle:
// 8-row groups of 128-byte rows (the 16-byte piece q of row r at
// q ^ (r & 7)), the tile 1024-byte aligned. K-major: rows are M (or N),
// `sbo` = 1024 steps 8 rows, and a k16 step adds 32 bytes to the start.
// MN-major: rows are K, `sbo` = 1024 steps 8 K rows, `lbo` steps 64 M (or
// N) columns, and a k16 step adds 2048 bytes.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16)
         | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// byte offset of the 16-byte piece q of row r in a swizzled tile
__device__ __forceinline__ uint32_t swz(int r, int q) {
  return static_cast<uint32_t>(r * 128 + ((q ^ (r & 7)) << 4));
}

// D[64 x N] += A[64 x 16] B[16 x N], bf16 in, f32 accumulators in registers
// (thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 + {0, 8}
// and columns 8 i + 2 (t % 4) + {0, 1} as d[4 i + {0, 1}], d[4 i + {2, 3}]);
// TA / TB: 0 = K-major, 1 = MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n96k16(float (&d)[48], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, %51, %52;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t da,
                                           uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128, "wgmma width");
  if constexpr (N == 32) wgmma_m64n32k16<TA, TB>(d, da, db);
  if constexpr (N == 64) wgmma_m64n64k16<TA, TB>(d, da, db);
  if constexpr (N == 96) wgmma_m64n96k16<TA, TB>(d, da, db);
  if constexpr (N == 128) wgmma_m64n128k16<TA, TB>(d, da, db);
}

// The same product with A from registers (each warp's 16 rows of the m64
// tile in the mma.sync m16n8k16 A-fragment layout, as ldmatrix loads them).
template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n96k16(float (&d)[48], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int N, int TB>
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[N / 2], const uint32_t (&a)[4],
                                              uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 96 || N == 128, "wgmma width");
  if constexpr (N == 32) wgmma_rs_m64n32k16<TB>(d, a, db);
  if constexpr (N == 64) wgmma_rs_m64n64k16<TB>(d, a, db);
  if constexpr (N == 96) wgmma_rs_m64n96k16<TB>(d, a, db);
  if constexpr (N == 128) wgmma_rs_m64n128k16<TB>(d, a, db);
}

constexpr int SMEM_MAX = 232448;  // shared memory one block may use (227 KB)

// the 1024-byte aligned start of dynamic shared memory (the swizzled tiles
// need it)
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// stores one accumulator tile of a consumer warpgroup: rows r0 + the
// layout's row, columns col0 + the layout's column, where the row is below
// `rows` and the column below `cols`; `out` rows have stride `ld`
template <int N>
__device__ __forceinline__ void store_tile(const float (&d)[N / 2], float* out,
                                           int64_t ld, int r0, int rows,
                                           int col0, int cols, int wtid) {
  const int warp = wtid >> 5;
  const int lane = wtid & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + warp * 16 + (lane >> 2) + h * 8;
    if (r >= rows) continue;
    float* row = out + r * ld;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int col = col0 + i * 8 + (lane & 3) * 2;
      const float v0 = d[4 * i + 2 * h];
      const float v1 = d[4 * i + 2 * h + 1];
      if ((ld & 1) == 0 && col + 1 < cols) {
        *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
      } else {
        if (col < cols) row[col] = v0;
        if (col + 1 < cols) row[col + 1] = v1;
      }
    }
  }
}

// The ring of stages of the warp-specialised kernels. Stage slot s has a
// `full` barrier (every producer thread's gathers, which arrive on it when
// they land, plus the shared operand's bytes) and an `empty` barrier (each
// consumer warpgroup).
constexpr int RING = 4;          // stages
constexpr int PRODUCERS = 256;   // two producer warpgroups
constexpr int CONSUMERS = 2;     // consumer warpgroups

struct Ring {
  uint64_t* full;
  uint64_t* empty;
  __device__ static int slot(int it) { return it % RING; }
  __device__ static uint32_t parity(int it) { return (it / RING) & 1; }
};

// One thread initialises the ring.
__device__ __forceinline__ void ring_init(const Ring& ring) {
  for (int s = 0; s < RING; ++s) {
    mbar_init(&ring.full[s], PRODUCERS + 1);
    mbar_init(&ring.empty[s], CONSUMERS);
  }
  fence_barrier_init();
}

// the barrier receives one arrival once all of this thread's earlier
// cp.async copies have landed (counted in the barrier's init count)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// The producer warpgroups' loop (ptid = their thread 0..255). For each stage:
// wait until every consumer released the slot; thread 0 posts the shared
// operand's bytes and issues `shared(it, slot)` (its bulk copy); every thread
// issues its gathers, `gather(it, slot)`, which end with the thread's one
// arrival on the slot's full barrier, made when its copies land
// (cp_async_arrive, or the bytes of its bulk copies posted). The producer
// never waits for its own copies: every slot the consumers do not hold is
// in flight.
template <class Shared, class Gather>
__device__ __forceinline__ void ring_produce(const Ring& ring, int iters,
                                             int ptid, uint32_t shared_bytes,
                                             Shared shared, Gather gather) {
  for (int it = 0; it < iters; ++it) {
    const int s = Ring::slot(it);
    mbar_wait(&ring.empty[s], Ring::parity(it) ^ 1);
    if (ptid == 0) {
      mbar_expect_tx(&ring.full[s], shared_bytes);
      shared(it, s);
    }
    gather(it, s);
  }
}

// A consumer warpgroup waits for stage `it`; the gathered rows were written
// through the generic proxy (cp.async), so each thread fences them for
// wgmma's reads (the async proxy) before the products.
__device__ __forceinline__ void ring_wait(const Ring& ring, int it) {
  mbar_wait(&ring.full[Ring::slot(it)], Ring::parity(it));
  fence_proxy_async();
}

// A consumer warpgroup (wtid = its thread 0..127) gives slot s back to the
// producers.
__device__ __forceinline__ void ring_release(const Ring& ring, int s, int wtid) {
  if (wtid == 0) mbar_arrive(&ring.empty[s]);
}

// The B operand of the k3 kernel as the shared-memory image that wgmma
// reads, one contiguous run of bn x 128 bytes per (column tile, stage):
// stage st = j * nsl + slice holds w[j][64 slice .. + 64][the tile's bn
// columns] transposed to [bn][64] (K-major), each 128-byte row swizzled,
// zero past cin and cout. With `flip`, w is a forward's [k][cout][cin]
// weights and the image is that of flip(w, 0).transpose(1, 2), the
// weights of its dX conv.
__global__ void cast_weight_image_kernel(const float* __restrict__ w,
                                         __nv_bfloat16* __restrict__ img,
                                         int k, int cin, int cout, int bn,
                                         int nsl, int ntiles, int flip) {
  const int64_t total = (int64_t)ntiles * k * nsl * bn * 8;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int q = static_cast<int>(e & 7);
    int64_t rest = e >> 3;
    const int row = static_cast<int>(rest % bn);
    rest /= bn;
    const int st = static_cast<int>(rest % (k * nsl));
    const int tile = static_cast<int>(rest / (k * nsl));
    const int j = st / nsl;
    const int o = tile * bn + row;
    const int c0 = (st - j * nsl) * 64 + q * 8;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = c0 + i;
      v[i] = o >= cout || c >= cin ? 0.f
             : flip ? w[((int64_t)(k - 1 - j) * cout + o) * cin + c]
                    : w[((int64_t)j * cin + c) * cout + o];
    }
    uint4 out;
    uint32_t* p = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      p[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(img + ((int64_t)(tile * k * nsl + st) * bn + row) * 64
                              + ((q ^ (row & 7)) * 8)) = out;
  }
}

// Rows of g [n][cout] as the shared-memory image of wgmma's MN-major
// operand: for each block b of 64 rows and each 64-column atom a,
// [64 rows][128 bytes] with each row's 16-byte pieces swizzled. Column
// tiles of `bn` columns take `natoms` atoms each; columns past the tile or
// cout and rows past n are 0.
__global__ void cast_row_image_kernel(const float* __restrict__ g,
                                      __nv_bfloat16* __restrict__ img,
                                      int64_t n, int cout, int bn, int natoms,
                                      int ntiles) {
  const int atoms = natoms * ntiles;
  const int64_t total = (n + 63) / 64 * atoms * 512;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int q = static_cast<int>(e & 7);
    const int m = static_cast<int>((e >> 3) & 63);
    const int a = static_cast<int>((e >> 9) % atoms);
    const int64_t b = (e >> 9) / atoms;
    const int within = (a % natoms) * 64 + q * 8;  // column inside the tile
    const int col = (a / natoms) * bn + within;
    const int64_t row = b * 64 + m;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = row < n && col + i < cout && within + i < bn
                 ? g[row * cout + col + i] : 0.f;
    }
    uint4 out;
    uint32_t* p = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      p[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(img + ((b * atoms + a) * 64 + m) * 64
                              + ((q ^ (m & 7)) * 8)) = out;
  }
}


// ---------------------------------------------------------------------------
// The window conv of sorted rows, shared by the k3 conv (banded_conv.cu),
// which finds each CTA's windows from its neighbour indices, and the window
// probe (banded_window.cu), which reads them from a host plan:
//
//   y[i, :] = sum_j bf16(x[nbr[i, j], :]) @ bf16(w[j]) over the neighbours
//             inside their window, f32 accumulation
//
// A CTA owns 256 output rows (128 per consumer warpgroup, two m64 tiles) and
// BN <= 128 output columns (blockIdx.y tiles wider outputs). Offsets come
// in groups whose neighbours of sorted rows lie in one band of rows (the 9
// offsets of one dx). For each group and 64-channel slice, the window
// producers copy the group's window of rows into a window slot once (16-byte
// cp.async, a zero row after it), and each of the group's offsets reads its
// A fragments from it by row address (ldmatrix; a neighbour that is absent,
// or outside its window, reads the zero row) and runs wgmma with A from
// registers against the offset's weight slice (one ring stage per offset and
// slice, kept full by one producer thread by bulk copy).
// ---------------------------------------------------------------------------

constexpr int THREADS = CONSUMERS * 128 + PRODUCERS;  // consumer warpgroups, then the producers
constexpr int PRODUCER_REGS = 56;   // setmaxnreg: 256 x 56 + 256 x 200 = 65,536
constexpr int CONSUMER_REGS = 200;
constexpr int BM = 256;                      // window conv: output rows per CTA
constexpr int LDW = 144;                     // window row stride: 64 channels + 16 B (conflict-free ldmatrix)
constexpr int WIN_SLOTS = 2;                 // window slots, at most
constexpr int WPRODUCERS = PRODUCERS - 32;   // window producers: all producer warps but the weights' one
constexpr int PLAN_DESC = 10;                // ints per group of a CTA's planned windows

// ints of shared memory that describe a CTA's planned windows: PLAN_DESC
// per cluster, then the plan's order [k] and bounds [ncl + 1]
inline int plan_desc_ints(int k, int ncl) { return PLAN_DESC * ncl + k + ncl + 1; }

// Launches `kern` over `grid` with `smem` bytes of dynamic shared memory.
template <class Kern, class... Args>
int launch(Kern kern, dim3 grid, size_t smem, cudaStream_t stream, Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The neighbour indices of the CTA's rows row0 .. row0 + 256 into shared
// memory (-1 past n): 16-byte copies where the rows are whole and both ends
// aligned, else one index per thread and step.
__device__ __forceinline__ void stage_indices(int32_t* idx_s, const int32_t* nbr,
                                              int row0, int n, int k, int tid) {
  const int64_t base = (int64_t)row0 * k;
  const int32_t* src = nbr + base;
  if (row0 + BM <= n
      && ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(idx_s)) & 15) == 0) {
#pragma unroll 4
    for (int e = tid; e < BM * k / 4; e += THREADS) {
      reinterpret_cast<int4*>(idx_s)[e] = reinterpret_cast<const int4*>(src)[e];
    }
  } else {
    const int64_t total = (int64_t)n * k;
    for (int e = tid; e < BM * k; e += THREADS) idx_s[e] = base + e < total ? src[e] : -1;
  }
}

// output columns per CTA of the conv: the narrowest wgmma width that holds
// cout, at most 128 (ops/banded_conv.py::conv_tile_n)
inline int conv_tile_n(int cout) {
  return cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 96 ? 96 : 128;
}

// f(std::integral_constant<int, conv_tile_n(cout)>{})
template <class F>
int with_tile_n(int cout, F f) {
  switch (conv_tile_n(cout)) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 96: return f(std::integral_constant<int, 96>{});
    default: return f(std::integral_constant<int, 128>{});
  }
}

// The window probe's host plan: per 128-row block and cluster (group) of
// offsets, the window rows [start, start + length)
struct PlanWindows {
  const int32_t* start;   // [nb][ncl]
  const int32_t* length;  // [nb][ncl]
  const int32_t* order;   // [k] offsets grouped by cluster
  const int32_t* bounds;  // [ncl + 1] cluster c is order[bounds[c] : bounds[c + 1]]
  int nb;
  int ncl;
};

// bytes of dynamic shared memory of the window conv besides its windows:
// alignment slack, the weight ring, the barriers, the staged indices (with
// `idx`) and `desc` ints describing the CTA's windows
size_t win_fixed_smem(int bn, int k, bool idx, int desc) {
  return 1024 + (size_t)RING * bn * 128
         + (2 * RING + 2 * WIN_SLOTS) * sizeof(uint64_t) + (size_t)desc * sizeof(int32_t)
         + (idx ? (size_t)BM * k * sizeof(int32_t) : 0);
}

// rows each of `slots` window slots holds (a zero row follows them) in what
// is left
int win_rows(int bn, int k, bool idx, int desc, int slots) {
  const long left = (long)SMEM_MAX - (long)win_fixed_smem(bn, k, idx, desc);
  return static_cast<int>(left / (slots * LDW)) - 1;
}

// y[row0 .. row0 + 256, tile's BN columns], windows of `nslots` slots of
// wmax + 1 rows.
//  * PLAN = false (the k3 conv): groups of kg consecutive offsets; the CTA
//    finds each group's window [lo, hi] of its present neighbours from its
//    indices. A group whose window exceeds wmax rows falls back, in this
//    CTA, to one window per offset holding its 256 gathered rows.
//  * PLAN = true (the window probe): the plan's clusters; consumer
//    warpgroup wg masks by the window of plan block 2 blockIdx.x + wg. A
//    cluster's slot holds the union of the two blocks' windows, or, where
//    that is longer, the two windows one after the other (at most 2 x the
//    longest window rows). A cluster with no window takes no stage; a
//    warpgroup whose block has none reads the zero row (a branch that
//    skipped its products was slower at the eval shapes).
template <int BN, bool PLAN>
__global__ void __launch_bounds__(THREADS, 1)
window_conv_kernel(const __nv_bfloat16* __restrict__ xb,
                   const int32_t* __restrict__ nbr,
                   const __nv_bfloat16* __restrict__ wimg,
                   float* __restrict__ y, int n, int k, int cinp, int cout,
                   int nsl, int kg, int wmax, int nslots, int idx_smem,
                   PlanWindows plan) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int wrows = wmax + 1;
  const int ngroups = PLAN ? plan.ncl : k / kg;
  unsigned char* b_s = aligned_smem(smem_raw);            // [RING][BN rows][128 B]
  unsigned char* win_s = b_s + RING * BN * 128;           // [nslots][wmax + 1 rows][144 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(win_s + nslots * wrows * LDW);
  const Ring ring{bars, bars + RING};
  uint64_t* wfull = bars + 2 * RING;
  uint64_t* wempty = wfull + WIN_SLOTS;
  int32_t* idx_s = reinterpret_cast<int32_t*>(wempty + WIN_SLOTS);  // [256][k]
  // the windows: lo [k], hi [k] found here; or [ngroups][PLAN_DESC]
  // planned, then the plan's order [k] and bounds [ngroups + 1]
  int32_t* lo_s = idx_s + (idx_smem ? BM * k : 0);
  int32_t* hi_s = lo_s + k;
  int32_t* desc_s = lo_s;
  int32_t* ord_s = desc_s + ngroups * PLAN_DESC;
  int32_t* bnd_s = ord_s + k;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int tile = blockIdx.y;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&ring.full[s], 1);
      mbar_init(&ring.empty[s], CONSUMERS);
    }
    for (int s = 0; s < nslots; ++s) {
      mbar_init(&wfull[s], WPRODUCERS);
      mbar_init(&wempty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  if constexpr (PLAN) {
    for (int e = tid; e < k + ngroups + 1; e += THREADS) {
      ord_s[e] = e < k ? plan.order[e] : plan.bounds[e - k];
    }
    // each cluster's window rows: run 1 [src1, src1 + len1), then run 2
    // from src2, `total` rows in all; each block's window (s, l) and the
    // slot row of its first row (base)
    for (int c = tid; c < ngroups; c += THREADS) {
      const int b0 = 2 * blockIdx.x;
      const int sa = plan.start[b0 * ngroups + c];
      const int la = plan.length[b0 * ngroups + c];
      const bool second = b0 + 1 < plan.nb;
      const int sb = second ? plan.start[(b0 + 1) * ngroups + c] : 0;
      const int lb = second ? plan.length[(b0 + 1) * ngroups + c] : 0;
      int src1 = sa, len1 = la, src2 = sb, total = la + lb, base_a = 0, base_b = la;
      if (la == 0) {
        src1 = sb;
        len1 = lb;
        base_b = 0;
      } else if (lb > 0) {
        const int lo = min(sa, sb);
        const int hi = max(sa + la, sb + lb);
        if (hi - lo <= la + lb) {  // overlapping or adjacent: one run
          src1 = lo;
          len1 = total = hi - lo;
          base_a = sa - lo;
          base_b = sb - lo;
        }
      }
      int32_t* d = desc_s + c * PLAN_DESC;
      d[0] = src1;
      d[1] = len1;
      d[2] = src2;
      d[3] = total;
      d[4] = sa;
      d[5] = la;
      d[6] = base_a;
      d[7] = sb;
      d[8] = lb;
      d[9] = base_b;
    }
  } else {
    for (int c = tid; c < ngroups; c += THREADS) {
      lo_s[c] = 0x7fffffff;
      hi_s[c] = -1;
    }
  }
  for (int e = tid; e < nslots * (LDW / 16); e += THREADS) {  // the zero rows
    const int slot = e / (LDW / 16);
    *reinterpret_cast<uint4*>(win_s + ((int64_t)slot * wrows + wmax) * LDW
                              + (e - slot * (LDW / 16)) * 16) = make_uint4(0, 0, 0, 0);
  }
  const int32_t* idx = nbr + (int64_t)row0 * k;
  if (idx_smem) {
    stage_indices(idx_s, nbr, row0, n, k, tid);
    idx = idx_s;
  }
  __syncthreads();
  if constexpr (!PLAN) {
    // each group's window: the least and greatest present neighbour
    if (tid < BM) {
      const bool live = row0 + tid < n;
      for (int c = 0; c < ngroups; ++c) {
        int lo = 0x7fffffff, hi = -1;
        for (int jj = 0; live && jj < kg; ++jj) {
          const int v = idx[tid * k + c * kg + jj];
          if (v >= 0) {
            lo = min(lo, v);
            hi = max(hi, v);
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
          hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
        }
        if ((tid & 31) == 0) {
          atomicMin(&lo_s[c], lo);
          atomicMax(&hi_s[c], hi);
        }
      }
    }
    __syncthreads();  // windows ready
  }

  // group c: its offsets goff(gbase(c), jj) for jj < glen(c), whether it
  // takes stages, whether its window fits
  auto gbase = [&](int c) {
    if constexpr (PLAN) return bnd_s[c];
    else return c * kg;
  };
  auto glen = [&](int c) {
    if constexpr (PLAN) return bnd_s[c + 1] - bnd_s[c];
    else return kg;
  };
  auto goff = [&](int base, int jj) {
    if constexpr (PLAN) return ord_s[base + jj];
    else return base + jj;
  };
  auto live = [&](int c) {
    if constexpr (PLAN) return desc_s[c * PLAN_DESC + 3] > 0;
    else return true;
  };
  // a group's window fits (an empty one: hi - lo + 1 < 0)
  auto banded = [&](int c) {
    if constexpr (PLAN) return true;
    else return hi_s[c] - lo_s[c] + 1 <= wmax;
  };

  if (tid >= CONSUMERS * 128) {
    regs_dec<PRODUCER_REGS>();
    const int ptid = tid - CONSUMERS * 128;
    if (ptid == 0) {
      // the weights: one stage per (offset, slice) in the consumers' order
      const unsigned char* wsrc = reinterpret_cast<const unsigned char*>(
          wimg + (int64_t)tile * k * nsl * BN * 64);
      int it = 0;
      for (int c = 0; c < ngroups; ++c) {
        if (!live(c)) continue;
        const int gb = gbase(c);
        const int gl = glen(c);
        for (int sl = 0; sl < nsl; ++sl) {
          for (int jj = 0; jj < gl; ++jj, ++it) {
            const int s = Ring::slot(it);
            const int st = goff(gb, jj) * nsl + sl;
            mbar_wait(&ring.empty[s], Ring::parity(it) ^ 1);
            mbar_expect_tx(&ring.full[s], BN * 128);
            bulk_copy(b_s + s * BN * 128, wsrc + (int64_t)st * BN * 128, BN * 128,
                      &ring.full[s]);
          }
        }
      }
    } else if (ptid >= 32) {
      // the windows, 16 bytes per cp.async, in the consumers' order
      const int wp = ptid - 32;
      int wi = 0;
      auto fill = [&](auto copy) {
        const int slot = wi % nslots;
        mbar_wait(&wempty[slot], ((wi / nslots) & 1) ^ 1);
        copy(win_s + (int64_t)slot * wrows * LDW);
        cp_async_arrive(&wfull[slot]);
        ++wi;
      };
      for (int c = 0; c < ngroups; ++c) {
        if (!live(c)) continue;
        const bool band = banded(c);
        // the window's rows: run 1 [src1, src1 + len1), then run 2 from src2
        int src1, len1, src2, total;
        if constexpr (PLAN) {
          const int32_t* d = desc_s + c * PLAN_DESC;
          src1 = d[0];
          len1 = d[1];
          src2 = d[2];
          total = d[3];
        } else {
          src1 = lo_s[c];
          len1 = total = band ? max(hi_s[c] - src1 + 1, 0) : 0;
          src2 = 0;
        }
        for (int sl = 0; sl < nsl; ++sl) {
          const int c0 = sl * 64;
          const int pieces = min(64, cinp - c0) / 8;
          if (band) {
            fill([&](unsigned char* win) {
              for (int e = wp; e < total * pieces; e += WPRODUCERS) {
                const int r = e / pieces;
                const int q = e - r * pieces;
                const int src = r < len1 ? src1 + r : src2 + (r - len1);
                cp_async16(win + r * LDW + q * 16,
                           xb + (int64_t)src * cinp + c0 + q * 8, 16);
              }
            });
          } else {
            for (int jj = 0; jj < kg; ++jj) {
              const int j = c * kg + jj;
              fill([&](unsigned char* win) {
                for (int e = wp; e < BM * pieces; e += WPRODUCERS) {
                  const int r = e / pieces;
                  const int q = e - r * pieces;
                  const int v = row0 + r < n ? idx[r * k + j] : -1;
                  cp_async16(win + r * LDW + q * 16,
                             xb + (int64_t)max(v, 0) * cinp + c0 + q * 8, v >= 0 ? 16 : 0);
                }
              });
            }
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows row0 + 128 wg .. + 128 (two m64
    // tiles); this lane addresses rows rr and rr + 64 of the CTA for ldmatrix
    regs_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int wtid = tid & 127;
    const int lane = wtid & 31;
    const int rr = wg * 128 + (wtid >> 5) * 16 + (lane & 15);
    float acc[2][BN / 2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
    }
    int it = 0;
    // offset j's products for slice sl from window `win`: a neighbour v in
    // [ws, ws + wl) reads slot row base + v - ws (band), or the CTA's
    // gathered rows (!band)
    auto compute = [&](int j, int sl, const unsigned char* win, int ws, int wl,
                       int base, bool band) {
      const int s = Ring::slot(it);
      const int ksteps = min(64, cinp - sl * 64) / 16;
      const unsigned char* arow[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = rr + mt * 64;
        int wr = r;
        if (band) {
          const int v = row0 + r < n ? idx[r * k + j] : -1;
          wr = v >= 0 && static_cast<unsigned>(v - ws) < static_cast<unsigned>(wl)
                   ? base + v - ws : wmax;
        }
        arow[mt] = win + wr * LDW + (lane >> 4) * 16;
      }
      uint32_t af[4][2][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks < ksteps) {
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) ldmatrix_x4(af[ks][mt], arow[mt] + ks * 32);
        }
      }
      mbar_wait(&ring.full[s], Ring::parity(it));
      const unsigned char* bs = b_s + s * BN * 128;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks < ksteps) {
          const uint64_t db = smem_desc(bs + ks * 32, 16, 1024);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) wgmma_rs_bf16<BN, 0>(acc[mt], af[ks][mt], db);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      ring_release(ring, s, wtid);
      ++it;
    };
    int wi = 0;
    auto window = [&](auto body) {
      const int slot = wi % nslots;
      mbar_wait(&wfull[slot], (wi / nslots) & 1);
      body(win_s + (int64_t)slot * wrows * LDW);
      if (wtid == 0) mbar_arrive(&wempty[slot]);
      ++wi;
    };
    for (int c = 0; c < ngroups; ++c) {
      if (!live(c)) continue;
      const bool band = banded(c);
      // this warpgroup's window: the CTA's found one, or its block's planned one
      int ws, wl, base;
      if constexpr (PLAN) {
        const int32_t* d = desc_s + c * PLAN_DESC + 4 + 3 * wg;
        ws = d[0];
        wl = d[1];
        base = d[2];
      } else {
        ws = lo_s[c];
        wl = max(hi_s[c] - ws + 1, 0);
        base = 0;
      }
      const int gb = gbase(c);
      const int gl = glen(c);
      for (int sl = 0; sl < nsl; ++sl) {
        if (band) {
          window([&](const unsigned char* win) {
            for (int jj = 0; jj < gl; ++jj) compute(goff(gb, jj), sl, win, ws, wl, base, true);
          });
        } else {
          for (int jj = 0; jj < kg; ++jj) {
            window([&](const unsigned char* win) {
              compute(c * kg + jj, sl, win, 0, 0, 0, false);
            });
          }
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      store_tile<BN>(acc[mt], y, cout, row0 + wg * 128 + mt * 64, n, tile * BN,
                     cout, wtid);
    }
  }
  __syncthreads();  // no producer leaves before the copies it issued landed
}

// The operands the window conv reads: x [n, cin] f32 as bf16 rows padded to
// cinp channels, and w [k, cin, cout] f32 (with `flip`: a forward's [k,
// cout, cin]) as the weight image of its tiles of conv_tile_n(cout) columns.
int cast_conv_operands(const float* x, const float* w, __nv_bfloat16* xb,
                       __nv_bfloat16* wimg, int n, int k, int cin, int cinp,
                       int cout, int flip, cudaStream_t stream) {
  const int nsl = (cinp + 63) / 64;
  const int bn = conv_tile_n(cout);
  const int ntiles = (cout + bn - 1) / bn;
  cast_rows_kernel<<<grid_for((int64_t)n * cinp / 8), 256, 0, stream>>>(x, xb, n, cin, cinp);
  cast_weight_image_kernel<<<grid_for((int64_t)ntiles * k * nsl * bn * 8), 256, 0,
                             stream>>>(w, wimg, k, cin, cout, bn, nsl, ntiles, flip);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
