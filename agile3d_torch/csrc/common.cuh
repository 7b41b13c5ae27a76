// Building blocks shared by the port's Hopper kernels (sm_90a): 16-byte
// cp.async copies, ldmatrix, the bf16 mma.sync m16n8k16 tile product, the
// passes that cast f32 rows and weights to padded bf16 operands, and the
// pieces of the warp-specialised kernels: mbarriers, bulk copies, wgmma
// with its swizzled shared-memory images, the stage ring of two producer
// warpgroups and two consumer warpgroups, and the casts that write those
// images.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace
