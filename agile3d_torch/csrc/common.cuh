// Building blocks shared by the port's Hopper kernels (sm_90a): 16-byte
// cp.async copies, ldmatrix, the bf16 mma.sync m16n8k16 tile product, and
// the passes that cast f32 rows and weights to padded bf16 operands.

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

// the four 8x8 matrices transposed: the tile in shared memory is [k][m]
// (or [k][n]) and the fragment wants [m][k]
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// xb[r, c] = bf16(x[r, c]) for c < cin, 0 for cin <= c < cinp
__global__ void cast_rows_kernel(const float* __restrict__ x,
                                 __nv_bfloat16* __restrict__ xb, int64_t n,
                                 int cin, int cinp) {
  const int64_t total = n * cinp;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = e / cinp;
    const int c = static_cast<int>(e - r * cinp);
    xb[e] = __float2bfloat16_rn(c < cin ? x[r * cin + c] : 0.f);
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

}  // namespace
