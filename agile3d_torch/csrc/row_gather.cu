// Row gather from a table held in shared memory, for Hopper (sm_90a).
//
//   out[i, :] = x[idx[i], :],  x [w, c] f32 staged whole in shared memory
//
// Replaces tools/probe_vmem_gather.py::gather_kernel and ::gather_kernel_ta,
// the TPU probe's two lowering forms (jnp.take and take_along_axis) of one
// function: a row gather from a table resident in VMEM. The H100's shared
// memory plays VMEM's part; it holds at most 227 KB, so the table must fit
// (the wrapper refuses a larger one).
//
// Bound on the H100: no arithmetic, so bytes: the table read once, the
// indices read once and the output written once. Each block first reads
// the whole table from device memory (L2 after the first blocks), so a
// grid of B blocks reads B tables; the grid is kept to about one block per
// SM, each writing a contiguous share of the output rows.
//
// Design: a block copies the table into shared memory with coalesced
// 16-byte loads, then its threads walk its share of the output in 16-byte
// pieces: consecutive threads take consecutive pieces of one row (reads
// from shared memory without bank conflicts, coalesced stores). An index
// outside [0, w) writes a zero row (the plain version raises instead).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int SMEM_MAX = 232448;  // shared memory one block may use (227 KB)

__global__ void __launch_bounds__(THREADS)
smem_row_gather_kernel(const float4* __restrict__ x,
                       const int32_t* __restrict__ idx,
                       float4* __restrict__ out, int w, int c4, int64_t m,
                       int64_t rows_per_block) {
  extern __shared__ float4 tab[];  // [w][c4]
  const int tid = threadIdx.x;
  for (int e = tid; e < w * c4; e += THREADS) tab[e] = __ldg(x + e);
  __syncthreads();

  const int64_t r0 = blockIdx.x * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < m ? r0 + rows_per_block : m;
  const int64_t pieces = (r1 - r0) * c4;
  for (int64_t e = tid; e < pieces; e += THREADS) {
    const int64_t dr = e / c4;
    const int q = static_cast<int>(e - dr * c4);
    const int i = __ldg(idx + r0 + dr);
    out[(r0 + dr) * c4 + q] =
        (i >= 0 && i < w) ? tab[i * c4 + q] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace

// x [w, c] f32 (16-byte aligned, c a multiple of 4, w * c * 4 bytes at most
// 227 KB), idx [m] i32, out [m, c] f32, all contiguous on the current
// device; `blocks` is the grid size. Returns the CUDA error of the launch
// (0 = launched).
extern "C" int agile3d_smem_row_gather(const void* x, const void* idx,
                                       void* out, int w, int c, int64_t m,
                                       int blocks, void* stream) {
  const int64_t smem = (int64_t)w * c * sizeof(float);
  if (w <= 0 || c <= 0 || c % 4 != 0 || blocks <= 0 || smem > SMEM_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      smem_row_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per = (m + blocks - 1) / blocks;
  const int grid = static_cast<int>((m + per - 1) / per);
  smem_row_gather_kernel<<<grid, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<const int32_t*>(idx),
      static_cast<float4*>(out), w, c / 4, m, per);
  return static_cast<int>(cudaGetLastError());
}
