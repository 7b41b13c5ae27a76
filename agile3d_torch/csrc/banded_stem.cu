// k5 stem sparse convolution for Hopper (sm_90a): the 3 -> 32 first layer.
//
//   y[i, :] = sum_{j < 125} bf16(x[k5[i, j], :]) @ bf16(w[j]),  f32 accumulation
//
// k5[i, j] == -1 contributes 0, so pad rows come out exactly 0. Offsets are
// dx-major with dz fastest (kernel_offsets(5)); the kernel only follows the
// map, so the order matters to nobody but the weights.
//
// Replaces the JAX package's ops/banded_stem.py::_make_stem_kernel, which
// packs each (dx, dy) z-strip into one 128-lane row and compacts cells with
// shift matmuls, because the TPU pads a 3-channel row to 128 lanes. On the
// GPU a 3-float row is 12 bytes and is gathered as it is.
//
// Bound on the H100: 2 * 125 * 3 * 32 = 24 kFLOP per output row against
// 500 bytes of k5 indices per row, so the kernel is bound by reading k5
// (98 MB at 196,608 rows), not by arithmetic. The design therefore reads k5
// exactly once, coalesced: a block stages the k5 rows of its 32 output rows
// into shared memory with contiguous loads, keeps the weights of its column
// tile in shared memory as bf16, and gives each thread 4 output columns of
// one row. The x rows it gathers are 12 bytes each and mostly hit L1/L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KVOL = 125;          // 5x5x5 offsets
constexpr int CIN = 3;
constexpr int RB = 32;             // output rows per block
constexpr int CG = 8;              // column groups of 4 per block
constexpr int BN = CG * 4;         // output columns per block
constexpr int THREADS = RB * CG;   // 256

__global__ void __launch_bounds__(THREADS)
banded_stem_kernel(const float* __restrict__ x, const int32_t* __restrict__ k5,
                   const float* __restrict__ w, float* __restrict__ y, int n,
                   int cout) {
  __shared__ int32_t nbr_s[RB * KVOL];
  __shared__ __align__(16) __nv_bfloat16 w_s[KVOL * CIN * BN];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * RB;
  const int col0 = blockIdx.y * BN;

  // k5 rows of this block: one contiguous run of RB * 125 indices
  const int64_t base = (int64_t)row0 * KVOL;
  const int64_t total = (int64_t)n * KVOL;
  for (int e = tid; e < RB * KVOL; e += THREADS) {
    nbr_s[e] = base + e < total ? k5[base + e] : -1;
  }
  // weights of this column tile, bf16: w_s[(j * 3 + c) * BN + o]
  for (int e = tid; e < KVOL * CIN * BN; e += THREADS) {
    const int jc = e / BN;
    const int o = e - jc * BN;
    float v = 0.f;
    if (col0 + o < cout) v = w[(int64_t)jc * cout + col0 + o];
    w_s[e] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int r = tid / CG;
  const int o0 = (tid - r * CG) * 4;
  const int32_t* nb = nbr_s + r * KVOL;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j = 0; j < KVOL; ++j) {
    const int src = nb[j];
    if (src < 0) continue;
    const float* xr = x + (int64_t)src * CIN;
#pragma unroll
    for (int c = 0; c < CIN; ++c) {
      const float xv = __bfloat162float(__float2bfloat16_rn(__ldg(xr + c)));
      const __nv_bfloat16* wr = w_s + (j * CIN + c) * BN + o0;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(xv, __bfloat162float(wr[q]), acc[q]);
    }
  }

  const int row = row0 + r;
  if (row < n) {
    float* out = y + (int64_t)row * cout;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (col0 + o0 + q < cout) out[col0 + o0 + q] = acc[q];
    }
  }
}

}  // namespace

// x [n, 3] f32, k5 [n, 125] i32, w [125, 3, cout] f32, y [n, cout] f32, all
// contiguous on the current device. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int agile3d_banded_stem(const void* x, const void* k5,
                                   const void* w, void* y, int n, int cout,
                                   void* stream) {
  if (n <= 0 || cout <= 0) return 0;
  const dim3 grid((n + RB - 1) / RB, (cout + BN - 1) / BN);
  banded_stem_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(k5),
      static_cast<const float*>(w), static_cast<float*>(y), n, cout);
  return static_cast<int>(cudaGetLastError());
}
