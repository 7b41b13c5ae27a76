// Windowed banded k3 sparse convolution for Hopper (sm_90a).
//
//   y[i, :] = sum_j bf16(x[nbr[i, j], :]) @ bf16(w[j]),  f32 accumulation,
//
// summed over the neighbours that lie inside the window of row i's block
// for offset j's cluster; a neighbour outside its window, or absent (-1),
// contributes 0, so pad rows come out exactly 0.
//
// Replaces tools/probe_banded_kernel.py::make_banded_conv, the TPU probe
// that DMAs a contiguous window of sorted rows into VMEM per 128-row block
// and gathers from it with one-hot band matmuls (Mosaic has no VMEM row
// gather). Rows are sorted with z fastest, so the three offsets' clusters of
// equal dx read three narrow bands of rows: the host plan
// (ops/banded_window.py::window_plan) gives each (block, cluster) the start
// and length of its band. Here the window sits in shared memory and
// ldmatrix takes one row address per lane, so the A fragments are built by
// address straight from the window: no one-hot products.
//
// Bound on the H100: the same products as the gathered conv (2 * cin * cout
// per present neighbour, ~96 FLOP per gathered byte at cin 96), so the
// floor is the bf16 tensor-core rate. What the window changes is traffic:
// a block reads three contiguous bands of ~150 rows (on the eval scenes)
// instead of 27 x 128 scattered rows, about 5x fewer bytes, in 16-byte
// pieces of whole rows.
//
// Design: one block per 128 output rows and BN <= 128 output columns
// (blockIdx.y tiles wider outputs), 8 warps (4 along rows x 2 along
// columns) with the accumulators in registers across all offsets.
//  1. cast_rows / cast_weights (common.cuh): x -> bf16 rows padded to cinp
//     (a multiple of 16), w -> bf16 [k][cout][cinp].
//  2. The block stages its rows' neighbour indices in shared memory. For
//     each cluster it copies its window of bf16 rows with 16-byte cp.async
//     into shared memory, followed by one zero row. For each of the
//     cluster's offsets, each lane points ldmatrix at row nbr - start of
//     the window (the zero row when the neighbour is absent or outside),
//     and mma.sync m16n8k16 multiplies with w[j]^T, whose tile is staged
//     in shared memory one offset ahead (two buffers).
// Dynamic shared memory is sized from the plan's longest window; the
// wrapper refuses a plan whose window does not fit. One window at a time:
// at cin 128 two of the longest windows of a noisy 400k-point scene
// (556 rows) do not fit beside the weights. No TMA or wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int BM = 128;             // output rows per block
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int WM = BM / WARPS_M;    // 32 rows per warp
constexpr int MT = WM / 16;         // m16 tiles per warp
constexpr int SMEM_MAX = 232448;    // shared memory one block may use (227 KB)

// bytes of dynamic shared memory: neighbour indices, two weight tiles, and
// the window with its zero row (row strides cinp + 8: conflict-free ldmatrix)
size_t smem_bytes(int k, int bn, int cinp, int max_len) {
  const size_t ldw = cinp + 8;
  return (size_t)BM * k * sizeof(int32_t)
         + (2 * (size_t)bn + max_len + 1) * ldw * sizeof(__nv_bfloat16);
}

template <int NT>  // n8 tiles per warp: the block covers BN = WARPS_N * NT * 8 columns
__global__ void __launch_bounds__(THREADS, 2)
banded_window_kernel(const __nv_bfloat16* __restrict__ xb,
                     const int32_t* __restrict__ nbr,
                     const __nv_bfloat16* __restrict__ wt,
                     const int32_t* __restrict__ start,
                     const int32_t* __restrict__ length,
                     const int32_t* __restrict__ order,
                     const int32_t* __restrict__ bounds,
                     float* __restrict__ y, int n, int k, int ncl, int cinp,
                     int cout) {
  constexpr int BN = WARPS_N * NT * 8;
  const int ldw = cinp + 8;
  const int chunks = cinp / 8;  // 16-byte pieces of a bf16 row
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* rows_s = reinterpret_cast<int32_t*>(smem);                     // [BM][k]
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(rows_s + BM * k);  // [2][BN][ldw]
  __nv_bfloat16* win_s = w_s + 2 * BN * ldw;                              // [len + 1][ldw]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int blk = blockIdx.x;
  const int row0 = blk * BM;
  const int col0 = blockIdx.y * BN;

  // the block's neighbour indices: one contiguous run of BM * k ints
  const int64_t base = (int64_t)row0 * k;
  const int64_t total = (int64_t)n * k;
  for (int e = tid; e < BM * k; e += THREADS) {
    rows_s[e] = base + e < total ? nbr[base + e] : -1;
  }

  // BN output columns x cinp channels of w[j]^T into weight buffer `buf`
  auto load_w = [&](int j, int buf) {
    __nv_bfloat16* ws = w_s + buf * BN * ldw;
    for (int e = tid; e < BN * chunks; e += THREADS) {
      const int o = e / chunks;
      const int q = e - o * chunks;
      const int col = col0 + o;
      const __nv_bfloat16* src =
          wt + ((int64_t)j * cout + min(col, cout - 1)) * cinp + q * 8;
      cp_async16(ws + o * ldw + q * 8, src, col < cout ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;
    }
  }

  load_w(order[0], 0);
  cp_async_commit();
  int t = 0;  // position in `order`: offsets grouped by cluster
  for (int c = 0; c < ncl; ++c) {
    const int s0 = start[blk * ncl + c];
    const int len = length[blk * ncl + c];
    // the window rows [s0, s0 + len), then a zero row at len (the previous
    // cluster's reads ended at the last __syncthreads of its loop)
    for (int e = tid; e < len * chunks; e += THREADS) {
      const int r = e / chunks;
      const int q = e - r * chunks;
      cp_async16(win_s + r * ldw + q * 8, xb + (int64_t)(s0 + r) * cinp + q * 8,
                 16);
    }
    for (int q = tid; q < chunks; q += THREADS) {
      *reinterpret_cast<uint4*>(win_s + len * ldw + q * 8) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();

    for (const int t1 = bounds[c + 1]; t < t1; ++t) {
      const int j = order[t];
      if (t + 1 < k) load_w(order[t + 1], (t + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();  // the window and w[j] have landed (this thread's copies)
      __syncthreads();     // ... everyone's

      // each lane's A row: its neighbour's row in the window, or the zero row
      const __nv_bfloat16* arow[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int v = rows_s[(wm * WM + mt * 16 + (lane & 15)) * k + j];
        const int rel = v - s0;
        const int r = (v >= 0 && rel >= 0 && rel < len) ? rel : len;
        arow[mt] = win_s + r * ldw + (lane >> 4) * 8;
      }
      const __nv_bfloat16* bs = w_s + (t & 1) * BN * ldw + (wn * NT * 8) * ldw;
      const int m = lane >> 3;
      for (int ks = 0; ks < cinp; ks += 16) {
        uint32_t af[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // matrices: rows 0-7 / 8-15 of the m16 tile at k 0-7, then at k 8-15
          ldmatrix_x4(af[mt], arow[mt] + ks);
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          // matrices: n-tile 2np at k 0-7 / 8-15, then n-tile 2np+1
          uint32_t bf[4];
          ldmatrix_x4(bf, bs + (np * 16 + (m >> 1) * 8 + (lane & 7)) * ldw + ks + (m & 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
            mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
          }
        }
      }
      __syncthreads();  // the weight buffer and the window are free again
    }
  }
  cp_async_wait<0>();

  const int grp = lane >> 2;
  const int tig = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = col0 + wn * NT * 8 + nt * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + wm * WM + mt * 16 + grp + h * 8;
        if (r < n) {
          float* out = y + (int64_t)r * cout;
          if (col < cout) out[col] = acc[mt][nt][2 * h];
          if (col + 1 < cout) out[col + 1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
  }
}

template <int NT>
int launch_window(const __nv_bfloat16* xb, const int32_t* nbr,
                  const __nv_bfloat16* wt, const int32_t* start,
                  const int32_t* length, const int32_t* order,
                  const int32_t* bounds, float* y, int n, int k, int ncl,
                  int cinp, int cout, int max_len, cudaStream_t stream) {
  constexpr int BN = WARPS_N * NT * 8;
  const size_t smem = smem_bytes(k, BN, cinp, max_len);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      banded_window_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BM - 1) / BM, (cout + BN - 1) / BN);
  banded_window_kernel<NT><<<grid, THREADS, smem, stream>>>(
      xb, nbr, wt, start, length, order, bounds, y, n, k, ncl, cinp, cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, cin] f32, nbr [n, k] i32, w [k, cin, cout] f32, y [n, cout] f32;
// the plan: start, length [ceil(n / 128), ncl] i32 (window rows of each
// block and cluster, inside [0, n)), order [k] i32 (offsets grouped by
// cluster), bounds [ncl + 1] i32 (cluster c holds order[bounds[c] :
// bounds[c + 1]], bounds[ncl] == k), max_len >= every length; scratch xb
// [n, cinp] bf16 and wt [k, cout, cinp] bf16 with cinp a multiple of 16 and
// >= cin. All contiguous on the current device. Returns the CUDA error of
// the launches (0 = launched; cudaErrorInvalidValue when the window does
// not fit in shared memory).
extern "C" int agile3d_banded_window(const void* x, const void* nbr,
                                     const void* w, const void* start,
                                     const void* length, const void* order,
                                     const void* bounds, void* y, void* xb,
                                     void* wt, int n, int k, int ncl, int cin,
                                     int cinp, int cout, int max_len,
                                     void* stream_ptr) {
  if (cinp % 16 != 0 || cinp < cin || k <= 0 || ncl <= 0 || max_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || cout <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* wtp = static_cast<__nv_bfloat16*>(wt);
  cast_rows_kernel<<<grid_for((int64_t)n * cinp / 8), 256, 0, stream>>>(
      static_cast<const float*>(x), xbp, n, cin, cinp);
  cast_weights_kernel<<<grid_for((int64_t)k * cout * cinp), 256, 0, stream>>>(
      static_cast<const float*>(w), wtp, k, cin, cinp, cout);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* nb = static_cast<const int32_t*>(nbr);
  const auto* st = static_cast<const int32_t*>(start);
  const auto* ln = static_cast<const int32_t*>(length);
  const auto* od = static_cast<const int32_t*>(order);
  const auto* bd = static_cast<const int32_t*>(bounds);
  auto* yp = static_cast<float*>(y);
  if (cout <= 32) {
    return launch_window<2>(xbp, nb, wtp, st, ln, od, bd, yp, n, k, ncl, cinp,
                            cout, max_len, stream);
  }
  if (cout <= 64) {
    return launch_window<4>(xbp, nb, wtp, st, ln, od, bd, yp, n, k, ncl, cinp,
                            cout, max_len, stream);
  }
  if (cout <= 96) {
    return launch_window<6>(xbp, nb, wtp, st, ln, od, bd, yp, n, k, ncl, cinp,
                            cout, max_len, stream);
  }
  return launch_window<8>(xbp, nb, wtp, st, ln, od, bd, yp, n, k, ncl, cinp,
                          cout, max_len, stream);
}
