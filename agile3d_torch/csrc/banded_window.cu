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
// and length of its band.
//
// Bound on the H100: the products of the gathered conv (2 * cin * cout per
// neighbour inside its window, ~96 FLOP per gathered byte at cin 96), so
// the floor is the bf16 tensor-core rate. The first design (one block per
// 128 rows, mma.sync, one window at a time behind block barriers, weight
// tiles staged one offset ahead) stayed 8x above it, as the k3 conv's like
// design did: the barriers and the per-block weight staging bounded it, not
// the rows.
//
// Design: the k3 conv's kernel (common.cuh, window_conv_kernel) with its
// windows read from the plan instead of found from the indices: two
// producer and two consumer warpgroups (setmaxnreg), mbarrier rings, the
// weights cast once into wgmma's swizzled image and streamed by bulk copy,
// each window copied once per 64-channel slice with A fragments read from
// it by row address (ldmatrix) for wgmma m64nNk16 from registers, and no
// __syncthreads in the main loop. A CTA's 256 rows are two plan blocks, one
// per consumer warpgroup, each masking by its own block's windows; the
// cluster's slot holds both blocks' windows (their union where that is not
// longer). Two window slots where twice the plan's longest window fits in
// each, else one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// x [n, cin] f32, nbr [n, k] i32, w [k, cin, cout] f32, y [n, cout] f32;
// the plan: start, length [ceil(n / 128), ncl] i32 (window rows of each
// block and cluster, inside [0, n)), order [k] i32 (offsets grouped by
// cluster), bounds [ncl + 1] i32 (cluster c holds order[bounds[c] :
// bounds[c + 1]], bounds[ncl] == k), max_len >= every length; scratch xb
// [n, cinp] bf16 with cinp a multiple of 16 and >= cin, and wimg, the
// weights' image (as the k3 conv's: ceil(cout / bn) * k * ceil(cinp / 64) *
// bn * 64 bf16 with bn = conv_tile_n(cout)). All contiguous on the current
// device. Returns the CUDA error of the launches (0 = launched;
// cudaErrorInvalidValue when two windows of max_len rows do not fit one
// slot).
extern "C" int agile3d_banded_window(const void* x, const void* nbr,
                                     const void* w, const void* start,
                                     const void* length, const void* order,
                                     const void* bounds, void* y, void* xb,
                                     void* wimg, int n, int k, int ncl, int cin,
                                     int cinp, int cout, int max_len,
                                     void* stream_ptr) {
  if (cinp % 16 != 0 || cinp < cin || k <= 0 || ncl <= 0 || max_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || cout <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* wip = static_cast<__nv_bfloat16*>(wimg);
  const int rc = cast_conv_operands(static_cast<const float*>(x), static_cast<const float*>(w),
                                    xbp, wip, n, k, cin, cinp, cout, 0, stream);
  if (rc != 0) return rc;
  const PlanWindows plan{static_cast<const int32_t*>(start), static_cast<const int32_t*>(length),
                         static_cast<const int32_t*>(order), static_cast<const int32_t*>(bounds),
                         (n + BM / 2 - 1) / (BM / 2), ncl};
  const int nsl = (cinp + 63) / 64;
  const int desc = plan_desc_ints(k, ncl);
  return with_tile_n(cout, [&](auto tile_n) {
    constexpr int BN = decltype(tile_n)::value;
    // the most slots first, then the staged indices, as long as a slot
    // holds two windows of max_len rows
    for (int slots = WIN_SLOTS; slots >= 1; --slots) {
      for (int idx = 1; idx >= 0; --idx) {
        const int wmax = win_rows(BN, k, idx, desc, slots);
        if (2 * max_len > wmax) continue;
        const size_t smem = win_fixed_smem(BN, k, idx, desc) + (size_t)slots * (wmax + 1) * LDW;
        return launch(window_conv_kernel<BN, true>,
                      dim3((n + BM - 1) / BM, (cout + BN - 1) / BN), smem, stream,
                      static_cast<const __nv_bfloat16*>(xbp),
                      static_cast<const int32_t*>(nbr),
                      static_cast<const __nv_bfloat16*>(wip), static_cast<float*>(y), n, k,
                      cinp, cout, nsl, 1, wmax, slots, idx, plan);
      }
    }
    return static_cast<int>(cudaErrorInvalidValue);
  });
}
