// Banded k3 sparse convolution for Hopper (sm_90a): the forward (also dX)
// and the weight gradient.
//
//   y[i, :]  = sum_{j < k} bf16(x[nbr[i, j], :]) @ bf16(w[j]),   f32 accumulation
//   dw[j]    = sum_m bf16(x[nbr[m, j], :])^T @ bf16(g[m, :]),     f32 accumulation
//
// nbr[i, j] == -1 contributes 0, so rows whose neighbours are all absent
// (the pad rows of a bucket) come out exactly 0.
//
// Replaces the JAX package's agile3d_tpu/ops/banded_conv.py:181
// (_make_kernel: gathers a sorted row window through one-hot band matmuls,
// because Mosaic has no row gather from VMEM, plus an exception list) and
// agile3d_tpu/ops/banded_conv.py:280 (_make_dw_kernel: carries the
// [k * cin, cout] sum in VMEM across its sequential grid). Here the rows
// are gathered by index straight from device memory: no window plan, no
// exception list.
//
// Bound on the H100: 2 * cin * cout FLOP per present neighbour (18-25 kFLOP
// at cin 96-128, cout 96) against one gathered row of 2 * cin bytes, ~96
// FLOP per gathered byte, mostly from L2 (neighbours of consecutive sorted
// rows are near each other): the floor is the bf16 tensor-core rate. What
// held the first design (mma.sync, a 128-row block, one 32-channel slice of
// w[j] staged per step behind a block-wide barrier) 8-10x above it was not
// the rows: every block re-staged all of w (648 KiB at 128 -> 96, 1.02 GB
// of L2 reads per call at 196,608 rows, more than the 0.81 GB of gathered
// rows) with 24 mma.sync per warp between barriers. Its dW kernel read each
// row of g 27 times, once per offset's block.
//
// Design: warp-specialised kernels on rings of stages in shared memory
// (common.cuh), with no __syncthreads in their main loops. Two producer
// warpgroups (registers lowered with setmaxnreg) keep the stages full; two
// consumer warpgroups run wgmma.mma_async m64nNk16 (bf16 in, f32
// accumulators in registers) and give a stage back through its `empty`
// mbarrier. The operand that every CTA reads whole (the weights; for dW the
// rows of g) is cast once per call into the exact swizzled shared-memory
// image that wgmma reads, one contiguous run per stage, and arrives by bulk
// copy (cp.async.bulk: no tensor map, so the library needs nothing beyond
// the CUDA runtime).
//  * conv (forward and dX): a CTA owns 256 output rows (128 per consumer
//    warpgroup, two m64 tiles) and BN <= 128 output columns (blockIdx.y
//    tiles wider outputs), so each weight slice is staged once per 256 rows
//    instead of once per 128 (0.51 GB of L2 reads at 196,608 rows,
//    128 -> 96). It first stages its rows' indices and finds, for each dx
//    (the 9 offsets whose neighbours of sorted rows lie in one band), the
//    window of rows they span. For each (dx, 64-channel slice) it copies
//    that window once into shared memory (16-byte cp.async, a zero row
//    after it) and each of the dx's offsets reads its A fragments from it by
//    row address (ldmatrix; an absent neighbour reads the zero row), then
//    runs wgmma with A from registers against the offset's weight slice
//    (one ring stage per offset and slice). A window longer than the
//    shared memory left falls back, in that CTA, to one window per offset
//    holding its 256 gathered rows. The dX conv reads the forward's weights
//    through the image cast (flip(w, 0).transpose(1, 2)), with no copy.
//    The kernel is common.cuh's window_conv_kernel, which the window probe
//    (banded_window.cu) runs with its windows read from a host plan.
//  * dW: a CTA owns (a chunk of rows, a group of 2 offsets, 128 input
//    channels, BN <= 128 output columns), one consumer warpgroup per
//    offset. One stage = 64 rows: those rows of g (B, MN-major, from the
//    image of g, shared by the two offsets) and, per offset, the 64
//    gathered rows of x (A = x^T, MN-major). Each row of g is read 27 / 2
//    times instead of 27. Each CTA writes one f32 partial per chunk; a
//    second pass sums the partials in chunk order, so the result does not
//    change from run to run (no atomics).
// One CTA per SM, no cluster: sharing each stage's weights (dW: rows of g)
// with a second CTA by multicast was slower on the H100, as was gathering
// the conv's rows per offset straight into swizzled A tiles (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int DW_KR = 64;                       // dW: rows per stage
constexpr int DW_CM = 128;                      // dW: input channels per CTA (two m64 tiles)
constexpr int DW_X_BYTES = DW_KR * DW_CM * 2;   // dW: one offset's gathered rows per stage
constexpr int DW_CHUNK = 8192;                  // dW: most rows per CTA

// The conv: window_conv_kernel (common.cuh) with the windows found by each
// CTA, in two slots, the indices staged where the windows still fit
int dispatch_conv(const __nv_bfloat16* xb, const int32_t* nbr,
                  const __nv_bfloat16* wimg, float* y, int n, int k, int cinp,
                  int cout, int nsl, int kg, cudaStream_t stream) {
  return with_tile_n(cout, [&](auto tile_n) {
    constexpr int BN = decltype(tile_n)::value;
    bool idx = true;
    int wmax = win_rows(BN, k, idx, 2 * k, WIN_SLOTS);
    if (wmax < BM) {
      idx = false;
      wmax = win_rows(BN, k, idx, 2 * k, WIN_SLOTS);
    }
    if (wmax < BM) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = win_fixed_smem(BN, k, idx, 2 * k) + (size_t)WIN_SLOTS * (wmax + 1) * LDW;
    return launch(window_conv_kernel<BN, false>, dim3((n + BM - 1) / BM, (cout + BN - 1) / BN),
                  smem, stream, xb, nbr, wimg, y, n, k, cinp, cout, nsl, kg, wmax,
                  WIN_SLOTS, static_cast<int>(idx), PlanWindows{});
  });
}

// bytes of dynamic shared memory of the dW kernel: alignment slack, the
// ring (rows of g, and each offset's gathered rows of x) and its barriers
size_t dw_smem(int bn) {
  return 1024 + (size_t)RING * (((bn + 63) / 64) * 8192 + CONSUMERS * DW_X_BYTES)
         + 2 * RING * sizeof(uint64_t);
}

// part[chunk, j, c, o] = sum over the chunk's rows m of
//   bf16(x[nbr[m, j], c]) * bf16(g[m, o])
// for the CTA's offsets j = 2 blockIdx.x + {0, 1} (one consumer warpgroup
// each), 128 channels c and BN columns o (blockIdx.z = ctile + ctiles *
// otile); stage it = the chunk's rows 64 it .. + 64
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
banded_conv_dw_kernel(const __nv_bfloat16* __restrict__ xb,
                      const int32_t* __restrict__ nbr,
                      const __nv_bfloat16* __restrict__ gimg,
                      float* __restrict__ part, int n, int k, int cin,
                      int cinp, int cout, int chunk, int ctiles, int otiles) {
  constexpr int NA = (BN + 63) / 64;   // 64-column atoms of the g tile
  constexpr int G_BYTES = NA * 8192;   // a stage's rows of g
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* g_s = aligned_smem(smem_raw);            // [RING][NA][64 rows][128 B]
  unsigned char* x_s = g_s + RING * G_BYTES;              // [RING][2][2 atoms][64 rows][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(x_s + RING * CONSUMERS * DW_X_BYTES);
  const Ring ring{bars, bars + RING};

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * CONSUMERS;
  const int ch = blockIdx.y;
  const int ct = blockIdx.z % ctiles;
  const int ot = blockIdx.z / ctiles;
  const int c0 = ct * DW_CM;
  const int m0 = ch * chunk;
  const int rows = min(chunk, n - m0);
  const int iters = (rows + DW_KR - 1) / DW_KR;
  if (tid == 0) ring_init(ring);
  __syncthreads();  // barriers ready

  if (tid >= CONSUMERS * 128) {
    // producer: the stage's rows of g and, per offset, 64 gathered rows of x
    regs_dec<PRODUCER_REGS>();
    const int ptid = tid - CONSUMERS * 128;
    const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(
        gimg + ((int64_t)(m0 / DW_KR) * otiles * NA + ot * NA) * 64 * 64);
    const int64_t gstep = (int64_t)otiles * NA * 8192;  // bytes per 64 rows of the image
    auto shared = [&](int it, int s) {
      bulk_copy(g_s + s * G_BYTES, gsrc + it * gstep, G_BYTES, &ring.full[s]);
    };
    // piece q = ptid % 16 of rows ptid / 16 + 16 i of each offset (the rows
    // share r % 8, so one swizzle); each stage's indices are loaded while
    // the stage before issues its copies
    constexpr int PER = DW_KR * 16 / PRODUCERS;
    constexpr int STEP = PRODUCERS / 16;
    const int q = ptid & 15;
    const int rt = ptid >> 4;
    const int c = c0 + q * 8;
    int next[CONSUMERS][PER];
    auto load_indices = [&](int it) {
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          const int m = it * DW_KR + rt + i * STEP;
          next[w][i] = j0 + w < k && m < rows && c < cinp
                           ? nbr[(int64_t)(m0 + m) * k + j0 + w] : -1;
        }
      }
    };
    load_indices(0);
    auto gather = [&](int it, int s) {
      int src[CONSUMERS][PER];
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
#pragma unroll
        for (int i = 0; i < PER; ++i) src[w][i] = next[w][i];
      }
      if (it + 1 < iters) load_indices(it + 1);
      const uint32_t dst = smem_u32(x_s + s * CONSUMERS * DW_X_BYTES) + (q >> 3) * 8192
                           + swz(rt, q & 7);
      const __nv_bfloat16* base = xb + (c < cinp ? c : 0);
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w) {
        if (j0 + w >= k) continue;
#pragma unroll
        for (int i = 0; i < PER; ++i) {
          cp_async16_s(dst + w * DW_X_BYTES + i * STEP * 128,
                       base + (int64_t)max(src[w][i], 0) * cinp, src[w][i] >= 0 ? 16 : 0);
        }
      }
      cp_async_arrive(&ring.full[s]);
    };
    ring_produce(ring, iters, ptid, G_BYTES, shared, gather);
  } else {
    // consumers: warpgroup wg owns offset j0 + wg, channels c0 .. c0 + 128
    // (two m64 tiles of A = x^T) and the tile's BN columns
    regs_inc<CONSUMER_REGS>();
    const int wg = tid >> 7;
    const int wtid = tid & 127;
    const int j = j0 + wg;
    float acc[2][BN / 2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
    }
    for (int it = 0; it < iters; ++it) {
      const int s = Ring::slot(it);
      ring_wait(ring, it);
      if (j >= k) {  // no offset here: keep the ring's count
        ring_release(ring, s, wtid);
        continue;
      }
      const unsigned char* gs = g_s + s * G_BYTES;
      const unsigned char* xs = x_s + (s * CONSUMERS + wg) * DW_X_BYTES;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DW_KR / 16; ++ks) {
        const uint64_t db = smem_desc(gs + ks * 2048, 8192, 1024);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          wgmma_bf16<BN, 1, 1>(acc[mt], smem_desc(xs + mt * 8192 + ks * 2048, 8192, 1024),
                               db);
        }
      }
      wgmma_commit();
      // one stage's products stay in flight: the previous stage's are done,
      // and its slot is free
      wgmma_wait<1>();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (it > 0) ring_release(ring, Ring::slot(it - 1), wtid);
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    if (j < k) {
      float* out = part + ((int64_t)ch * k + j) * cin * cout;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        store_tile<BN>(acc[mt], out, cout, c0 + mt * 64, cin, ot * BN, cout, wtid);
      }
    }
  }
  __syncthreads();  // no producer leaves before the copies it issued landed
}

// out[e] = sum_{p < nparts} part[p, e], in order p = 0, 1, ...
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ out, int64_t per,
                                    int nparts) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < per;
       e += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < nparts; ++p) s += part[p * per + e];
    out[e] = s;
  }
}

// output columns per CTA of dW: 64, 96 or 128 (ops/banded_conv.py::dw_tile_n)
int dw_tile_n(int cout) { return cout <= 64 ? 64 : cout <= 96 ? 96 : 128; }

template <int BN>
int launch_dw(const __nv_bfloat16* xb, const int32_t* nbr,
              const __nv_bfloat16* gimg, float* part, int n, int k, int cin,
              int cinp, int cout, int chunk, cudaStream_t stream) {
  const int ctiles = (cinp + DW_CM - 1) / DW_CM;
  const int otiles = (cout + BN - 1) / BN;
  return launch(banded_conv_dw_kernel<BN>,
                dim3((k + CONSUMERS - 1) / CONSUMERS, (n + chunk - 1) / chunk,
                     ctiles * otiles),
                dw_smem(BN), stream, xb, nbr, gimg, part, n, k, cin, cinp, cout, chunk,
                ctiles, otiles);
}

int dispatch_dw(const __nv_bfloat16* xb, const int32_t* nbr,
                const __nv_bfloat16* gimg, float* part, int n, int k, int cin,
                int cinp, int cout, int chunk, cudaStream_t stream) {
  switch (dw_tile_n(cout)) {
    case 64: return launch_dw<64>(xb, nbr, gimg, part, n, k, cin, cinp, cout, chunk, stream);
    case 96: return launch_dw<96>(xb, nbr, gimg, part, n, k, cin, cinp, cout, chunk, stream);
    default: return launch_dw<128>(xb, nbr, gimg, part, n, k, cin, cinp, cout, chunk, stream);
  }
}

}  // namespace

// x [n, cin] f32, nbr [n, k] i32, w [k, cin, cout] f32 (with `flip`: a
// forward's [k, cout, cin], used as flip(w, 0).transpose(1, 2)), y [n, cout]
// f32; scratch xb [n, cinp] bf16 with cinp a multiple of 16 and >= cin, and
// wimg, the weights' image: ceil(cout / bn) * k * ceil(cinp / 64) * bn * 64
// bf16 with bn = conv_tile_n(cout). All contiguous on the current device.
// Returns the CUDA error of the launches (0 = launched).
extern "C" int agile3d_banded_conv(const void* x, const void* nbr,
                                   const void* w, void* y, void* xb, void* wimg,
                                   int n, int k, int cin, int cinp, int cout,
                                   int flip, void* stream_ptr) {
  if (cinp % 16 != 0 || cinp < cin || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || cout <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* wip = static_cast<__nv_bfloat16*>(wimg);
  const int nsl = (cinp + 63) / 64;
  const int rc = cast_conv_operands(static_cast<const float*>(x), static_cast<const float*>(w),
                                    xbp, wip, n, k, cin, cinp, cout, flip, stream);
  if (rc != 0) return rc;
  int s = 1;
  while ((s + 1) * (s + 1) * (s + 1) <= k) ++s;
  const int kg = s * s * s == k ? s * s : 1;  // offsets of one dx
  return dispatch_conv(xbp, static_cast<const int32_t*>(nbr), wip, static_cast<float*>(y),
                       n, k, cinp, cout, nsl, kg, stream);
}

// x [n, cin] f32, nbr [n, k] i32, g [n, cout] f32, dw [k, cin, cout] f32;
// scratch xb [n, cinp] bf16 (cinp a multiple of 8, >= cin), gimg, the image
// of g: ceil(n / 64) * 64 * ceil(cout / bn) * ceil(bn / 64) * 64 bf16 with
// bn = dw_tile_n(cout), and part [ceil(n / chunk), k, cin, cout] f32, with
// chunk a multiple of 64 up to 8192. All contiguous on the current device.
// Returns the CUDA error of the launches (0 = launched).
extern "C" int agile3d_banded_conv_dw(const void* x, const void* nbr,
                                      const void* g, void* dw, void* xb,
                                      void* gimg, void* part, int n, int k,
                                      int cin, int cinp, int cout, int chunk,
                                      void* stream_ptr) {
  if (cinp % 8 != 0 || cinp < cin || k <= 0 || chunk % DW_KR != 0
      || chunk <= 0 || chunk > DW_CHUNK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t per = (int64_t)k * cin * cout;
  if (per == 0) return 0;
  if (n <= 0) {
    return static_cast<int>(
        cudaMemsetAsync(dw, 0, per * sizeof(float), stream));
  }
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* gip = static_cast<__nv_bfloat16*>(gimg);
  const int bn = dw_tile_n(cout);
  const int na = (bn + 63) / 64;
  const int otiles = (cout + bn - 1) / bn;
  cast_rows_kernel<<<grid_for((int64_t)n * cinp / 8), 256, 0, stream>>>(
      static_cast<const float*>(x), xbp, n, cin, cinp);
  cast_row_image_kernel<<<grid_for((int64_t)(n + 63) / 64 * otiles * na * 512), 256,
                          0, stream>>>(static_cast<const float*>(g), gip, n, cout,
                                       bn, na, otiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* pp = static_cast<float*>(part);
  const int rc = dispatch_dw(xbp, static_cast<const int32_t*>(nbr), gip, pp, n, k, cin,
                             cinp, cout, chunk, stream);
  if (rc != 0) return rc;
  const int nparts = (n + chunk - 1) / chunk;
  sum_partials_kernel<<<grid_for(per), 256, 0, stream>>>(
      pp, static_cast<float*>(dw), per, nparts);
  return static_cast<int>(cudaGetLastError());
}
