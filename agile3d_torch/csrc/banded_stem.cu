// k5 stem sparse convolution for Hopper (sm_90a): the 3 -> 32 first layer.
//
//   y[i, :] = sum_{j < 125} bf16(x[k5[i, j], :]) @ bf16(w[j]),  f32 accumulation
//
// k5[i, j] == -1 contributes 0, so pad rows come out exactly 0. Offsets are
// dx-major with dz fastest (kernel_offsets(5)); the kernel only follows the
// map, so the order matters to nobody but the weights.
//
// Replaces the JAX package's agile3d_tpu/ops/banded_stem.py:183
// (_make_stem_kernel), which packs each (dx, dy) z-strip into one 128-lane
// row and compacts cells with shift matmuls, because the TPU pads a
// 3-channel row to 128 lanes. On the GPU a row is gathered as it is.
//
// Bound on the H100: reading k5 once. Each output row needs 500 bytes of
// indices against 2 * 125 * 3 * 32 = 24 kFLOP, so at 196,608 rows the
// 98 MB of k5 (plus 25 MB of output) over 3.35 TB/s, 0.0376 ms, is the
// floor; the products take 0.007 ms even padded to K = 512 on the tensor
// cores. The first design (one 32-row block per 256 threads) reached 9% of
// that floor because (1) every block re-staged all of w as f32 and cast it
// to bf16, 48 KB per block and 295 MB of L2 reads per call, three times
// k5's bytes; (2) the products ran as 2.36 G scalar FMAs on the CUDA cores,
// each weight converted from bf16 again, so instruction issue bound it;
// (3) the 8 threads of a row each gathered the same 3 floats of every
// neighbour with scalar loads; (4) each small block ran behind one
// __syncthreads with nothing in flight.
//
// Design: an implicit GEMM on the tensor cores fed by a stream of k5.
//  * One prep pass casts x to bf16 rows padded to 4 channels (8 bytes, one
//    load per neighbour; a zero row after the last row stands for absent
//    neighbours) and w to the exact B128-swizzled image that wgmma reads
//    as its B operand: K = 125 offsets x 4 channels, padded to 512, by 32
//    columns, 32 KB per column tile.
//  * Persistent CTAs (one per SM) load that image once by bulk copy and
//    keep it. A producer warp streams the k5 rows of the CTA's 64-row tiles
//    (one contiguous 32,000-byte run each) by cp.async.bulk into a ring of
//    3 stages on mbarriers, one per consumer warpgroup, so that no waiter
//    can take a phase two ahead for the one it waits on. The
//    last tile, when it is ragged, has a run that need not be 16-byte
//    sized: the producer only marks its stage full, and its consumer fills
//    it with plain loads.
//  * Three consumer warpgroups take the tiles in turn. A row's A row is its
//    125 gathered 4-channel rows; each k16 step covers 4 offsets, and K is
//    ordered so that lane t of a quad holds all 4 channels of offset
//    4 s + t (columns 2t, 2t+1 and 2t+8, 2t+9 of the m16n8k16 A fragment):
//    one 8-byte gather gives a row's two A registers of that step. The A
//    fragments are built in registers straight from the gathers (no A tile
//    in shared memory: nothing else reads them, and the gathered rows are
//    8 bytes, below any swizzle atom), 8 k-steps at a time in two register
//    buffers, each chunk's wgmma m64n32k16 (A from registers, B from the
//    image) running while the next chunk's gathers are in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int KVOL = 125;                      // 5x5x5 offsets
constexpr int CIN = 3;
constexpr int TM = 64;                         // output rows per tile (wgmma m64)
constexpr int BN = 32;                         // output columns per CTA (wgmma n32)
constexpr int KSTEPS = 32;                     // k16 steps of K = 512 >= 125 x 4
constexpr int CHUNK = 8;                       // k16 steps per gather chunk
constexpr int STAGES = 3;                      // ring of k5 tiles
constexpr int SCONS = 3;                       // consumer warpgroups
constexpr int STHREADS = SCONS * 128 + 32;     // the consumers, then the producer warp
constexpr int STAGE_BYTES = TM * KVOL * 4;     // one tile's k5 rows: 32,000 B
constexpr int W_BYTES = KSTEPS * 16 * BN * 2;  // one column tile's weight image: 32 KB

// dynamic shared memory: alignment slack, the weight image, the ring and
// its barriers (full, empty, and the weights' one)
constexpr size_t SMEM = 1024 + W_BYTES + (size_t)STAGES * STAGE_BYTES
                        + (2 * STAGES + 1) * sizeof(uint64_t);
static_assert(SMEM <= SMEM_MAX, "the stem's ring does not fit");
static_assert(STAGE_BYTES % 16 == 0, "bulk copies move 16-byte multiples");
// stage s serves tiles it = s (mod STAGES), so one warpgroup owns it and
// waits on its phases in order (never two phases ahead)
static_assert(STAGES % SCONS == 0, "each stage belongs to one consumer");

// the bf16 image element kk of column o: K index kk = 16 s + p is offset
// 4 s + t, channel c, where p < 8 is the A fragment's column 2t + c and
// p >= 8 its column 2t + 8 + (c - 2)
template <class T>
__device__ __forceinline__ float stem_weight(const T* __restrict__ w, int kk,
                                             int o, int cout) {
  const int s = kk >> 4;
  const int p = kk & 15;
  const int t = (p & 7) >> 1;
  const int c = (p >> 3) * 2 + (p & 1);
  const int j = 4 * s + t;
  return j < KVOL && c < CIN && o < cout ? to_f32(w[(j * CIN + c) * cout + o]) : 0.f;
}

// xb[r] = bf16(x[r, 0..2]), 0 for r < n, and xb[n] = 0 (absent neighbours);
// wimg: per column tile and 64-wide K atom a, [32 columns][128 bytes] with
// each column's 16-byte pieces swizzled (K-major B of wgmma); x and w each
// f32 or bf16
template <class TX, class TW>
__global__ void stem_prep_kernel(const TX* __restrict__ x,
                                 const TW* __restrict__ w,
                                 uint2* __restrict__ xb,
                                 __nv_bfloat16* __restrict__ wimg, int n,
                                 int cout, int ntiles) {
  const int64_t wpieces = (int64_t)ntiles * (KSTEPS / 4) * BN * 8;
  const int64_t total = wpieces + n + 1;
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    if (e < wpieces) {
      const int q = static_cast<int>(e & 7);
      const int o = static_cast<int>((e >> 3) % BN);
      const int64_t ta = (e >> 3) / BN;  // tile * 8 + atom
      const int a = static_cast<int>(ta & 7);
      const int col = static_cast<int>(ta >> 3) * BN + o;
      uint4 out;
      uint32_t* p = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = a * 64 + q * 8 + 2 * i;
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            stem_weight(w, kk, col, cout), stem_weight(w, kk + 1, col, cout));
        p[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(wimg + (ta * BN + o) * 64 + ((q ^ (o & 7)) * 8)) = out;
    } else {
      const int64_t r = e - wpieces;
      float v[3] = {0.f, 0.f, 0.f};
      if (r < n) {
#pragma unroll
        for (int c = 0; c < CIN; ++c) v[c] = to_f32(x[r * CIN + c]);
      }
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], 0.f);
      xb[r] = make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                         *reinterpret_cast<const uint32_t*>(&hi));
    }
  }
}

// The CTA's tiles are blockIdx.x + it * gridDim.x; consumer warpgroup wg
// takes it = wg, wg + SCONS, ...
__global__ void __launch_bounds__(STHREADS, 1)
banded_stem_kernel(const uint2* __restrict__ xb, const int32_t* __restrict__ k5,
                   const __nv_bfloat16* __restrict__ wimg, float* __restrict__ y,
                   int n, int cout) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* w_s = aligned_smem(smem_raw);      // [8 atoms][32 columns][128 B]
  unsigned char* k_s = w_s + W_BYTES;                // [STAGES][64 rows][125]
  uint64_t* full = reinterpret_cast<uint64_t*>(k_s + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* wbar = empty + STAGES;

  const int tid = threadIdx.x;
  const int ntiles = (n + TM - 1) / TM;
  const int tiles = (ntiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1;
  const int ctile = blockIdx.y;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 1);
    }
    mbar_init(wbar, 1);
    fence_barrier_init();
  }
  __syncthreads();  // barriers ready

  if (tid >= SCONS * 128) {
    // the producer: the weight image once, then each tile's k5 rows
    if (tid != SCONS * 128) return;
    mbar_expect_tx(wbar, W_BYTES);
    bulk_copy(w_s, wimg + (int64_t)ctile * (W_BYTES / 2), W_BYTES, wbar);
    for (int it = 0; it < tiles; ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      const int64_t row0 = (int64_t)(blockIdx.x + it * gridDim.x) * TM;
      if (row0 + TM <= n) {
        mbar_expect_tx(&full[s], STAGE_BYTES);
        bulk_copy(k_s + s * STAGE_BYTES, k5 + row0 * KVOL, STAGE_BYTES, &full[s]);
      } else {
        mbar_arrive(&full[s]);  // the ragged tile: its consumer fills it
      }
    }
    return;
  }

  const int wg = tid >> 7;
  const int wtid = tid & 127;
  const int lane = wtid & 31;
  const int t = lane & 3;
  // this thread's rows of a tile: r and r + 8 (the A fragment's rows)
  const int r = (wtid >> 5) * 16 + (lane >> 2);
  bool weights = false;

  for (int it = wg; it < tiles; it += SCONS) {
    const int s = it % STAGES;
    const int row0 = (blockIdx.x + it * gridDim.x) * TM;
    mbar_wait(&full[s], (it / STAGES) & 1);
    if (!weights) {
      mbar_wait(wbar, 0);
      weights = true;
    }
    int32_t* stage = reinterpret_cast<int32_t*>(k_s + s * STAGE_BYTES);
    if (row0 + TM > n) {
      // the ragged tile (the CTA's last): its stage from k5 with plain
      // loads, -1 past n
      const int64_t base = (int64_t)row0 * KVOL;
      const int64_t total = (int64_t)n * KVOL;
      for (int e = wtid; e < TM * KVOL; e += 128) {
        stage[e] = base + e < total ? k5[base + e] : -1;
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    }
    // the indices of offset 4 ks + t of rows r and r + 8
    const int32_t* src0 = stage + r * KVOL + t;
    auto index = [&](const int32_t* p, int ks) {
      return 4 * ks + t < KVOL ? p[4 * ks] : -1;
    };
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    uint32_t a[2][CHUNK][4];
#pragma unroll
    for (int ch = 0; ch < KSTEPS / CHUNK; ++ch) {
      const int b = ch & 1;
      if (ch >= 2) {
        wgmma_wait<1>();  // chunk ch - 2, which read buffer b, is done
        fence_acc(acc);
      }
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const int ks = ch * CHUNK + i;
        const int v0 = index(src0, ks);
        const int v1 = index(src0 + 8 * KVOL, ks);
        const uint2 g0 = __ldg(xb + (v0 >= 0 ? v0 : n));
        const uint2 g1 = __ldg(xb + (v1 >= 0 ? v1 : n));
        a[b][i][0] = g0.x;
        a[b][i][1] = g1.x;
        a[b][i][2] = g0.y;
        a[b][i][3] = g1.y;
      }
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        const int ks = ch * CHUNK + i;
        // atom ks / 4 of 32 rows x 128 B, then 32 bytes per k16 step
        const uint64_t db = smem_desc(w_s + (ks >> 2) * (BN * 128) + (ks & 3) * 32, 16, 1024);
        wgmma_rs_bf16<BN, 0>(acc, a[b][i], db);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_acc(acc);
    // every thread's index reads fed the products just waited for
    if (wtid == 0) mbar_arrive(&empty[s]);
    store_tile<BN>(acc, y, cout, row0, n, ctile * BN, cout, wtid);
  }
}

}  // namespace

// The prep pass: x [n, 3] and w [125, 3, cout], each f32 or bf16 (`x_bf16`,
// `w_bf16`), into xb [n + 1, 4] bf16 and wimg, the weight image:
// ceil(cout / 32) * 512 * 32 bf16. All contiguous on the current device.
// Returns the CUDA error of the launch (0 = launched).
extern "C" int agile3d_banded_stem_prep(const void* x, const void* w, void* xb,
                                        void* wimg, int n, int cout, int x_bf16,
                                        int w_bf16, void* stream_ptr) {
  if (n <= 0 || cout <= 0) return 0;
  const int ctiles = (cout + BN - 1) / BN;
  const int64_t total = (int64_t)ctiles * (KSTEPS / 4) * BN * 8 + n + 1;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  with_dtype(x, x_bf16, [&](auto xp) {
    return with_dtype(w, w_bf16, [&](auto wp) {
      stem_prep_kernel<<<grid_for(total), 256, 0, stream>>>(
          xp, wp, static_cast<uint2*>(xb), static_cast<__nv_bfloat16*>(wimg), n, cout, ctiles);
      return 0;
    });
  });
  return static_cast<int>(cudaGetLastError());
}

// y [n, cout] f32 from the prep pass's xb and wimg and k5 [n, 125] i32
// (16-byte aligned, contiguous). Returns the CUDA error of the launch (0 =
// launched).
extern "C" int agile3d_banded_stem(const void* xb, const void* k5, const void* wimg,
                                   void* y, int n, int cout, void* stream_ptr) {
  if ((reinterpret_cast<uintptr_t>(k5) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || cout <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(banded_stem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  // persistent CTAs: one per SM over the column tiles, none without a tile
  const int ctiles = (cout + BN - 1) / BN;
  const int ntiles = (n + TM - 1) / TM;
  const int per_col = sms / ctiles > 1 ? sms / ctiles : 1;
  const dim3 grid(ntiles < per_col ? ntiles : per_col, ctiles);
  banded_stem_kernel<<<grid, STHREADS, SMEM, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<const uint2*>(xb), static_cast<const int32_t*>(k5),
      static_cast<const __nv_bfloat16*>(wimg), static_cast<float*>(y), n, cout);
  return static_cast<int>(cudaGetLastError());
}
