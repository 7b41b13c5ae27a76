// Row gather from a table held in the distributed shared memory of a
// thread-block cluster, for Hopper (sm_90a).
//
//   out[i, :] = x[idx[i], :],  x [w, c] f32 spread over a cluster of 16 CTAs
//
// Replaces tools/probe_vmem_gather.py::gather_kernel and ::gather_kernel_ta,
// the TPU probe's two lowering forms (jnp.take and take_along_axis) of one
// function: a row gather from a table resident in VMEM. On the H100 the
// shared memory of a cluster plays VMEM's part: 16 CTAs on neighbouring SMs
// (the non-portable size) each hold ceil(w / 16) rows, so a table of up to
// 16 x 227 KB fits, the TPU probe's 4,096 x 128 f32 (2 MB) among them. 16
// was timed against 1, 2, 4 and 8 on the H100: it is the fastest at the
// 384-row table too, since each SM loads less of the table before its
// first store.
//
// Bound on the H100: no arithmetic, so bytes: the table read once, the
// indices read once and the output written once (3.35 TB/s).
//
// Design:
//  * each CTA bulk-loads its slice of the table once (cp.async.bulk into
//    one mbarrier), then a cluster barrier: a cluster reads the table from
//    device memory (L2) once, and each SM takes in only 1 / 16 of it;
//  * a warp owns a run of at least 16 output rows: lane l loads the index
//    of row l of a 32-row group (the first group's before the cluster
//    barrier), a shuffle hands each row's index to the warp, and the 32
//    lanes move the row as 16-byte pieces from the owning CTA's shared
//    memory (mapa + ld.shared::cluster.v4), 2 rows in flight per lane, with
//    coalesced stores; one division per row, none per piece; 512-thread
//    CTAs, several to an SM where the slices are small (the sizes were
//    timed against 128-1024 threads, 2-16 rows in flight and 2-32 rows per
//    warp on the H100);
//  * the grid is as many clusters as the card holds at once
//    (cudaOccupancyMaxActiveClusters), fewer when the rows are few;
//  * no CTA exits while a peer may still read its shared memory: the
//    kernel ends with a second cluster barrier.
// An index outside [0, w) writes a zero row (the plain version raises).

#include "common.cuh"

namespace {

constexpr int CLUSTER = 16;            // CTAs a table is spread over
constexpr int GATHER_THREADS = 512;
constexpr int WARPS = GATHER_THREADS / 32;
constexpr int UNROLL = 2;              // rows a lane has in flight
constexpr int MIN_ROWS_PER_WARP = 16;  // below it the grid shrinks
constexpr int BAR_BYTES = 16;         // the mbarrier, ahead of the slice
constexpr uint32_t CHUNK = 65536;     // bytes per bulk copy

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of the same shared-memory offset in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr)
               : "memory");
  return v;
}

// `per` rows of the table per CTA; the grid is a whole number of clusters
__global__ void __launch_bounds__(GATHER_THREADS)
cluster_row_gather_kernel(const float4* __restrict__ x,
                          const int32_t* __restrict__ idx,
                          float4* __restrict__ out, int w, int c4, int64_t m,
                          int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float4* slice = reinterpret_cast<float4*>(smem + BAR_BYTES);
  const int tid = threadIdx.x;
  const uint32_t rank = cluster_rank();

  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
    const int r0 = static_cast<int>(rank) * per;
    const int rows = max(0, min(per, w - r0));
    const uint32_t bytes = static_cast<uint32_t>(rows) * c4 * 16;
    mbar_expect_tx(bar, bytes);
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(x + (int64_t)r0 * c4);
    for (uint32_t off = 0; off < bytes; off += CHUNK) {
      bulk_copy(reinterpret_cast<unsigned char*>(slice) + off, src + off,
                min(CHUNK, bytes - off), bar);
    }
  }
  // the warp's rows, and the indices of its first 32, ahead of the wait
  const int lane = tid & 31;
  const int64_t warps = (int64_t)gridDim.x * WARPS;
  const int64_t gw = (int64_t)blockIdx.x * WARPS + (tid >> 5);
  const int64_t span = (m + warps - 1) / warps;
  const int64_t r_end = (gw + 1) * span < m ? (gw + 1) * span : m;
  const int64_t g0 = gw * span;
  int mine = g0 + lane < r_end ? __ldg(idx + g0 + lane) : 0;
  const uint32_t base = smem_u32(slice) + lane * 16;
  const uint32_t row_bytes = static_cast<uint32_t>(c4) * 16;

  __syncthreads();
  mbar_wait(bar, 0);
  cluster_sync();  // every slice of the cluster has landed

  for (int64_t g = g0; g < r_end; g += 32) {
    const int cnt = r_end - g < 32 ? static_cast<int>(r_end - g) : 32;
    if (g != g0) mine = lane < cnt ? __ldg(idx + g + lane) : 0;
    for (int j0 = 0; j0 < cnt; j0 += UNROLL) {
      uint32_t addr[UNROLL];
      bool ok[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = __shfl_sync(0xffffffffu, mine, j0 + u);
        ok[u] = j0 + u < cnt && static_cast<unsigned>(i) < static_cast<unsigned>(w);
        const int owner = ok[u] ? i / per : 0;
        const int local = ok[u] ? i - owner * per : 0;
        addr[u] = map_rank(base + local * row_bytes, owner);
      }
      for (int q = lane; q < c4; q += 32) {
        float4 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          v[u] = ok[u] ? ld_cluster(addr[u] + (q - lane) * 16)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (j0 + u < cnt) out[(g + j0 + u) * c4 + q] = v[u];
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may read its slice
}

}  // namespace

// x [w, c] f32 (16-byte aligned, c a multiple of 4), idx [m] i32, out
// [m, c] f32, all contiguous on the current device; each CTA of a 16-CTA
// cluster holds ceil(w / 16) rows in at most 227 KB. Returns the CUDA
// error of the launch (0 = launched).
extern "C" int agile3d_smem_row_gather(const void* x, const void* idx,
                                       void* out, int w, int c, int64_t m,
                                       void* stream) {
  if (w <= 0 || c <= 0 || c % 4 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int per = (w + CLUSTER - 1) / CLUSTER;
  const int64_t smem = BAR_BYTES + (int64_t)per * c * sizeof(float);
  if (smem > SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (m <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      cluster_row_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(cluster_row_gather_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(GATHER_THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, cluster_row_gather_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t rows_per_cluster =
      (int64_t)CLUSTER * WARPS * MIN_ROWS_PER_WARP;
  const int64_t want = (m + rows_per_cluster - 1) / rows_per_cluster;
  cfg.gridDim = dim3(static_cast<unsigned>(CLUSTER * (want < fit ? want : fit)));
  err = cudaLaunchKernelEx(&cfg, cluster_row_gather_kernel,
                           static_cast<const float4*>(x),
                           static_cast<const int32_t*>(idx),
                           static_cast<float4*>(out), w, c / 4, m, per);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
