// Boundary distances of every row, for Hopper (sm_90a):
//
//   d[b, i] = sqrt(max(min_{j : valid[b, j], cl[b, j] != cl[b, i]}
//                      ((0 + dx dx) + dy dy) + dz dz, 0)),
//   (dx, dy, dz) = c[b, i] - c[b, j];  d = inf where no j qualifies
//
// The port's own kernel for an XLA fusion, not for a TPU kernel: it replaces
// agile3d_tpu/engine/device_eval.py::_boundary_distances_all, whose per-axis
// differences, mask and min XLA fuses into one pass over each 512-row chunk.
// The device click rollout (eval and training) calls it once per round.
//
// Exactness: the next click is the first row attaining the largest
// distance, so one ulp moves a click. d^2 is summed in the plain version's
// order with __fsub_rn / __fmul_rn / __fadd_rn, which nvcc does not
// contract into FMAs; the min is exact in any order, so key chunks reduce
// through an integer atomicMin on the (non-negative) f32 bits; the square
// root comes last (__fsqrt_rn). The result equals the plain version bit
// for bit.
//
// Bound on the H100: operations. 8 FP32 operations per (row, valid key)
// pair on the CUDA cores (66.9 TFLOP/s, counting an FMA as two); the bytes
// (coords, cluster ids, valid flags and d, once each) are a few MB.
//
// Design (three launches per call):
//  * prep: the valid keys of each batch item are packed into 16-byte
//    records {x, y, z, cluster} (warp-aggregated compaction: the order is
//    free, since a min does not depend on it), their count is kept, and d
//    is set to +inf; invalid and padded rows cost nothing afterwards;
//  * main: a CTA holds 1,024 query rows, 4 per thread in registers, and
//    streams a chunk of 2,048 keys through shared memory in 512-record
//    tiles, double-buffered with cp.async; every thread reads the same
//    record (a broadcast) and keeps its 4 running minima; grid (key chunk,
//    query block, batch item), so the work splits evenly over the SMs;
//    chunks past the item's key count exit at once. A tile whose records
//    are all of one cluster (the common case: rows are sorted, clusters
//    are spatial) takes the min without the per-pair test, and a thread
//    whose queries are all of that cluster skips it: pairs within a
//    cluster need no distance. (Sizes timed on the H100 against 2-16 rows
//    per thread and 2,048-8,192-key chunks, with and without that path.)
//  * finish: d = sqrt(max(d^2, 0)) in place.

#include "common.cuh"

namespace {

constexpr int DIST_THREADS = 256;
constexpr int QPT = 4;                    // query rows per thread
constexpr int QBLOCK = DIST_THREADS * QPT;     // query rows per CTA
constexpr int TILE = 512;                 // key records per shared-memory tile
constexpr int KCHUNK = 2048;              // keys per CTA
constexpr uint32_t INF_BITS = 0x7f800000u;

__global__ void __launch_bounds__(DIST_THREADS)
pack_keys_kernel(const float* __restrict__ coords,
                 const int32_t* __restrict__ cluster,
                 const uint8_t* __restrict__ valid, float4* __restrict__ keys,
                 int32_t* __restrict__ count, uint32_t* __restrict__ d2,
                 int n) {
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int64_t base = (int64_t)b * n;
  const int n32 = (n + 31) & ~31;  // a warp-uniform loop bound
  for (int e = blockIdx.x * DIST_THREADS + threadIdx.x; e < n32;
       e += gridDim.x * DIST_THREADS) {
    const bool in = e < n && valid[base + e] != 0;
    const unsigned mask = __ballot_sync(0xffffffffu, in);
    int first = 0;
    if (lane == 0 && mask != 0) first = atomicAdd(count + b, __popc(mask));
    first = __shfl_sync(0xffffffffu, first, 0);
    if (in) {
      const float* c = coords + (base + e) * 3;
      keys[base + first + __popc(mask & ((1u << lane) - 1))] =
          make_float4(c[0], c[1], c[2], __int_as_float(cluster[base + e]));
    }
    if (e < n) d2[base + e] = INF_BITS;
  }
}

__global__ void __launch_bounds__(DIST_THREADS)
boundary_dist_kernel(const float* __restrict__ coords,
                     const int32_t* __restrict__ cluster,
                     const float4* __restrict__ keys,
                     const int32_t* __restrict__ count,
                     uint32_t* __restrict__ d2, int n) {
  __shared__ __align__(16) float4 tile[2][TILE];
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * KCHUNK;
  const int nk = count[b];
  if (k0 >= nk) return;
  const int k1 = k0 + KCHUNK < nk ? k0 + KCHUNK : nk;
  const int64_t base = (int64_t)b * n;
  const int tid = threadIdx.x;

  float qx[QPT], qy[QPT], qz[QPT], best[QPT];
  int qt[QPT];
#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int i = blockIdx.y * QBLOCK + q * DIST_THREADS + tid;
    const int ii = i < n ? i : n - 1;
    const float* c = coords + (base + ii) * 3;
    qx[q] = c[0];
    qy[q] = c[1];
    qz[q] = c[2];
    qt[q] = cluster[base + ii];
    best[q] = __int_as_float(INF_BITS);
  }

  const float4* src = keys + base;
  auto load = [&](int t, int buf) {
    const int t0 = k0 + t * TILE;
    for (int r = tid; r < TILE; r += DIST_THREADS) {
      if (t0 + r < k1) cp_async16(&tile[buf][r], src + t0 + r, 16);
    }
  };
  const int tiles = (k1 - k0 + TILE - 1) / TILE;
  load(0, 0);
  cp_async_commit();
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) load(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float4* kt = tile[t & 1];
    const int cnt = k1 - (k0 + t * TILE) < TILE ? k1 - (k0 + t * TILE) : TILE;
    // a tile of one cluster (rows are sorted, so most are): the min
    // without the per-pair test, skipped by a thread whose queries are all
    // of that cluster
    const int tag0 = __float_as_int(kt[0].w);
    bool same = true;
    for (int r = tid; r < cnt; r += DIST_THREADS) {
      same &= __float_as_int(kt[r].w) == tag0;
    }
    if (__syncthreads_and(same)) {
      bool need = false;
#pragma unroll
      for (int q = 0; q < QPT; ++q) need |= qt[q] != tag0;
      if (need) {
        float tmin[QPT];
#pragma unroll
        for (int q = 0; q < QPT; ++q) tmin[q] = __int_as_float(INF_BITS);
#pragma unroll 2
        for (int r = 0; r < cnt; ++r) {
          const float4 k = kt[r];
#pragma unroll
          for (int q = 0; q < QPT; ++q) {
            const float dx = __fsub_rn(qx[q], k.x);
            const float dy = __fsub_rn(qy[q], k.y);
            const float dz = __fsub_rn(qz[q], k.z);
            tmin[q] = fminf(tmin[q], __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                         __fmul_rn(dy, dy)),
                                               __fmul_rn(dz, dz)));
          }
        }
#pragma unroll
        for (int q = 0; q < QPT; ++q) {
          best[q] = qt[q] != tag0 ? fminf(best[q], tmin[q]) : best[q];
        }
      }
    } else {
#pragma unroll 2
      for (int r = 0; r < cnt; ++r) {
        const float4 k = kt[r];
        const int tag = __float_as_int(k.w);
#pragma unroll
        for (int q = 0; q < QPT; ++q) {
          const float dx = __fsub_rn(qx[q], k.x);
          const float dy = __fsub_rn(qy[q], k.y);
          const float dz = __fsub_rn(qz[q], k.z);
          const float s = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                              __fmul_rn(dy, dy)),
                                    __fmul_rn(dz, dz));
          best[q] = tag != qt[q] ? fminf(best[q], s) : best[q];
        }
      }
    }
    __syncthreads();  // the tile is free for the load two steps on
  }

#pragma unroll
  for (int q = 0; q < QPT; ++q) {
    const int i = blockIdx.y * QBLOCK + q * DIST_THREADS + tid;
    const uint32_t bits = __float_as_uint(best[q]);
    if (i < n && bits < INF_BITS) atomicMin(d2 + base + i, bits);
  }
}

__global__ void finish_kernel(float* __restrict__ d, int64_t total) {
  for (int64_t e = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * blockDim.x) {
    d[e] = __fsqrt_rn(fmaxf(d[e], 0.f));
  }
}

}  // namespace

// coords [b, n, 3] f32, cluster [b, n] i32, valid [b, n] bool (one byte),
// contiguous on the current device; keys [b, n] 16-byte records and count
// [b] i32 (zeroed) are scratch; out [b, n] f32. Returns the CUDA error of
// the launches (0 = launched).
extern "C" int agile3d_boundary_dist(const void* coords, const void* cluster,
                                     const void* valid, void* keys,
                                     void* count, void* out, int b, int n,
                                     void* stream) {
  if (b <= 0 || n <= 0 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pack_blocks = (n + DIST_THREADS - 1) / DIST_THREADS < 264
                              ? (n + DIST_THREADS - 1) / DIST_THREADS : 264;
  pack_keys_kernel<<<dim3(pack_blocks, b), DIST_THREADS, 0, s>>>(
      static_cast<const float*>(coords), static_cast<const int32_t*>(cluster),
      static_cast<const uint8_t*>(valid), static_cast<float4*>(keys),
      static_cast<int32_t*>(count), static_cast<uint32_t*>(out), n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + KCHUNK - 1) / KCHUNK, (n + QBLOCK - 1) / QBLOCK, b);
  boundary_dist_kernel<<<grid, DIST_THREADS, 0, s>>>(
      static_cast<const float*>(coords), static_cast<const int32_t*>(cluster),
      static_cast<const float4*>(keys), static_cast<const int32_t*>(count),
      static_cast<uint32_t*>(out), n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = (int64_t)b * n;
  finish_kernel<<<grid_for(total), 256, 0, s>>>(static_cast<float*>(out),
                                                 total);
  return static_cast<int>(cudaGetLastError());
}
