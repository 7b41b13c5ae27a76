// Boundary distances of the query rows, for Hopper (sm_90a):
//
//   d[b, i] = sqrt(max(min_{j : valid[b, j], cl[b, j] != cl[b, i]}
//                      ((0 + dx dx) + dy dy) + dz dz, 0)),
//   (dx, dy, dz) = c[b, i] - c[b, j];  d = inf where no j qualifies
//
// for every row i with query[b, i] (every row when query is null); the
// other rows hold +inf. The port's own kernel for an XLA fusion, not for a
// TPU kernel: it replaces agile3d_tpu/engine/device_eval.py::
// _boundary_distances_all, whose per-axis differences, mask and min XLA
// fuses into one pass over each 512-row chunk. The device click rollout
// (eval and training) calls it once per round, for the error rows only:
// the callers read d nowhere else.
//
// Exactness: the next click is the first row attaining the largest
// distance, so one ulp moves a click. d^2 is summed in the plain version's
// order with __fsub_rn / __fmul_rn / __fadd_rn, which nvcc does not
// contract into FMAs; the min is exact in any order; the square root comes
// last (__fsqrt_rn). The result equals the plain version bit for bit.
//
// Bound on the H100: an all-pairs kernel does ~10 FP32 issue slots per
// (query, valid key) pair (3 differences, 3 products, 2 sums, a min and a
// select), which puts an eval round of the smoke scene near 5 ms whatever
// its design. So this one evaluates fewer pairs, and skips none that could
// change a bit:
//
//  * Culling. Rows come sorted by packed (batch, x, y, z) key, so a tile of
//    32 consecutive valid rows has a tight box. A warp holds 32 consecutive
//    query rows (row order kept), one a lane, and their running minima. It
//    skips a tile when, for each lane, the lower bound of d^2 between the
//    lane's query point and the tile's box is >= the lane's minimum (or the
//    tile is of the query's own cluster), voted warp-wide with __all_sync;
//    a lane without a query votes "skip".
//    The bound is computed with the same rounded operations in the same
//    order as a pair's d^2: per axis gap = max(0, q_lo (-) k_hi,
//    k_lo (-) q_hi), then (gx (*) gx (+) gy (*) gy) (+) gz (*) gz. Rounding
//    to nearest is monotone and odd, so for q in [q_lo, q_hi] and k in
//    [k_lo, k_hi], |q (-) k| >= gap on each axis, its square >= gap's
//    square, and each sum >= the bound's sum: the bound is <= the computed
//    d^2 of every pair of the two boxes. A skipped tile has d^2 >= the
//    lane's minimum, and fminf(m, d^2) = m: the minimum's bits cannot
//    change. (d^2 is never -0: a product of equal signs is +0 or more.)
//    The culling relies on that order, which build_pyramid enforces on
//    every pyramid the callers use (it raises on unsorted rows); rows in
//    any other order stay exact but cull nearly nothing, and then the
//    kernel takes about twice the time of an all-pairs kernel with a key
//    split (chip_smoke.py's "ragged" case).
//  * Seeding. A warp first visits the tiles around its own position in the
//    key order (its first query's, +-SEED tiles, nearest first), so that
//    the minima are small before the sweep; then it sweeps the remaining
//    tiles in groups of 32, outward from that group: each lane tests one
//    tile of the group against the box of the warp's queries and their
//    largest minimum, a ballot gives the candidates, and each candidate
//    gets the per-lane test above, with the minima as they are by then,
//    before it is loaded.
//  * Only the error rows: queries are compacted in row order, so each
//    warp's queries stay spatially close and the warps full.
//
// Launches per call: a count pass (rows per 1,024-row chunk, d = +inf), an
// order-keeping compaction (a block scan at each chunk's offset) of the
// valid rows into 16-byte key records {x, y, z, cluster} and of the query
// rows into (row, key position) pairs, the tiles' boxes, and the main pass.
// No atomics on d: each warp owns its queries across all keys, so it
// writes their square roots itself. An optional counter (null on the main
// path) adds up the (query, key) pairs evaluated, for the share of the
// all-pairs work that the culling left.

#include "common.cuh"

#define BD_INF __int_as_float(0x7f800000)

namespace {

constexpr int TILE = 32;                  // key records per tile: one a lane
constexpr int SEED = 4;                   // tiles each side of a warp's own
                                          // tile, visited first
constexpr int WARPS = 4;                  // query groups per CTA (main pass)
constexpr int QGROUP = 32;                // query rows per warp: one a lane
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_RPT = 4;               // consecutive rows per thread
constexpr int CHUNK = SCAN_THREADS * SCAN_RPT;  // rows per scan CTA
constexpr int BOX_WARPS = 8;              // tiles per CTA (box pass)

struct Scratch {
  float4* keys;     // [b, n] valid rows' records, row order kept
  float4* box;      // [b, tiles, 2] {lo xyz, tag}, {hi xyz, uniform}
  int32_t* qrow;    // [b, n] query rows, in row order
  int32_t* qkey;    // [b, n] key position of each query row
  int32_t* vcnt;    // [b, chunks] valid rows per chunk
  int32_t* qcnt;    // [b, chunks] query rows per chunk
  int32_t* kcount;  // [b] valid rows
  int32_t* qcount;  // [b] query rows
};

inline int64_t align256(int64_t v) { return (v + 255) & ~int64_t(255); }

// Scratch layout (bytes from the start) for b items of n rows; the total
// is the last offset.
inline void scratch_offsets(int b, int n, int64_t off[9]) {
  const int64_t bn = (int64_t)b * n;
  const int64_t tiles = (n + TILE - 1) / TILE;
  const int64_t chunks = (n + CHUNK - 1) / CHUNK;
  const int64_t sizes[8] = {bn * 16, b * tiles * 32, bn * 4, bn * 4,
                            b * chunks * 4, b * chunks * 4, b * 4, b * 4};
  off[0] = 0;
  for (int i = 0; i < 8; ++i) off[i + 1] = off[i] + align256(sizes[i]);
}

__device__ __forceinline__ bool is_query(const uint8_t* query, int64_t e) {
  return query == nullptr || query[e] != 0;
}

__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int w = threadIdx.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[w] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < SCAN_THREADS / 32; ++i) s += red[i];
  return s;
}

// Pass 1: valid and query rows per chunk; d = +inf on every row.
__global__ void __launch_bounds__(SCAN_THREADS)
count_kernel(const uint8_t* __restrict__ valid,
             const uint8_t* __restrict__ query, Scratch s,
             float* __restrict__ out, int n, int chunks) {
  const int b = blockIdx.y, c = blockIdx.x;
  const int64_t base = (int64_t)b * n;
  int cv = 0, cq = 0;
  for (int r = threadIdx.x; r < CHUNK; r += SCAN_THREADS) {
    const int i = c * CHUNK + r;
    if (i < n) {
      cv += valid[base + i] != 0;
      cq += is_query(query, base + i);
      out[base + i] = BD_INF;
    }
  }
  __shared__ int red[SCAN_THREADS / 32];
  cv = block_sum(cv, red);
  cq = block_sum(cq, red);
  if (threadIdx.x == 0) {
    s.vcnt[(int64_t)b * chunks + c] = cv;
    s.qcnt[(int64_t)b * chunks + c] = cq;
  }
}

// Pass 2: the order-keeping compaction. Each CTA adds up the counts of the
// chunks before its own, then scans its rows (4 consecutive a thread).
__global__ void __launch_bounds__(SCAN_THREADS)
compact_kernel(const float* __restrict__ coords,
               const int32_t* __restrict__ cluster,
               const uint8_t* __restrict__ valid,
               const uint8_t* __restrict__ query, Scratch s, int n,
               int chunks) {
  const int b = blockIdx.y, c = blockIdx.x;
  const int64_t base = (int64_t)b * n;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __shared__ int red[SCAN_THREADS / 32];
  __shared__ int wv[SCAN_THREADS / 32], wq[SCAN_THREADS / 32];
  int ov = 0, oq = 0;
  for (int j = threadIdx.x; j < c; j += SCAN_THREADS) {
    ov += s.vcnt[(int64_t)b * chunks + j];
    oq += s.qcnt[(int64_t)b * chunks + j];
  }
  ov = block_sum(ov, red);
  oq = block_sum(oq, red);

  const int i0 = c * CHUNK + threadIdx.x * SCAN_RPT;
  bool fv[SCAN_RPT], fq[SCAN_RPT];
  int tv = 0, tq = 0;
#pragma unroll
  for (int r = 0; r < SCAN_RPT; ++r) {
    const int i = i0 + r;
    fv[r] = i < n && valid[base + i] != 0;
    fq[r] = i < n && is_query(query, base + i);
    tv += fv[r];
    tq += fq[r];
  }
  int iv = tv, iq = tq;  // inclusive scans over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int av = __shfl_up_sync(0xffffffffu, iv, o);
    const int aq = __shfl_up_sync(0xffffffffu, iq, o);
    if (lane >= o) {
      iv += av;
      iq += aq;
    }
  }
  if (lane == 31) {
    wv[w] = iv;
    wq[w] = iq;
  }
  __syncthreads();
  int pv = ov + iv - tv, pq = oq + iq - tq;
  int totv = 0, totq = 0;
#pragma unroll
  for (int k = 0; k < SCAN_THREADS / 32; ++k) {
    if (k < w) {
      pv += wv[k];
      pq += wq[k];
    }
    totv += wv[k];
    totq += wq[k];
  }
#pragma unroll
  for (int r = 0; r < SCAN_RPT; ++r) {
    const int i = i0 + r;
    if (fq[r]) {
      s.qrow[base + pq] = i;
      s.qkey[base + pq] = pv;  // the key position of row i (or the next)
      ++pq;
    }
    if (fv[r]) {
      const float* p = coords + (base + i) * 3;
      s.keys[base + pv] =
          make_float4(p[0], p[1], p[2], __int_as_float(cluster[base + i]));
      ++pv;
    }
  }
  if (c == chunks - 1 && threadIdx.x == 0) {
    s.kcount[b] = ov + totv;
    s.qcount[b] = oq + totq;
  }
}

// Pass 3: each tile's box over its present records and whether its records
// are of one cluster (then lo.w is that cluster).
__global__ void __launch_bounds__(BOX_WARPS * 32)
box_kernel(Scratch s, int n, int tiles) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * BOX_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const int nk = s.kcount[b];
  if (t >= tiles || t * TILE >= nk) return;  // warp-uniform
  const int64_t base = (int64_t)b * n;
  const bool have = t * TILE + lane < nk;
  const float4 r = have ? s.keys[base + t * TILE + lane]
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  float lx = have ? r.x : BD_INF, ly = have ? r.y : BD_INF,
        lz = have ? r.z : BD_INF;
  float hx = have ? r.x : -BD_INF, hy = have ? r.y : -BD_INF,
        hz = have ? r.z : -BD_INF;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, o));
    ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, o));
    lz = fminf(lz, __shfl_xor_sync(0xffffffffu, lz, o));
    hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, o));
    hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, o));
    hz = fmaxf(hz, __shfl_xor_sync(0xffffffffu, hz, o));
  }
  const int tag0 = __shfl_sync(0xffffffffu, __float_as_int(r.w), 0);
  const bool one = __all_sync(0xffffffffu,
                              !have || __float_as_int(r.w) == tag0);
  if (lane == 0) {
    float4* o = s.box + ((int64_t)b * tiles + t) * 2;
    o[0] = make_float4(lx, ly, lz, __int_as_float(tag0));
    o[1] = make_float4(hx, hy, hz, __int_as_float(one ? 1 : 0));
  }
}

// The lower bound of d^2 between two boxes, rounded as a pair's d^2 is.
__device__ __forceinline__ float box_bound(float qlx, float qly, float qlz,
                                           float qhx, float qhy, float qhz,
                                           const float4& kl,
                                           const float4& kh) {
  const float gx =
      fmaxf(0.f, fmaxf(__fsub_rn(qlx, kh.x), __fsub_rn(kl.x, qhx)));
  const float gy =
      fmaxf(0.f, fmaxf(__fsub_rn(qly, kh.y), __fsub_rn(kl.y, qhy)));
  const float gz =
      fmaxf(0.f, fmaxf(__fsub_rn(qlz, kh.z), __fsub_rn(kl.z, qhz)));
  return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                   __fmul_rn(gz, gz));
}

// Pass 4: one warp per group of QGROUP consecutive query rows, across all
// the item's keys.
__global__ void __launch_bounds__(WARPS * 32)
dist_kernel(const float* __restrict__ coords,
            const int32_t* __restrict__ cluster, Scratch s,
            float* __restrict__ out, int n, int tiles,
            unsigned long long* __restrict__ pairs) {
  __shared__ __align__(16) float4 stile[WARPS][TILE];
  const int b = blockIdx.y;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = (blockIdx.x * WARPS + w) * QGROUP;
  const int nq = s.qcount[b];
  if (q0 >= nq) return;  // warp-uniform
  const int nk = s.kcount[b];
  const int ntiles = (nk + TILE - 1) / TILE;
  const int64_t base = (int64_t)b * n;
  const float4* keys = s.keys + base;
  const float4* box = s.box + (int64_t)b * tiles * 2;

  // this lane's query row
  const bool active = q0 + lane < nq;
  const int qr = active ? s.qrow[base + q0 + lane] : 0;
  const float qx = coords[(base + qr) * 3];
  const float qy = coords[(base + qr) * 3 + 1];
  const float qz = coords[(base + qr) * 3 + 2];
  const int qt = cluster[base + qr];
  float best = BD_INF;
  // the warp's box over its queries, and whether they are of one cluster
  float wlx = active ? qx : BD_INF, wly = active ? qy : BD_INF,
        wlz = active ? qz : BD_INF;
  float whx = active ? qx : -BD_INF, why = active ? qy : -BD_INF,
        whz = active ? qz : -BD_INF;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    wlx = fminf(wlx, __shfl_xor_sync(0xffffffffu, wlx, o));
    wly = fminf(wly, __shfl_xor_sync(0xffffffffu, wly, o));
    wlz = fminf(wlz, __shfl_xor_sync(0xffffffffu, wlz, o));
    whx = fmaxf(whx, __shfl_xor_sync(0xffffffffu, whx, o));
    why = fmaxf(why, __shfl_xor_sync(0xffffffffu, why, o));
    whz = fmaxf(whz, __shfl_xor_sync(0xffffffffu, whz, o));
  }
  const int wtag = __shfl_sync(0xffffffffu, qt, 0);
  const bool wone = __all_sync(0xffffffffu, !active || qt == wtag);
  const int nreal = min(QGROUP, nq - q0);
  unsigned long long evaluated = 0;

  // true when no pair of this lane's query with the tile can lower its
  // minimum (a lane without a query: true)
  auto lane_skips = [&](const float4& kl, const float4& kh) {
    if (!active) return true;
    if (__float_as_int(kh.w) != 0 && __float_as_int(kl.w) == qt) return true;
    return box_bound(qx, qy, qz, qx, qy, qz, kl, kh) >= best;
  };
  auto visit = [&](int t) {
    const int k0 = t * TILE;
    const int cnt = min(TILE, nk - k0);
    if (lane < cnt) stile[w][lane] = keys[k0 + lane];
    __syncwarp();
    // the pair's d^2 into the running minimum
    auto pair = [&](const float4& k) {
      const float dx = __fsub_rn(qx, k.x);
      const float dy = __fsub_rn(qy, k.y);
      const float dz = __fsub_rn(qz, k.z);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                           __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      best = __float_as_int(k.w) != qt ? fminf(best, d2) : best;
    };
    if (cnt == TILE) {
#pragma unroll 8
      for (int r = 0; r < TILE; ++r) pair(stile[w][r]);
    } else {
      for (int r = 0; r < cnt; ++r) pair(stile[w][r]);
    }
    __syncwarp();
    if (pairs != nullptr) evaluated += (unsigned long long)cnt * nreal;
  };

  // seeding: the warp's own tile, then its neighbours, nearest first
  const int tq = min(s.qkey[base + q0] / TILE, ntiles - 1);
  const int slo = max(0, tq - SEED), shi = min(ntiles - 1, tq + SEED);
  for (int i = 0; i <= 2 * SEED; ++i) {
    const int t = tq + ((i & 1) ? (i + 1) / 2 : -(i / 2));
    if (t < slo || t > shi) continue;
    const float4 kl = box[2 * t], kh = box[2 * t + 1];
    if (!__all_sync(0xffffffffu, lane_skips(kl, kh))) visit(t);
  }
  // the sweep: groups of 32 tiles, outward from the warp's own group
  const int groups = (ntiles + 31) / 32;
  const int gq = tq / 32;
  for (int i = 0; i < 2 * groups; ++i) {
    const int g = gq + ((i & 1) ? (i + 1) / 2 : -(i / 2));
    if (g < 0 || g >= groups) continue;
    float wmax = active ? best : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      wmax = fmaxf(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
    const int t = g * 32 + lane;
    float4 kl = make_float4(0.f, 0.f, 0.f, 0.f), kh = kl;
    bool cand = t < ntiles && (t < slo || t > shi);
    if (cand) {
      kl = box[2 * t];
      kh = box[2 * t + 1];
      cand = !(wone && __float_as_int(kh.w) != 0
               && __float_as_int(kl.w) == wtag)
             && box_bound(wlx, wly, wlz, whx, why, whz, kl, kh) < wmax;
    }
    unsigned mask = __ballot_sync(0xffffffffu, cand);
    while (mask != 0) {
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      auto from = [&](const float4& v) {
        return make_float4(__shfl_sync(0xffffffffu, v.x, src),
                           __shfl_sync(0xffffffffu, v.y, src),
                           __shfl_sync(0xffffffffu, v.z, src),
                           __shfl_sync(0xffffffffu, v.w, src));
      };
      const float4 cl = from(kl), ch = from(kh);
      if (!__all_sync(0xffffffffu, lane_skips(cl, ch))) visit(g * 32 + src);
    }
  }

  if (active) out[base + qr] = __fsqrt_rn(fmaxf(best, 0.f));
  if (pairs != nullptr && lane == 0) atomicAdd(pairs, evaluated);
}

}  // namespace

// Bytes of scratch that a call on b items of n rows needs.
extern "C" int64_t agile3d_boundary_dist_scratch(int b, int n) {
  int64_t off[9];
  scratch_offsets(b, n, off);
  return off[8];
}

// coords [b, n, 3] f32, cluster [b, n] i32, valid [b, n] and query [b, n]
// bool (one byte; query null = every row), contiguous on the current
// device; scratch: agile3d_boundary_dist_scratch(b, n) bytes, 256-byte
// aligned; out [b, n] f32; pairs: null, or a u64 that the call adds the
// evaluated (query, key) pairs to. Returns the CUDA error of the launches
// (0 = launched).
extern "C" int agile3d_boundary_dist(const void* coords, const void* cluster,
                                     const void* valid, const void* query,
                                     void* scratch, void* out, int b, int n,
                                     void* pairs, void* stream) {
  if (b <= 0 || n <= 0 || b > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int64_t off[9];
  scratch_offsets(b, n, off);
  char* base = static_cast<char*>(scratch);
  Scratch s{reinterpret_cast<float4*>(base + off[0]),
            reinterpret_cast<float4*>(base + off[1]),
            reinterpret_cast<int32_t*>(base + off[2]),
            reinterpret_cast<int32_t*>(base + off[3]),
            reinterpret_cast<int32_t*>(base + off[4]),
            reinterpret_cast<int32_t*>(base + off[5]),
            reinterpret_cast<int32_t*>(base + off[6]),
            reinterpret_cast<int32_t*>(base + off[7])};
  const auto* c = static_cast<const float*>(coords);
  const auto* cl = static_cast<const int32_t*>(cluster);
  const auto* v = static_cast<const uint8_t*>(valid);
  const auto* q = static_cast<const uint8_t*>(query);
  auto* o = static_cast<float*>(out);
  const int chunks = (n + CHUNK - 1) / CHUNK;
  const int tiles = (n + TILE - 1) / TILE;

  count_kernel<<<dim3(chunks, b), SCAN_THREADS, 0, st>>>(v, q, s, o, n,
                                                        chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_kernel<<<dim3(chunks, b), SCAN_THREADS, 0, st>>>(c, cl, v, q, s, n,
                                                          chunks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  box_kernel<<<dim3((tiles + BOX_WARPS - 1) / BOX_WARPS, b), BOX_WARPS * 32,
               0, st>>>(s, n, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = (n + QGROUP - 1) / QGROUP;
  dist_kernel<<<dim3((groups + WARPS - 1) / WARPS, b), WARPS * 32, 0, st>>>(
      c, cl, s, o, n, tiles, static_cast<unsigned long long*>(pairs));
  return static_cast<int>(cudaGetLastError());
}
