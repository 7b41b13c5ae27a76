// Banded k3 sparse convolution for Hopper (sm_90a).
//
//   y[i, :] = sum_{j < k} bf16(x[nbr[i, j], :]) @ bf16(w[j]),  f32 accumulation
//
// nbr[i, j] == -1 contributes 0, so rows whose neighbours are all absent
// (the pad rows of a bucket) come out exactly 0.
//
// Replaces the JAX package's ops/banded_conv.py::_make_kernel (the Mosaic
// kernel that gathers rows through one-hot band matmuls, because Mosaic has
// no row gather from VMEM). Here each block gathers its rows straight from
// device memory by index, so there is no window plan and no exception list.
//
// Bound on the H100: at cin = 128 or 96, cout = 96 the function does
// 2 * cin * cout = 18-25 kFLOP per present neighbour against one gathered
// row of 2 * cin bytes (bf16), ~96 FLOP per gathered byte. The gathers
// mostly hit L2 (neighbours of consecutive rows are near each other in the
// sorted row order), so the floor is the bf16 tensor-core rate; what a
// simple kernel loses to is the latency of the dependent gathers.
//
// Design: two passes.
//  1. cast_rows / cast_weights: x -> bf16 rows padded to cinp (a multiple
//     of 32 channels), w -> bf16 [k][cout][cinp] (each output column's
//     weights contiguous in cin). This halves the gathered bytes and lets
//     the main pass copy 16-byte pieces of rows straight into shared memory.
//  2. conv: a block owns BM = 128 output rows and BN <= 128 output columns
//     (blockIdx.y tiles wider outputs). It stages its rows' k neighbour
//     indices in shared memory once, then walks (offset j, 32-channel slice)
//     steps through a 4-stage cp.async pipeline: each stage gathers 128
//     neighbour rows (zero-filled where the index is -1) and the matching
//     slice of w[j]^T. 8 warps (4 along rows x 2 along columns) load
//     fragments with ldmatrix and run mma.sync m16n8k16 (bf16 in, f32
//     accumulate); the accumulators stay in registers across all offsets.
// No TMA or wgmma yet: gathered rows do not form the dense tiles those
// want without a sorted-band staging step, which is later work.
//
// The backward of the conv (training) is two calls into this file:
//  * dX = conv(g, nbr, flip(w, 0)^T) through agile3d_banded_conv itself:
//    for a stride-1 cubic stencil on one coordinate set, offset j's map
//    transposed is offset k-1-j's map.
//  * dW through agile3d_banded_conv_dw, below:
//
//      dw[j] = sum_m bf16(x[nbr[m, j]])^T @ bf16(g[m]),  f32 accumulation
//
//    It replaces the JAX package's ops/banded_conv.py::_make_dw_kernel,
//    which carries the [k * cin, cout] sum in VMEM across its sequential
//    grid. Blocks on the H100 run in no order, so the sum over m is split:
//    a block owns (offset j, a chunk of up to DW_CHUNK rows, a 128 x BN
//    tile of dw[j]), gathers its chunk's neighbour rows of x as bf16 and
//    the matching rows of g through the same 4-stage cp.async pipeline
//    (zero-fill for -1 and past the end), runs mma.sync m16n8k16 with the
//    rows as the reduction axis (ldmatrix.trans turns both row-major tiles
//    into the A = x^T and B = g fragments), and writes one f32 partial per
//    chunk. A second pass sums the partials in chunk order, so the result
//    does not change from run to run (no atomics).
//    Bound: the same products as the forward (2 * cin * cout per present
//    neighbour), so the floor is the bf16 tensor-core rate again; what the
//    partials add is k * cin * cout * 4 B per chunk written and read once.
//    Blocks are numbered with j fastest, so the 27 blocks of one chunk run
//    together and share its rows of g, nbr and x in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;             // output rows per block
constexpr int KC = 32;              // input channels per pipeline stage
constexpr int LDS = KC + 8;         // smem row stride (bf16, 80 B): conflict-free ldmatrix
constexpr int STAGES = 4;
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = WARPS_M * WARPS_N * 32;
constexpr int WM = BM / WARPS_M;    // 32 rows per warp
constexpr int MT = WM / 16;         // m16 tiles per warp

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

template <int NT>  // n8 tiles per warp: the block covers BN = WARPS_N * NT * 8 columns
__global__ void __launch_bounds__(THREADS, 2)
banded_conv_kernel(const __nv_bfloat16* __restrict__ xb,
                   const int32_t* __restrict__ nbr,
                   const __nv_bfloat16* __restrict__ wt, float* __restrict__ y,
                   int n, int k, int cinp, int cout) {
  constexpr int BN = WARPS_N * NT * 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDS]
  __nv_bfloat16* b_s = a_s + STAGES * BM * LDS;                 // [STAGES][BN][LDS]
  int32_t* rows_s = reinterpret_cast<int32_t*>(b_s + STAGES * BN * LDS);  // [BM][k]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  // the block's neighbour indices: one contiguous run of BM * k ints
  const int64_t base = (int64_t)row0 * k;
  const int64_t total = (int64_t)n * k;
  for (int e = tid; e < BM * k; e += THREADS) {
    rows_s[e] = base + e < total ? nbr[base + e] : -1;
  }
  __syncthreads();

  const int nchunks = cinp / KC;
  const int iters = k * nchunks;

  auto load_stage = [&](int it, int slot) {
    const int j = it / nchunks;
    const int c0 = (it - j * nchunks) * KC;
    __nv_bfloat16* as = a_s + slot * BM * LDS;
    __nv_bfloat16* bs = b_s + slot * BN * LDS;
    // BM gathered rows x KC channels, 16 B (8 channels) per copy; an absent
    // neighbour copies 0 bytes and zero-fills
    for (int e = tid; e < BM * (KC / 8); e += THREADS) {
      const int r = e >> 2;
      const int q = e & 3;
      const int src = rows_s[r * k + j];
      const __nv_bfloat16* g = xb + (int64_t)max(src, 0) * cinp + c0 + q * 8;
      cp_async16(as + r * LDS + q * 8, g, src >= 0 ? 16 : 0);
    }
    // BN output columns x KC channels of w[j]^T
    for (int e = tid; e < BN * (KC / 8); e += THREADS) {
      const int o = e >> 2;
      const int q = e & 3;
      const int col = col0 + o;
      const __nv_bfloat16* g =
          wt + ((int64_t)j * cout + min(col, cout - 1)) * cinp + c0 + q * 8;
      cp_async16(bs + o * LDS + q * 8, g, col < cout ? 16 : 0);
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

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }

  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();  // stage `it` has landed (for this thread)
    __syncthreads();              // ... for every thread; slot it-1 is free
    const int nxt = it + STAGES - 1;
    if (nxt < iters) load_stage(nxt, nxt % STAGES);
    cp_async_commit();

    const int slot = it % STAGES;
    const __nv_bfloat16* as = a_s + slot * BM * LDS + (wm * WM) * LDS;
    const __nv_bfloat16* bs = b_s + slot * BN * LDS + (wn * NT * 8) * LDS;
#pragma unroll
    for (int ks = 0; ks < KC; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // matrices: rows 0-7 / 8-15 of the m16 tile at k 0-7, then at k 8-15
        ldmatrix_x4(af[mt], as + (mt * 16 + (lane & 15)) * LDS + ks + (lane >> 4) * 8);
      }
      const int m = lane >> 3;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // matrices: n-tile 2np at k 0-7 / 8-15, then n-tile 2np+1
        uint32_t bf[4];
        ldmatrix_x4(bf, bs + (np * 16 + (m >> 1) * 8 + (lane & 7)) * LDS + ks + (m & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
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
int launch_conv(const __nv_bfloat16* xb, const int32_t* nbr,
                const __nv_bfloat16* wt, float* y, int n, int k, int cinp,
                int cout, cudaStream_t stream) {
  constexpr int BN = WARPS_N * NT * 8;
  const size_t smem = (size_t)STAGES * (BM + BN) * LDS * sizeof(__nv_bfloat16)
                      + (size_t)BM * k * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      banded_conv_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n + BM - 1) / BM, (cout + BN - 1) / BN);
  banded_conv_kernel<NT><<<grid, THREADS, smem, stream>>>(xb, nbr, wt, y, n, k,
                                                           cinp, cout);
  return static_cast<int>(cudaGetLastError());
}

int grid_for(int64_t total) {
  const int64_t blocks = (total + 255) / 256;
  return static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
}

constexpr int DW_KR = 32;        // reduction rows (m) per pipeline stage
constexpr int DW_CHUNK = 8192;   // most rows per block; their indices sit in smem
constexpr int DW_LDX = BM + 8;   // x-tile row stride (bf16): conflict-free ldmatrix

// part[chunk, j, c, o] = sum over the chunk's rows m of
//   bf16(x[nbr[m, j], c]) * bf16(g[m, o])
// for the block's 128 channels c (blockIdx.z % ctiles) and BN columns o.
template <int NT>
__global__ void __launch_bounds__(THREADS, 2)
banded_conv_dw_kernel(const __nv_bfloat16* __restrict__ xb,
                      const int32_t* __restrict__ nbr,
                      const __nv_bfloat16* __restrict__ gb,
                      float* __restrict__ part, int n, int k, int cin,
                      int cinp, int cout, int coutp, int chunk) {
  constexpr int BN = WARPS_N * NT * 8;
  constexpr int LDG = BN + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][KR][LDX]
  __nv_bfloat16* g_s = x_s + STAGES * DW_KR * DW_LDX;           // [STAGES][KR][LDG]
  int32_t* rows_s = reinterpret_cast<int32_t*>(g_s + STAGES * DW_KR * LDG);  // [chunk]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int j = blockIdx.x;
  const int ch = blockIdx.y;
  const int ctiles = (cinp + BM - 1) / BM;
  const int c0 = (blockIdx.z % ctiles) * BM;
  const int o0 = (blockIdx.z / ctiles) * BN;
  const int m0 = ch * chunk;
  const int rows = min(chunk, n - m0);

  // the chunk's neighbour rows under offset j (a strided column of nbr;
  // the other offsets' blocks read the same lines)
  for (int e = tid; e < rows; e += THREADS) {
    rows_s[e] = nbr[(int64_t)(m0 + e) * k + j];
  }
  __syncthreads();

  const int iters = (rows + DW_KR - 1) / DW_KR;

  auto load_stage = [&](int it, int slot) {
    const int r0 = it * DW_KR;
    __nv_bfloat16* xs = x_s + slot * DW_KR * DW_LDX;
    __nv_bfloat16* gs = g_s + slot * DW_KR * LDG;
    // KR gathered rows x 128 channels, 16 B (8 channels) per copy
    for (int e = tid; e < DW_KR * (BM / 8); e += THREADS) {
      const int r = e / (BM / 8);
      const int q = e % (BM / 8);
      const int m = r0 + r;
      const int src = m < rows ? rows_s[m] : -1;
      const int c = c0 + q * 8;
      const bool ok = src >= 0 && c < cinp;
      const __nv_bfloat16* p =
          xb + (int64_t)max(src, 0) * cinp + (ok ? c : 0);
      cp_async16(xs + r * DW_LDX + q * 8, p, ok ? 16 : 0);
    }
    // the same KR rows of g, BN columns
    for (int e = tid; e < DW_KR * (BN / 8); e += THREADS) {
      const int r = e / (BN / 8);
      const int q = e % (BN / 8);
      const int m = r0 + r;
      const int col = o0 + q * 8;
      const bool ok = m < rows && col < coutp;
      const __nv_bfloat16* p =
          gb + (int64_t)(ok ? m0 + m : 0) * coutp + (ok ? col : 0);
      cp_async16(gs + r * LDG + q * 8, p, ok ? 16 : 0);
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

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < iters) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix.trans addressing: lane t points at row t & 7 of matrix t >> 3
  const int mat = lane >> 3;
  const int mrow = lane & 7;
  for (int it = 0; it < iters; ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = it + STAGES - 1;
    if (nxt < iters) load_stage(nxt, nxt % STAGES);
    cp_async_commit();

    const int slot = it % STAGES;
    const __nv_bfloat16* xs = x_s + slot * DW_KR * DW_LDX + wm * WM;
    const __nv_bfloat16* gs = g_s + slot * DW_KR * LDG + wn * NT * 8;
#pragma unroll
    for (int ks = 0; ks < DW_KR; ks += 16) {
      uint32_t af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // A = x^T: matrices (channels 0-7 / 8-15) x (rows 0-7), then rows 8-15
        ldmatrix_x4_trans(af[mt], xs + (ks + (mat >> 1) * 8 + mrow) * DW_LDX
                                      + mt * 16 + (mat & 1) * 8);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        // B = g: n-tile 2np at rows 0-7 / 8-15, then n-tile 2np+1
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, gs + (ks + (mat & 1) * 8 + mrow) * LDG
                                  + np * 16 + (mat >> 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int grp = lane >> 2;
  const int tig = lane & 3;
  float* out = part + ((int64_t)ch * k + j) * cin * cout;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int o = o0 + wn * NT * 8 + nt * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + wm * WM + mt * 16 + grp + h * 8;
        if (c < cin) {
          float* row = out + (int64_t)c * cout;
          if (o < cout) row[o] = acc[mt][nt][2 * h];
          if (o + 1 < cout) row[o + 1] = acc[mt][nt][2 * h + 1];
        }
      }
    }
  }
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

template <int NT>
int launch_dw(const __nv_bfloat16* xb, const int32_t* nbr,
              const __nv_bfloat16* gb, float* part, int n, int k, int cin,
              int cinp, int cout, int coutp, int chunk, cudaStream_t stream) {
  constexpr int BN = WARPS_N * NT * 8;
  const size_t smem =
      (size_t)STAGES * DW_KR * (DW_LDX + BN + 8) * sizeof(__nv_bfloat16)
      + (size_t)chunk * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      banded_conv_dw_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctiles = (cinp + BM - 1) / BM;
  const int otiles = (cout + BN - 1) / BN;
  const dim3 grid(k, (n + chunk - 1) / chunk, ctiles * otiles);
  banded_conv_dw_kernel<NT><<<grid, THREADS, smem, stream>>>(
      xb, nbr, gb, part, n, k, cin, cinp, cout, coutp, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [n, cin] f32, nbr [n, k] i32, w [k, cin, cout] f32, y [n, cout] f32;
// scratch xb [n, cinp] bf16 and wt [k, cout, cinp] bf16 with cinp a
// multiple of 32 and >= cin. All contiguous on the current device. Returns
// the CUDA error of the launches (0 = launched).
extern "C" int agile3d_banded_conv(const void* x, const void* nbr,
                                   const void* w, void* y, void* xb, void* wt,
                                   int n, int k, int cin, int cinp, int cout,
                                   void* stream_ptr) {
  if (cinp % KC != 0 || cinp < cin || k <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0 || cout <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* xbp = static_cast<__nv_bfloat16*>(xb);
  auto* wtp = static_cast<__nv_bfloat16*>(wt);
  cast_rows_kernel<<<grid_for((int64_t)n * cinp), 256, 0, stream>>>(
      static_cast<const float*>(x), xbp, n, cin, cinp);
  cast_weights_kernel<<<grid_for((int64_t)k * cout * cinp), 256, 0, stream>>>(
      static_cast<const float*>(w), wtp, k, cin, cinp, cout);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* nb = static_cast<const int32_t*>(nbr);
  auto* yp = static_cast<float*>(y);
  if (cout <= 32) return launch_conv<2>(xbp, nb, wtp, yp, n, k, cinp, cout, stream);
  if (cout <= 64) return launch_conv<4>(xbp, nb, wtp, yp, n, k, cinp, cout, stream);
  if (cout <= 96) return launch_conv<6>(xbp, nb, wtp, yp, n, k, cinp, cout, stream);
  return launch_conv<8>(xbp, nb, wtp, yp, n, k, cinp, cout, stream);
}

// x [n, cin] f32, nbr [n, k] i32, g [n, cout] f32, dw [k, cin, cout] f32;
// scratch xb [n, cinp] bf16, gb [n, coutp] bf16 (cinp, coutp multiples of
// 8, >= cin, cout) and part [ceil(n / chunk), k, cin, cout] f32, with
// 32 <= chunk <= 8192. All contiguous on the current device. Returns the
// CUDA error of the launches (0 = launched).
extern "C" int agile3d_banded_conv_dw(const void* x, const void* nbr,
                                      const void* g, void* dw, void* xb,
                                      void* gb, void* part, int n, int k,
                                      int cin, int cinp, int cout, int coutp,
                                      int chunk, void* stream_ptr) {
  if (cinp % 8 != 0 || cinp < cin || coutp % 8 != 0 || coutp < cout
      || k <= 0 || chunk < DW_KR || chunk > DW_CHUNK) {
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
  auto* gbp = static_cast<__nv_bfloat16*>(gb);
  cast_rows_kernel<<<grid_for((int64_t)n * cinp), 256, 0, stream>>>(
      static_cast<const float*>(x), xbp, n, cin, cinp);
  cast_rows_kernel<<<grid_for((int64_t)n * coutp), 256, 0, stream>>>(
      static_cast<const float*>(g), gbp, n, cout, coutp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* nb = static_cast<const int32_t*>(nbr);
  auto* pp = static_cast<float*>(part);
  int rc;
  if (cout <= 32) {
    rc = launch_dw<2>(xbp, nb, gbp, pp, n, k, cin, cinp, cout, coutp, chunk, stream);
  } else if (cout <= 64) {
    rc = launch_dw<4>(xbp, nb, gbp, pp, n, k, cin, cinp, cout, coutp, chunk, stream);
  } else if (cout <= 96) {
    rc = launch_dw<6>(xbp, nb, gbp, pp, n, k, cin, cinp, cout, coutp, chunk, stream);
  } else {
    rc = launch_dw<8>(xbp, nb, gbp, pp, n, k, cin, cinp, cout, coutp, chunk, stream);
  }
  if (rc != 0) return rc;
  const int nparts = (n + chunk - 1) / chunk;
  sum_partials_kernel<<<grid_for(per), 256, 0, stream>>>(
      pp, static_cast<float*>(dw), per, nparts);
  return static_cast<int>(cudaGetLastError());
}
