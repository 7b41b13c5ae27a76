// The port's native host runtime: voxel quantization and the pyramid's
// kernel maps, in C++ (the port's own copy of the JAX package's native
// sparse-index runtime, the three entries its default host prep calls).
//
// An open-addressing hash map over packed (batch, x, y, z) keys gives the
// first-occurrence voxel dedup; neighbour lookups run as sorted co-scans.
// The packed key layout is agile3d_torch/sparse/quantize.py::pack_coords's
// (19 bits per signed coordinate, batch above bit 57), so this path and
// the numpy one give the same arrays bit for bit.
//
// Loaded with ctypes by agile3d_torch/sparse/native.py, which builds it at
// first use:
//   g++ -O3 -std=c++17 -shared -fPIC sparse_index.cpp -o libsparse_index.so
// (an ISO -std: g++ then contracts no floating-point expression, so the
// quantize's float64 division rounds as written.)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int COORD_BITS = 19;
constexpr int64_t COORD_OFFSET = 1LL << (COORD_BITS - 1);
constexpr int64_t COORD_MAX = (1LL << COORD_BITS) - 1;
constexpr uint64_t EMPTY = ~0ULL;
// a guard band at the field edges, so that adding a small kernel offset to
// a packed key never carries into the next field (the co-scans add offsets
// to packed keys)
constexpr int64_t MARGIN = 4;

inline uint64_t mix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

// The packed key, or -1 outside the packable range.
inline int64_t pack(int32_t b, int32_t x, int32_t y, int32_t z) {
  const int64_t px = (int64_t)x + COORD_OFFSET;
  const int64_t py = (int64_t)y + COORD_OFFSET;
  const int64_t pz = (int64_t)z + COORD_OFFSET;
  if (px < MARGIN || px > COORD_MAX - MARGIN || py < MARGIN ||
      py > COORD_MAX - MARGIN || pz < MARGIN || pz > COORD_MAX - MARGIN)
    return -1;
  return ((int64_t)b << (3 * COORD_BITS)) | (px << (2 * COORD_BITS)) |
         (py << COORD_BITS) | pz;
}

// Open addressing, linear probing: key -> the first row stored for it.
struct IndexMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;

  explicit IndexMap(size_t n) {
    size_t cap = 16;
    while (cap < 2 * n) cap <<= 1;
    keys.assign(cap, EMPTY);
    vals.assign(cap, -1);
    mask = cap - 1;
  }

  // Stores `row` if the key is absent; returns the row stored for it.
  int32_t insert(uint64_t key, int32_t row) {
    uint64_t h = mix64(key) & mask;
    for (;;) {
      if (keys[h] == EMPTY) {
        keys[h] = key;
        vals[h] = row;
        return row;
      }
      if (keys[h] == key) return vals[h];
      h = (h + 1) & mask;
    }
  }
};

// Provisional ids sorted by packed key: order[r] = the id of sorted rank
// r, rank[p] = the sorted rank of id p.
void sort_ranks(const std::vector<int64_t>& prov_key,
                std::vector<int32_t>& order, std::vector<int32_t>& rank) {
  const int64_t n = (int64_t)prov_key.size();
  order.resize((size_t)n);
  rank.resize((size_t)n);
  for (int64_t i = 0; i < n; ++i) order[i] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return prov_key[a] < prov_key[b];
  });
  for (int64_t r = 0; r < n; ++r) rank[order[r]] = (int32_t)r;
}

}  // namespace

extern "C" {

// Points to voxels: vox rows sorted by packed key (z fastest), unique_map[r]
// = the first point (in point order) of voxel r, inverse_map[i] = point
// i's voxel. coords [n, 3] row-major float32, divided in float64. vox must
// hold n rows; the first n_unique are used. Returns n_unique, or -1 on a
// coordinate outside the packable range.
int64_t agile3d_quantize(const float* coords, int64_t n, double qsize,
                         int32_t* vox, int64_t* unique_map,
                         int64_t* inverse_map) {
  IndexMap map((size_t)n);
  std::vector<int32_t> vx(3 * n);
  for (int64_t i = 0; i < 3 * n; ++i)
    vx[i] = (int32_t)std::floor((double)coords[i] / qsize);
  std::vector<int64_t> prov_key, prov_first;
  prov_key.reserve((size_t)n);
  prov_first.reserve((size_t)n);
  int64_t n_unique = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t key = pack(0, vx[3 * i], vx[3 * i + 1], vx[3 * i + 2]);
    if (key < 0) return -1;
    const int32_t row = map.insert((uint64_t)key, (int32_t)n_unique);
    if (row == (int32_t)n_unique) {
      prov_key.push_back(key);
      prov_first.push_back(i);
      ++n_unique;
    }
    inverse_map[i] = row;  // a provisional id until the sort below
  }
  std::vector<int32_t> order, rank;
  sort_ranks(prov_key, order, rank);
  for (int64_t r = 0; r < n_unique; ++r) {
    const int64_t src = prov_first[order[r]];
    vox[3 * r + 0] = vx[3 * src + 0];
    vox[3 * r + 1] = vx[3 * src + 1];
    vox[3 * r + 2] = vx[3 * src + 2];
    unique_map[r] = src;
  }
  for (int64_t i = 0; i < n; ++i) inverse_map[i] = rank[inverse_map[i]];
  return n_unique;
}

// out[i * k + j] = the row at grid[i] + offsets[j] of the same batch item,
// else -1. A sorted co-scan per offset instead of hash probes: for a fixed
// offset every wanted key is the same shift of a sorted sequence.
//  * Rows sorted by packed key (every pyramid level): no sort; each run of
//    offsets with the same (dx, dy) and consecutive dz (consecutive packed
//    keys: z is the low field, and MARGIN guards the carry) shares one
//    co-scan pointer, and rows are written in row-major order.
//  * Otherwise: (key, row) pairs sorted first, then a co-scan per offset.
// Returns 0, or -1 on a coordinate outside the packable range.
int64_t agile3d_neighbor_map(const int32_t* grid, const int32_t* batch,
                             int64_t n, const int32_t* offsets, int64_t k,
                             int32_t* out) {
  std::vector<int64_t> keys((size_t)n);
  bool is_sorted = true;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t key =
        pack(batch[i], grid[3 * i], grid[3 * i + 1], grid[3 * i + 2]);
    if (key < 0) return -1;
    keys[i] = key;
    if (i > 0 && key <= keys[i - 1]) is_sorted = false;
  }
  auto delta = [&](int64_t j) {
    return (int64_t)offsets[3 * j] * (1LL << (2 * COORD_BITS)) +
           (int64_t)offsets[3 * j + 1] * (1LL << COORD_BITS) +
           (int64_t)offsets[3 * j + 2];
  };

  if (is_sorted) {
    struct Run {
      int64_t j0, m, d;
    };
    std::vector<Run> runs;
    for (int64_t j = 0; j < k; ++j) {
      if (!runs.empty()) {
        Run& g = runs.back();
        const int64_t p = g.j0 + g.m - 1;
        if (offsets[3 * j] == offsets[3 * p] &&
            offsets[3 * j + 1] == offsets[3 * p + 1] &&
            offsets[3 * j + 2] == offsets[3 * p + 2] + 1) {
          ++g.m;
          continue;
        }
      }
      runs.push_back({j, 1, delta(j)});
    }
    std::vector<int64_t> t(runs.size(), 0);
    for (int64_t q = 0; q < n; ++q) {
      int32_t* orow = out + q * k;
      for (size_t gi = 0; gi < runs.size(); ++gi) {
        const Run& g = runs[gi];
        const int64_t want = keys[q] + g.d;
        int64_t& tg = t[gi];
        while (tg < n && keys[tg] < want) ++tg;
        int64_t p = tg;  // absent cells inside the run: scan on from here
        for (int64_t i = 0; i < g.m; ++i) {
          const int64_t w = want + i;
          while (p < n && keys[p] < w) ++p;
          orow[g.j0 + i] = (p < n && keys[p] == w) ? (int32_t)p : -1;
        }
      }
    }
    return 0;
  }

  struct KeyRow {
    int64_t key;
    int32_t row;
  };
  std::vector<KeyRow> sorted((size_t)n);
  for (int64_t i = 0; i < n; ++i) sorted[i] = {keys[i], (int32_t)i};
  std::sort(sorted.begin(), sorted.end(),
            [](const KeyRow& a, const KeyRow& b) { return a.key < b.key; });
  for (int64_t j = 0; j < k; ++j) {
    const int64_t d = delta(j);
    int64_t t = 0;
    for (int64_t q = 0; q < n; ++q) {
      const int64_t want = sorted[q].key + d;
      while (t < n && sorted[t].key < want) ++t;
      out[(int64_t)sorted[q].row * k + j] =
          (t < n && sorted[t].key == want) ? sorted[t].row : -1;
    }
  }
  return 0;
}

// One stride-2 step: the coarse grid floor(g / 2), sorted by packed key
// (floor does not keep the lexicographic order, so the level is sorted
// again), each fine row's parent and kernel-2 element (x slowest, as
// kernel_offsets(2)), and down[coarse * 8 + element] = the fine row, -1
// where absent. Every output holds n rows; the first n_coarse of the
// coarse ones are used. Returns n_coarse, or -1 outside the packable range.
int64_t agile3d_stride_down(const int32_t* grid, const int32_t* batch,
                            int64_t n, int32_t* coarse_grid,
                            int32_t* coarse_batch, int32_t* parent,
                            int32_t* child_off, int32_t* down) {
  IndexMap map((size_t)n);
  std::vector<int64_t> prov_key, prov_first;
  prov_key.reserve((size_t)n);
  prov_first.reserve((size_t)n);
  int64_t n_coarse = 0;
  for (int64_t i = 0; i < n; ++i) {
    // an arithmetic shift: floor division for negatives too (numpy's >>)
    const int32_t cx = grid[3 * i] >> 1, cy = grid[3 * i + 1] >> 1,
                  cz = grid[3 * i + 2] >> 1;
    const int64_t key = pack(batch[i], cx, cy, cz);
    if (key < 0) return -1;
    const int32_t row = map.insert((uint64_t)key, (int32_t)n_coarse);
    if (row == (int32_t)n_coarse) {
      prov_key.push_back(key);
      prov_first.push_back(i);
      ++n_coarse;
    }
    parent[i] = row;  // a provisional id until the sort below
    child_off[i] = ((grid[3 * i] & 1) << 2) | ((grid[3 * i + 1] & 1) << 1) |
                   (grid[3 * i + 2] & 1);
  }
  std::vector<int32_t> order, rank;
  sort_ranks(prov_key, order, rank);
  for (int64_t r = 0; r < n_coarse; ++r) {
    const int64_t src = prov_first[order[r]];
    coarse_grid[3 * r + 0] = grid[3 * src] >> 1;
    coarse_grid[3 * r + 1] = grid[3 * src + 1] >> 1;
    coarse_grid[3 * r + 2] = grid[3 * src + 2] >> 1;
    coarse_batch[r] = batch[src];
  }
  for (int64_t i = 0; i < n; ++i) parent[i] = rank[parent[i]];
  for (int64_t j = 0; j < n_coarse * 8; ++j) down[j] = -1;
  for (int64_t i = 0; i < n; ++i)
    down[(int64_t)parent[i] * 8 + child_off[i]] = (int32_t)i;
  return n_coarse;
}

}  // extern "C"
