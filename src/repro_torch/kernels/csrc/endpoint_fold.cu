// Live walk-endpoint fold in one summation order.
//
//   out[b, t] = sum_i w[b,i] * [pos[b,i] == t]
//
// pos (B, W) int32 holds each walk lane's endpoint, weights (B, W) float32
// its weight (r_sum / active on the active lanes, 0 beyond). Built with
// nvcc into a shared library with a plain C interface and called through
// ctypes from repro_torch/kernels/endpoint_fold.py, which checks every
// argument first.
//
// This is the JAX package's segment_sum of the live walk phase
// (repro/ppr/random_walk.py, residual_walks and source_walks), an XLA op,
// not a Pallas kernel; the port's plain version is index_add_, which sums
// with float atomics on a card, so its last bits changed from run to run.
// Here a cell's sum has five levels, each added in lane order: its lanes
// within a 32-lane chunk, the chunk sums within a group of 32 chunks (1,024
// lanes), the group sums within a tile of kTile lanes, the tile sums within
// a group of 32 tiles, and those groups' sums. The order is fixed by the
// cell's own lanes, not by the grid, so a second launch gives the same
// bits, and a hub that every lane reaches rounds at most 31 times a level
// (about 115 adds at W = 2^22: 6.9e-6 of the sum of its weights, under the
// check's 1e-5) instead of once a lane. No float atomics. A lane of weight
// 0 (past its row's active walks) or with pos outside [0, n) takes no part;
// adding 0 changes no bit of a sum of nonnegative terms.
//
// 1. sort_tiles, one 1,024-thread block a tile of kTile = 8,192 lanes of
//    one row. Warp w takes the tile's chunks 8w..8w+7; in each, a lane's
//    cell is grouped with its peers by __match_any_sync and the first lane
//    of each cell keeps the cell and the chunk's sum in lane order (as K3's
//    gather_cells). The tile's entries are then sorted by the key (cell,
//    slot), the slot being the entry's lane in the tile, which names its
//    value (the value stays in place): a bitonic sort whose keys stay in
//    registers, thread (w, lane) holding positions 256 w + 32 k + lane,
//    which is the slot of its k-th chunk's entry. Strides 1-16 are warp
//    shuffles, 32-128 swaps of a thread's own keys, and only the 15 stages
//    of strides 256-4,096 go through shared memory, each warp on
//    consecutive words. Keys are 32 bits where n < 2^19 (then a cell and a
//    slot fit), else 64. The first entry of each cell's run adds the run's
//    values in slot order, group by group, and the tile writes its sorted
//    cells (-1 but at the run's head) and sums, and where each bucket of
//    kRange cells begins among them, bucket-major. A tile with no kept
//    entry (all its lanes past the active walks) writes only empty buckets.
// 2. fold_buckets, one block a bucket of kRange = 512 cells of one row: it
//    loads its runs' bounds for up to kWindow tiles at once; then for each
//    group of 32 tiles, each tile's run of the bucket (its cells are
//    distinct) goes to a table of (tile in group, cell) in shared memory,
//    with a bit of the cell's mask, a warp loading 4 steps of 32 entries at
//    once; then a thread a cell adds its tiles' sums in tile order (the set
//    bits, lowest first) into the group's sum, and the group's sum into the
//    cell's total. The block writes each cell of its bucket once, zeros
//    included: no memset.
//
// What bounds it on the H100: bytes. The function reads pos and the weights
// once (8 bytes a lane) and writes the (B, n) output once; it adds one
// float a lane. This design adds the tiles' scratch (8 bytes a lane, written
// once, read once) and the bucket table (4 bytes a bucket and tile), and a
// tile's sort 30 barriers. index_add_ reads the same inputs but, on the
// paper path's hub, serialises its atomics on one address.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8192;                 // lanes a sort block folds
constexpr int kSortThreads = 1024;
constexpr int kPer = kTile / kSortThreads;  // keys a thread holds: 8
constexpr int kSlotBits = 13;               // log2(kTile)
constexpr int kGroupBits = 10;              // 32 chunks: 1,024 lanes
constexpr int kWarpSpan = 32 * kPer;        // positions a warp holds: 256
constexpr int kRange = 512;                 // cells a fold block owns
constexpr int kFoldThreads = kRange;
constexpr int kTileGroup = 32;              // tiles a fold group, one bit each
constexpr int kWindow = 256;                // tiles whose bounds a block holds
constexpr int kSteps = 4;                   // run steps a warp loads at once
constexpr int kSmallN = 1 << (32 - kSlotBits);  // n below it: 32-bit keys

template <typename Key>
struct SortShared {
  Key key[kTile];                   // (cell << kSlotBits) | slot, or none
  float value[kTile];               // by slot: the chunk's sum of its cell
};

struct FoldShared {
  float table[kTileGroup * kRange];  // (tile in group, cell) sums
  unsigned mask[kRange];             // per cell: tiles of the group present
  float total[kRange];               // per cell: closed groups' sum
  int first[kWindow];                // per tile of the window: its run
  int end[kWindow];                  //   of this bucket
};

// The key of no entry, above every real key.
template <typename Key>
__device__ __forceinline__ Key no_key() {
  return static_cast<Key>(~static_cast<Key>(0));
}

template <typename Key>
__device__ __forceinline__ int cell_of(Key key) {
  return static_cast<int>(key >> kSlotBits);
}

__device__ __forceinline__ uint32_t shfl_xor_key(uint32_t x, int mask) {
  return __shfl_xor_sync(0xffffffffu, x, mask);
}

__device__ __forceinline__ unsigned long long shfl_xor_key(
    unsigned long long x, int mask) {
  const unsigned lo = __shfl_xor_sync(0xffffffffu,
                                      static_cast<unsigned>(x), mask);
  const unsigned hi = __shfl_xor_sync(0xffffffffu,
                                      static_cast<unsigned>(x >> 32), mask);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// The bitonic network's step for the key at position p, whose partner is
// at p ^ stride: the lower position of an ascending block keeps the min.
template <typename Key>
__device__ __forceinline__ Key bitonic_keep(Key a, Key b, int p, int size,
                                            int stride) {
  const bool up = (p & size) == 0;
  const bool lower = (p & stride) == 0;
  return (lower == up) ? (a < b ? a : b) : (a < b ? b : a);
}

// A stage whose partners are keys of one thread: key k pairs with k ^ S
// (positions base + 32 k, stride 32 S). S is a compile-time constant so
// the keys stay in registers.
template <int S, typename Key>
__device__ __forceinline__ void register_stage(Key (&v)[kPer], int base,
                                               int size) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    if ((k & S) == 0) {
      const bool up = ((base + 32 * k) & size) == 0;
      const Key a = v[k];
      const Key b = v[k | S];
      if ((a > b) == up) {
        v[k] = b;
        v[k | S] = a;
      }
    }
  }
}

// Bitonic sort of the tile's keys, ascending; thread (warp, lane) holds
// positions base + 32 k, base = 256 warp + lane. Leaves them in key[].
template <typename Key>
__device__ void sort_keys(Key (&v)[kPer], Key* key, int base) {
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= kWarpSpan) {
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kPer; ++k) key[base + 32 * k] = v[k];
        __syncthreads();
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int p = base + 32 * k;
          v[k] = bitonic_keep(v[k], key[p ^ stride], p, size, stride);
        }
      } else if (stride >= 32) {
        if (stride == 32) {
          register_stage<1>(v, base, size);
        } else if (stride == 64) {
          register_stage<2>(v, base, size);
        } else {
          register_stage<4>(v, base, size);
        }
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          const int p = base + 32 * k;
          v[k] = bitonic_keep(v[k], shfl_xor_key(v[k], stride), p, size,
                              stride);
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) key[base + 32 * k] = v[k];
  __syncthreads();
}

// Tile blockIdx.x of row blockIdx.y: lanes [t * kTile, (t + 1) * kTile).
template <typename Key>
__global__ void __launch_bounds__(kSortThreads)
sort_tiles(const int32_t* __restrict__ pos, const float* __restrict__ weights,
           int32_t* __restrict__ cells, float* __restrict__ sums,
           int32_t* __restrict__ starts, int n, int W, int tiles, int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  SortShared<Key>& sh = *reinterpret_cast<SortShared<Key>*>(smem);
  __shared__ int kept_total;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int base = warp * kWarpSpan + lane;   // position (and slot) of k = 0
  const int t = blockIdx.x;
  const long long in_row = static_cast<long long>(blockIdx.y) * W;
  const long long first_lane = static_cast<long long>(t) * kTile;
  const long long out_row =
      (static_cast<long long>(blockIdx.y) * tiles + t) * kTile;
  // bucket k's first entry in this tile: starts[(row * (nb + 1) + k) *
  // tiles + t], so a fold block reads its bucket's bounds contiguously
  int32_t* start = starts +
      static_cast<long long>(blockIdx.y) * (nb + 1) * tiles + t;
  if (tid == 0) kept_total = 0;

  // the warp's chunks: each cell's lanes of a chunk added in lane order by
  // the first of them, which keeps the entry; the others hold no key
  Key v[kPer];
  int cell[kPer];
  float x[kPer];
  int kept = 0;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = first_lane + base + 32 * k;
    cell[k] = -1;
    x[k] = 0.f;
    if (i < W) {
      const int p = pos[in_row + i];
      const float w = weights[in_row + i];
      if (w != 0.f && p >= 0 && p < n) {
        cell[k] = p;
        x[k] = w;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int slot = base + 32 * k;
    const unsigned peers = __match_any_sync(0xffffffffu, cell[k]);
    float s = 0.f;
    for (int j = 0; j < 32; ++j) {
      const float w = __shfl_sync(0xffffffffu, x[k], j);
      if ((peers >> j) & 1u) s += w;
    }
    const bool keep = cell[k] >= 0 && lane == __ffs(peers) - 1;
    v[k] = keep ? (static_cast<Key>(cell[k]) << kSlotBits)
                      | static_cast<Key>(slot)
                : no_key<Key>();
    sh.value[slot] = s;
    kept += keep;
  }
  __syncthreads();
  if (kept) atomicAdd(&kept_total, kept);
  if (!__syncthreads_or(kept)) {
    for (int k = tid; k <= nb; k += kSortThreads) {
      start[static_cast<long long>(k) * tiles] = 0;
    }
    return;
  }

  // sort the keys, ascending: entries of no cell go last
  sort_keys(v, sh.key, base);

  const int m = kept_total;
  for (int p = tid; p < m; p += kSortThreads) {
    const int c = cell_of(sh.key[p]);
    const int prev = p == 0 ? -1 : cell_of(sh.key[p - 1]);
    float total = 0.f;
    if (c != prev) {
      // the run's head adds the run: slots ascending, so chunks in order,
      // summed by group of 32 chunks, then the groups in order
      float group = 0.f;
      int g = 0;
      for (int q = p; q < m; ++q) {
        const Key key = sh.key[q];
        if (cell_of(key) != c) break;
        const int slot = static_cast<int>(key & (kTile - 1));
        if ((slot >> kGroupBits) != g) {
          total += group;
          group = 0.f;
          g = slot >> kGroupBits;
        }
        group += sh.value[slot];
      }
      total += group;
    }
    cells[out_row + p] = c != prev ? c : -1;
    sums[out_row + p] = total;
    // where each bucket of kRange cells begins among the sorted entries
    const int bucket = c / kRange;
    const int prev_bucket = p == 0 ? -1 : prev / kRange;
    for (int k = prev_bucket + 1; k <= bucket; ++k) {
      start[static_cast<long long>(k) * tiles] = p;
    }
    if (p == m - 1) {
      for (int k = bucket + 1; k <= nb; ++k) {
        start[static_cast<long long>(k) * tiles] = m;
      }
    }
  }
}

// Bucket blockIdx.x (cells [c0, c0 + kRange)) of row blockIdx.y.
__global__ void __launch_bounds__(kFoldThreads)
fold_buckets(const int32_t* __restrict__ cells,
             const float* __restrict__ sums,
             const int32_t* __restrict__ starts, float* __restrict__ out,
             int n, int tiles, int nb) {
  extern __shared__ __align__(16) unsigned char smem[];
  FoldShared& sh = *reinterpret_cast<FoldShared*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int k = blockIdx.x;
  const int c0 = k * kRange;
  const int ncell = min(kRange, n - c0);
  const long long row = static_cast<long long>(blockIdx.y) * tiles;
  const int32_t* bounds = starts +
      (static_cast<long long>(blockIdx.y) * (nb + 1) + k) * tiles;
  sh.mask[tid] = 0u;
  sh.total[tid] = 0.f;
  for (int g0 = 0; g0 < tiles; g0 += kTileGroup) {
    if (g0 % kWindow == 0) {
      // the next window's run bounds, all loads in flight at once
      __syncthreads();
      for (int j = tid; j < kWindow && g0 + j < tiles; j += kFoldThreads) {
        sh.first[j] = bounds[g0 + j];
        sh.end[j] = bounds[tiles + g0 + j];
      }
    }
    __syncthreads();
    // each tile's run of this bucket into the table: a tile holds a cell
    // once, so no two writes meet
    for (int j = warp; j < kTileGroup && g0 + j < tiles;
         j += kFoldThreads / 32) {
      const long long tile = row + g0 + j;
      const int w = (g0 % kWindow) + j;
      const int e = sh.end[w];
      for (int p0 = sh.first[w]; p0 < e; p0 += 32 * kSteps) {
        int cell[kSteps];
        float sum[kSteps];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          const int p = p0 + 32 * u + lane;
          cell[u] = p < e ? cells[tile * kTile + p] : -1;
          sum[u] = p < e ? sums[tile * kTile + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          if (cell[u] >= 0) {
            const int c = cell[u] - c0;
            sh.table[j * kRange + c] = sum[u];
            atomicOr(&sh.mask[c], 1u << j);
          }
        }
      }
    }
    __syncthreads();
    // a thread a cell: the group's tiles in order, then into the total
    unsigned bits = sh.mask[tid];
    if (bits) {
      float group = 0.f;
      while (bits) {
        const int j = __ffs(bits) - 1;
        group += sh.table[j * kRange + tid];
        bits &= bits - 1;
      }
      sh.total[tid] += group;
      sh.mask[tid] = 0u;
    }
    __syncthreads();
  }
  if (tid < ncell) {
    out[static_cast<long long>(blockIdx.y) * n + c0 + tid] = sh.total[tid];
  }
}

// A kernel's shared memory, and the whole carveout asked for, so that more
// than one block fits an SM (left to the CUDA runtime, it may size it for
// one).
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename Key>
cudaError_t launch_sort(const void* pos, const void* weights, void* cells,
                        void* sums, void* starts, int n, int W, int B,
                        int tiles, int nb, cudaStream_t s) {
  const int bytes = static_cast<int>(sizeof(SortShared<Key>));
  cudaError_t err = prepare(sort_tiles<Key>, bytes);
  if (err != cudaSuccess) return err;
  sort_tiles<Key><<<dim3(tiles, B), kSortThreads, bytes, s>>>(
      static_cast<const int32_t*>(pos), static_cast<const float*>(weights),
      static_cast<int32_t*>(cells), static_cast<float*>(sums),
      static_cast<int32_t*>(starts), n, W, tiles, nb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (B, n) f32; cells (B, tiles * kTile) i32, sums (B, tiles * kTile)
// f32 and starts (B, nb + 1, tiles) i32 are caller-allocated scratch;
// tiles = ceil(W / kTile), nb = ceil(n / kRange).
int endpoint_fold_launch(const void* pos, const void* weights, void* cells,
                         void* sums, void* starts, void* out, int n, int W,
                         int B, int tiles, int nb, void* stream) {
  if (n < 1 || W < 1 || B < 1 || B > 65535
      || tiles != (W + kTile - 1) / kTile
      || nb != (n + kRange - 1) / kRange) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = n < kSmallN
      ? launch_sort<uint32_t>(pos, weights, cells, sums, starts, n, W, B,
                              tiles, nb, s)
      : launch_sort<unsigned long long>(pos, weights, cells, sums, starts,
                                        n, W, B, tiles, nb, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bytes = static_cast<int>(sizeof(FoldShared));
  err = prepare(fold_buckets, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_buckets<<<dim3(nb, B), kFoldThreads, bytes, s>>>(
      static_cast<const int32_t*>(cells), static_cast<const float*>(sums),
      static_cast<const int32_t*>(starts), static_cast<float*>(out), n,
      tiles, nb);
  return static_cast<int>(cudaGetLastError());
}

const char* endpoint_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
