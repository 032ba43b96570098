// Walk-endpoint gather for the index-backed FORA walk phase (K3).
//
//   out[b, t] = sum_i w[b,i] * [i < budget[s]] * [endpoints[s, i] == t],
//   s = starts[b, i]
//
// endpoints (n, W) int32 is the walk index's pre-drawn table, budget (n,)
// int32 its per-node count of valid lanes, starts (B, L <= W) int32 and
// weights (B, L) float32 one query row per b. Built with nvcc into a shared
// library with a plain C interface and called through ctypes from
// repro_torch/kernels/walk_gather.py, which checks every argument first.
//
// The TPU kernel compares every lane's endpoint with every node of an
// output block (a one-hot contraction, O(B * L * n) work for the vector
// unit). Here a lane is a gather and the fold is a sort:
//
// 1. gather_tiles, one block of kThreads threads per (tile of kTile lanes,
//    row b). Each thread gathers its lanes' start, budget and endpoint (one
//    4-byte read at row stride W, 64-bit offsets: n * W passes 2^31 at the
//    paper graph's size) and forms the key (endpoint << 32 | lane in tile);
//    lanes that fail the budget test, and out-of-range starts or endpoints,
//    get the empty key, which sorts last and writes nothing. A bitonic sort
//    in shared memory orders the tile by (endpoint, lane). Each run of equal
//    endpoints is then summed as a pairwise tree in lane order (run bounds
//    by binary search over the sorted keys), and the run's head writes the
//    sum to its cell. No float atomics: a run has one summation order, fixed
//    by its lanes, so a second launch gives the same bits, and a hub that
//    collects thousands of lanes adds at most log2(kTile) levels of
//    rounding instead of one per lane.
// 2. With more than one tile per row, every tile writes a (B, tiles, n)
//    scratch, and fold_tiles adds a row's tiles in tile order. The scratch
//    is B * ceil(L / kTile) * n floats, at most B / kTile of the table's
//    n * W ints, since L <= W. With one tile the first pass writes the
//    output directly.
//
// The destination is zero-filled first (cells no lane reaches stay 0).
//
// What bounds it on the H100: bytes, and at B = 1 little of them: the
// (B, n) output written once, B * L starts and weights read once, and two
// random 4-byte gathers (budget, endpoint) per lane, each a 32-byte sector.
// The sort runs in shared memory and costs instructions, not bytes; this
// first version spends them freely.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 2048;        // lanes sorted together by one block
constexpr int kThreads = 1024;
constexpr int kPerThread = kTile / kThreads;
constexpr int kFoldBlock = 256;
constexpr unsigned long long kEmpty = ~0ull;
constexpr unsigned long long kEndpointMask = 0xFFFFFFFF00000000ull;

// first position in the sorted tile whose key is >= v
__device__ int lower_bound(const unsigned long long* keys,
                           unsigned long long v) {
  int lo = 0;
  int hi = kTile;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
gather_tiles(const int32_t* __restrict__ endpoints,
             const int32_t* __restrict__ budget,
             const int32_t* __restrict__ starts,
             const float* __restrict__ weights, float* __restrict__ dest,
             int n, int W, int L, int tiles) {
  __shared__ unsigned long long keys[kTile];
  __shared__ float lane_w[kTile];    // by lane in tile
  __shared__ float vals[kTile];      // by sorted position
  const int tile = blockIdx.x;
  const int b = blockIdx.y;
  const long long row = static_cast<long long>(b) * L;
  const int lane0 = tile * kTile;

  for (int k = threadIdx.x; k < kTile; k += kThreads) {
    const int i = lane0 + k;
    unsigned long long key = kEmpty;
    float w = 0.0f;
    if (i < L) {
      const int s = starts[row + i];
      if (s >= 0 && s < n && i < budget[s]) {
        const int e = endpoints[static_cast<long long>(s) * W + i];
        if (e >= 0 && e < n) {
          key = (static_cast<unsigned long long>(e) << 32) |
                static_cast<unsigned int>(k);
          w = weights[row + i];
        }
      }
    }
    keys[k] = key;
    lane_w[k] = w;
  }
  __syncthreads();

  // bitonic sort, ascending; the owner of the lower index of each pair
  // compares and swaps it
  for (int size = 2; size <= kTile; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int k = threadIdx.x; k < kTile; k += kThreads) {
        const int p = k ^ stride;
        if (p > k) {
          const unsigned long long a = keys[k];
          const unsigned long long c = keys[p];
          if ((a > c) == ((k & size) == 0)) {
            keys[k] = c;
            keys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // each sorted position's run of equal endpoints: [first, first + len)
  int first[kPerThread];
  int len[kPerThread];
  for (int q = 0; q < kPerThread; ++q) {
    const int j = threadIdx.x + q * kThreads;
    const unsigned long long key = keys[j];
    if (key == kEmpty) {
      first[q] = j;
      len[q] = 0;
      vals[j] = 0.0f;
      continue;
    }
    const unsigned long long cell = key & kEndpointMask;
    first[q] = lower_bound(keys, cell);
    len[q] = lower_bound(keys, cell + (1ull << 32)) - first[q];
    vals[j] = lane_w[key & 0xFFFFFFFFull];
  }
  __syncthreads();

  // pairwise tree over each run: at stride s the run positions r that are
  // multiples of 2s add position r + s, which no one writes in that round
  for (int s = 1; s < kTile; s <<= 1) {
    for (int q = 0; q < kPerThread; ++q) {
      const int j = threadIdx.x + q * kThreads;
      const int r = j - first[q];
      if ((r & (2 * s - 1)) == 0 && r + s < len[q]) vals[j] += vals[j + s];
    }
    __syncthreads();
  }

  const long long base = (static_cast<long long>(b) * tiles + tile) * n;
  for (int q = 0; q < kPerThread; ++q) {
    const int j = threadIdx.x + q * kThreads;
    if (len[q] > 0 && j == first[q]) {
      dest[base + static_cast<long long>(keys[j] >> 32)] = vals[j];
    }
  }
}

// out[b, t] = sum over tiles k, in order, of scratch[b, k, t]
__global__ void __launch_bounds__(kFoldBlock)
fold_tiles(const float* __restrict__ scratch, float* __restrict__ out,
           long long cells, int n, int tiles) {
  for (long long c = static_cast<long long>(blockIdx.x) * kFoldBlock +
                     threadIdx.x;
       c < cells; c += static_cast<long long>(gridDim.x) * kFoldBlock) {
    const long long b = c / n;
    const float* p = scratch + b * tiles * n + (c - b * n);
    float acc = p[0];
    for (int k = 1; k < tiles; ++k) acc += p[static_cast<long long>(k) * n];
    out[c] = acc;
  }
}

}  // namespace

extern "C" {

// Lanes one block sorts; the wrapper sizes the scratch with it.
int walk_gather_tile_lanes() { return kTile; }

// out (B, n) f32. scratch is (B, ceil(L / tile), n) f32 when L spans more
// than one tile, else unused (may be null).
int walk_gather_launch(const void* endpoints, const void* budget,
                       const void* starts, const void* weights, void* scratch,
                       void* out, int n, int W, int B, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (L + kTile - 1) / kTile;
  float* dest = static_cast<float*>(tiles == 1 ? out : scratch);
  cudaError_t err = cudaMemsetAsync(
      dest, 0, static_cast<size_t>(B) * tiles * n * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_tiles<<<dim3(tiles, B), kThreads, 0, s>>>(
      static_cast<const int32_t*>(endpoints),
      static_cast<const int32_t*>(budget),
      static_cast<const int32_t*>(starts), static_cast<const float*>(weights),
      dest, n, W, L, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess || tiles == 1) return static_cast<int>(err);
  const long long cells = static_cast<long long>(B) * n;
  const long long want = (cells + kFoldBlock - 1) / kFoldBlock;
  const int blocks = static_cast<int>(want < 65536 ? want : 65536);
  fold_tiles<<<blocks, kFoldBlock, 0, s>>>(static_cast<const float*>(scratch),
                                           static_cast<float*>(out), cells, n,
                                           tiles);
  return static_cast<int>(cudaGetLastError());
}

const char* walk_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
