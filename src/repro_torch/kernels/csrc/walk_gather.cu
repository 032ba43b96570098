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
// unit). Here the lanes are gathered once and each block folds the lanes
// that land in its own range of output cells. A cell's sum has four
// levels, each added in lane order: its lanes within a 32-lane chunk, the
// chunk sums within a group of 1,024 lanes, the group sums within a
// segment of 32,768 lanes, the segment sums. The order is fixed by the
// cell's own lanes, not by the grid, so a second launch gives the same
// bits, and a hub that collects every lane rounds at most 31 times a level
// instead of once a lane (93 times at L = 32,768: 5.6e-6 of the sum of its
// weights, under the check's 1e-5). No float atomics.
//
// 1. gather_cells, one thread per lane, a warp per chunk: the lane's
//    start, its budget and its stored endpoint (one 4-byte read at row
//    stride W, 64-bit offsets: n * W passes 2^31 at the paper graph's size)
//    give the lane's cell, or -1 for a lane that fails the budget test or
//    whose start or endpoint lies outside [0, n). __match_any_sync groups
//    the chunk's lanes by cell; the first lane of each keeps the cell and
//    the chunk's sum, the others write -1. The (B, L) cells and sums are
//    the only scratch: 32 KB at L = 4,096, resident in L2.
// 2. fold_cells, a grid of (cell ranges, B) blocks of kThreads threads,
//    one block an SM: the wrapper sizes the ranges (at most kMaxCells
//    cells) so that the grid fills the card once at any B. The warps
//    split a batch of groups (as many as shared memory holds the range's
//    group sums for) and each group's cells. A warp reads its group's
//    chunks in order, kInFlight chunks of loads at a time, and the lane
//    that holds an entry of one of the warp's cells adds it to the cell's
//    group sum: a chunk holds a cell once, so no two lanes meet. Then one
//    thread a cell adds the group sums in order. A hub costs what a spread
//    does: a cell has at most one entry a chunk. The block writes every
//    cell of its range once, zeros included: no memset, no scratch of
//    (B, n) partials, no second pass.
//
// What bounds it on the H100: bytes, and at B = 1 little of them: the
// (B, n) output written once, B * L starts and weights read once, and two
// random 4-byte gathers (budget, endpoint) per lane, each a 32-byte sector.
// This design adds the scratch, written once, and each fold block's read
// of its row's cells and chunk sums from L2 (8 bytes a lane, shared in L1
// by the warps of a group); a block's time is three barriers a batch and,
// in its busiest warp, 32 chunks of loads and adds.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kGatherBlock = 256;
constexpr int kThreads = 1024;              // a group's lanes, 32 chunks
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCells = 4096;             // a fold block's range, at most
constexpr int kGroupsPerSegment = 32;       // the order's third level
constexpr int kTable = 16384;               // group sums held: groups x cells
constexpr int kInFlight = 16;               // chunks a warp loads at once

struct FoldShared {
  float segment_sum[kMaxCells];  // per cell: the open segment's sum
  float total[kMaxCells];        // and the closed segments'
  float group_sum[kTable];       // per group of the batch and cell
};

// One thread a lane of row blockIdx.y, so each warp holds one 32-lane
// chunk. The chunk's lanes of one cell are added in lane order by the
// first of them, which keeps the cell and the sum; the others drop out.
__global__ void __launch_bounds__(kGatherBlock)
gather_cells(const int32_t* __restrict__ endpoints,
             const int32_t* __restrict__ budget,
             const int32_t* __restrict__ starts,
             const float* __restrict__ weights, int32_t* __restrict__ cells,
             float* __restrict__ values, int n, int W, int L) {
  const int i = blockIdx.x * kGatherBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const long long idx = static_cast<long long>(blockIdx.y) * L + i;
  int cell = -1;
  float w = 0.f;
  if (i < L) {
    const int s = starts[idx];
    if (s >= 0 && s < n && i < budget[s]) {
      const int e = endpoints[static_cast<long long>(s) * W + i];
      if (e >= 0 && e < n) {
        cell = e;
        w = weights[idx];
      }
    }
  }
  const unsigned peers = __match_any_sync(0xffffffffu, cell);
  float sum = 0.f;
  for (int j = 0; j < 32; ++j) {
    const float v = __shfl_sync(0xffffffffu, w, j);
    if ((peers >> j) & 1u) sum += v;
  }
  if (i < L) {
    const bool first = lane == __ffs(peers) - 1;
    cells[idx] = first ? cell : -1;
    values[idx] = sum;
  }
}

// The block's range is [c0, c0 + range) of row blockIdx.y. A cell's sum
// has four levels, each added in lane order: lanes within a 32-lane chunk
// (gather_cells), chunk sums within a group of kThreads lanes, group sums
// within a segment of kGroupsPerSegment groups, segment sums.
__global__ void __launch_bounds__(kThreads)
fold_cells(const int32_t* __restrict__ cells,
           const float* __restrict__ values, float* __restrict__ out, int n,
           int L, int range) {
  extern __shared__ __align__(16) unsigned char smem[];
  FoldShared& sh = *reinterpret_cast<FoldShared*>(smem);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int c0 = blockIdx.x * range;
  const int ncell = min(range, n - c0);
  const long long row = static_cast<long long>(blockIdx.y) * L;
  const int groups = (L + kThreads - 1) / kThreads;
  // groups a batch: as many as the table holds sums for, and a segment
  const int batch_groups = min(kGroupsPerSegment, kTable / ncell);
  for (int c = tid; c < ncell; c += kThreads) {
    sh.segment_sum[c] = 0.f;
    sh.total[c] = 0.f;
  }

  for (int g0 = 0; g0 < groups; g0 += batch_groups) {
    const int G = min(batch_groups, groups - g0);
    for (int k = tid; k < G * ncell; k += kThreads) sh.group_sum[k] = 0.f;
    __syncthreads();
    // the warps split the batch's groups, and each group's cells: a warp
    // reads its group's chunks in order, and the lane that holds an entry
    // of one of the warp's cells adds it to the cell's group sum (a chunk
    // holds a cell once, so no two lanes meet)
    const int per_group = kWarps / G;
    if (warp < per_group * G) {
      const int g = warp / per_group;
      const int slice = (ncell + per_group - 1) / per_group;
      const int lo = (warp % per_group) * slice;    // the warp's cells
      const int span = max(0, min(slice, ncell - lo));
      float* sums = sh.group_sum + g * ncell;
      const int first = (g0 + g) * kThreads;
      const int lanes = min(kThreads, L - first);
      for (int k0 = 0; k0 < kWarps; k0 += kInFlight) {
        int cell[kInFlight];
        float value[kInFlight];
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int i = (k0 + j) * 32 + lane;
          cell[j] = i < lanes ? cells[row + first + i] : -1;
          value[j] = i < lanes ? values[row + first + i] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < kInFlight; ++j) {
          const int c = cell[j] - c0;
          if (static_cast<unsigned>(c - lo) < static_cast<unsigned>(span)) {
            sums[c] += value[j];
          }
          __syncwarp();
        }
      }
    }
    __syncthreads();
    // each cell's group sums, in order, into its segment's sum
    for (int c = tid; c < ncell; c += kThreads) {
      float segment = sh.segment_sum[c];
      float total = sh.total[c];
      for (int g = 0; g < G; ++g) {
        if ((g0 + g) % kGroupsPerSegment == 0 && g0 + g > 0) {
          total += segment;
          segment = 0.f;
        }
        segment += sh.group_sum[g * ncell + c];
      }
      sh.segment_sum[c] = segment;
      sh.total[c] = total;
    }
    __syncthreads();
  }
  for (int c = tid; c < ncell; c += kThreads) {
    out[static_cast<long long>(blockIdx.y) * n + c0 + c] =
        sh.total[c] + sh.segment_sum[c];
  }
}

}  // namespace

extern "C" {

// out (B, n) f32; cells (B, L) i32 and values (B, L) f32 are
// caller-allocated scratch; range is the cells each fold block owns
// (1 <= range <= kMaxCells).
int walk_gather_launch(const void* endpoints, const void* budget,
                       const void* starts, const void* weights, void* cells,
                       void* values, void* out, int n, int W, int B, int L,
                       int range, void* stream) {
  if (range < 1 || range > kMaxCells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // FoldShared is above the 48 KB a block gets without asking
  cudaError_t err = cudaFuncSetAttribute(
      fold_cells, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(FoldShared)));
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_cells<<<dim3((L + kGatherBlock - 1) / kGatherBlock, B), kGatherBlock,
                 0, s>>>(static_cast<const int32_t*>(endpoints),
                         static_cast<const int32_t*>(budget),
                         static_cast<const int32_t*>(starts),
                         static_cast<const float*>(weights),
                         static_cast<int32_t*>(cells),
                         static_cast<float*>(values), n, W, L);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fold_cells<<<dim3((n + range - 1) / range, B), kThreads, sizeof(FoldShared),
               s>>>(static_cast<const int32_t*>(cells),
                    static_cast<const float*>(values),
                    static_cast<float*>(out), n, L, range);
  return static_cast<int>(cudaGetLastError());
}

const char* walk_gather_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
