// Segment reduction over rows in one fixed order: the GNNs' aggregation.
//
//   out[s, c] = op over the edges e of segment s of values[e, c]
//
// with op one of sum, max, min. values (E, d) float32. The segment plan
// (kernels/ops.py, SegmentPlan) holds keys (E,) int32, the stable sort of
// the segment index clamped to [-1, S], and offsets (S + 1,) int32, so
// that segment s is the positions offsets[s] : offsets[s+1]; and, on the
// gathered route, order (E,) int32, the sort's permutation: position p
// holds the row order[p] of values. On the contiguous route (order null)
// the caller has laid the rows out in plan order already (GCN gathers its
// messages through the sorted index), and position p holds row p. An empty
// segment gives the op's identity: 0 for sum, -inf for max, +inf for min
// (as jax.ops.segment_* give them). An edge whose index lies outside
// [0, S) is in no segment and is never read. Built with nvcc into a shared
// library with a plain C interface and called through ctypes from
// repro_torch/kernels/segment_reduce.py, which checks every argument
// first.
//
// It replaces no TPU kernel: the JAX package aggregates with XLA's
// jax.ops.segment_sum/max/min (repro/models/gnn/common.py:44-61). The
// port's ground rule is that no float fold is left on atomics, and
// index_add_ and scatter_reduce sum with float atomics on a card, in an
// order that changes from run to run. Here every output cell has one
// summation order, fixed by the plan and the run lengths (themselves
// fixed by E and d), so a second launch gives the same bits; max and min
// are exact in any order. No atomics of any kind.
//
// The design (segment_units.cuh, fold_runs): the positions are cut into
// runs of R1 positions, one run a group of lanes, folded left to right;
// the parts of segments that cross runs are folded a block in shared
// memory, and the block's two open parts go to the next level's slots,
// which each later level folds in runs of RL, until one block holds them
// all. The launch below is one kernel a level, 2 to 4 of them on the
// GNNs' shapes; level 1 also writes the identity to the empty segments.
//
// What bounds it on the H100: bytes. The function reads the rows inside
// segments once, the keys (and on the gathered route the order) and the
// offsets, and writes S rows of d floats: at GCN's first layer on
// ogb_products (E = 61.9 M, d = 16) about 4.37 GB, 1.30 ms at 3.35 TB/s.
// What the design does about it:
// * balanced work: every group folds R1 positions, whatever the segments'
//   lengths; a segment of any length (the models' trash segment of masked
//   edges, 130,000 edges on a sampled batch) is folded by every group its
//   runs touch, its runs' parts by its blocks and its blocks' parts by a
//   tree of later levels, never by one group alone;
// * occupancy: a lane holds the U column units its row needs (U = 1 at
//   d 16) and K rows in flight; the bound on registers is 64 for a stream
//   of narrow rows, 85 or 128 where a lane holds more (segment_units.cuh,
//   min_blocks), so that no variant spills;
// * the contiguous route reads rows as one stream (16-byte units where d
//   is a multiple of 4; at odd d a warp reads 128 contiguous bytes, so
//   only a row's two ends touch a sector that it shares with the next
//   row, read by the same warp) and no order;
// * R1 (32 to 256) is chosen from E and d for about 16,384 blocks where
//   E is large, so that the last wave is short; the partials cost 2 rows
//   a block.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_units.cuh"

namespace {

using segment::fold_runs;
using segment::kMax;
using segment::kMin;
using segment::kSum;
using segment::kThreads;

template <int OP, bool GATHER, int U, int V>
__global__ void __launch_bounds__(
    kThreads, (segment::min_blocks<GATHER, false, U, V>())) reduce_level(
    const float* __restrict__ src, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ keys, float* __restrict__ out,
    float* __restrict__ part, int32_t* __restrict__ part_keys,
    const int32_t* __restrict__ offsets, int64_t n, int S, int d, int R,
    int group) {
  fold_runs<OP, false, GATHER, float, float, U, V>(
      src, rows, keys, nullptr, out, part, part_keys, offsets, n, S, d, R,
      group);
}

// Every level of one reduction: level 1 over the E positions (through
// order where it is given), each later level over the slots the one
// before wrote, alternating between the two scratch buffers.
template <int OP, int U, int V>
cudaError_t launch(const float* values, const int32_t* order,
                   const int32_t* keys, const int32_t* offsets,
                   float* const part[2], int32_t* const part_keys[2],
                   float* out, int64_t E, int S, int d, int group, int R1,
                   int RL, cudaStream_t stream) {
  const float* src = values;
  const int32_t* rows = order;
  const int32_t* k = keys;
  const int32_t* off = offsets;
  int64_t n = E;
  int R = R1;
  for (int level = 0;; ++level) {
    const int64_t runs = (n + R - 1) / R;
    const int64_t per_block = kThreads / group;
    const int64_t used = (runs + per_block - 1) / per_block;
    const bool last = used <= 1;
    float* p = last ? nullptr : part[level & 1];
    int32_t* pk = last ? nullptr : part_keys[level & 1];
    const auto blocks = static_cast<unsigned>(used < 1 ? 1 : used);
    if (rows != nullptr) {
      reduce_level<OP, true, U, V><<<blocks, kThreads, 0, stream>>>(
          src, rows, k, out, p, pk, off, n, S, d, R, group);
    } else {
      reduce_level<OP, false, U, V><<<blocks, kThreads, 0, stream>>>(
          src, rows, k, out, p, pk, off, n, S, d, R, group);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    src = p;
    rows = nullptr;
    k = pk;
    off = nullptr;
    n = 2 * used;
    R = RL;
  }
}

template <int OP, int V>
cudaError_t launch_u(int per, const float* values, const int32_t* order,
                     const int32_t* keys, const int32_t* offsets,
                     float* const part[2], int32_t* const part_keys[2],
                     float* out, int64_t E, int S, int d, int group, int R1,
                     int RL, cudaStream_t stream) {
  if (per == 4) {
    return launch<OP, 4, V>(values, order, keys, offsets, part, part_keys, out,
                            E, S, d, group, R1, RL, stream);
  }
  if (per == 2) {
    return launch<OP, 2, V>(values, order, keys, offsets, part, part_keys, out,
                            E, S, d, group, R1, RL, stream);
  }
  return launch<OP, 1, V>(values, order, keys, offsets, part, part_keys, out,
                          E, S, d, group, R1, RL, stream);
}

template <int OP>
cudaError_t launch_op(int vec, int per, const float* values,
                      const int32_t* order, const int32_t* keys,
                      const int32_t* offsets, float* const part[2],
                      int32_t* const part_keys[2], float* out, int64_t E,
                      int S, int d, int group, int R1, int RL,
                      cudaStream_t stream) {
  if (vec == 4) {
    return launch_u<OP, 4>(per, values, order, keys, offsets, part, part_keys,
                           out, E, S, d, group, R1, RL, stream);
  }
  return launch_u<OP, 1>(per, values, order, keys, offsets, part, part_keys,
                         out, E, S, d, group, R1, RL, stream);
}

}  // namespace

extern "C" {

// values (E, d) f32; order (E,) i32 or null (the contiguous route); keys
// (E,) i32 in [-1, S]; offsets (S + 1,) i32; part0/part1 (slots, d) f32
// and keys0/keys1 (slots,) i32 scratch, each at least the slots of the
// levels that write it (segment_reduce.py, _scratch()); out (S, d) f32.
// op: 0 sum, 1 max, 2 min. vec: words an access (4 or 1), which d and the
// pointers' alignment must allow; per: units a lane (1, 2 or 4); group:
// lanes a run (a power of two up to 32); R1, RL: the run lengths, R1 a
// multiple of the batch.
int segment_reduce_launch(const void* values, const void* order,
                          const void* keys, const void* offsets, void* part0,
                          void* part1, void* keys0, void* keys1, void* out,
                          int64_t E, int S, int d, int op, int vec, int per,
                          int group, int R1, int RL, void* stream) {
  if (E < 0 || S < 1 || d < 1 || op < 0 || op > 2 || !(vec == 1 || vec == 4)
      || d % vec != 0 || !(per == 1 || per == 2 || per == 4) || group < 1
      || group > 32 || (group & (group - 1)) != 0 || R1 < 1 || RL < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* const part[2] = {static_cast<float*>(part0),
                          static_cast<float*>(part1)};
  int32_t* const part_keys[2] = {static_cast<int32_t*>(keys0),
                                 static_cast<int32_t*>(keys1)};
  const auto* v = static_cast<const float*>(values);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* off = static_cast<const int32_t*>(offsets);
  auto* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (op == kSum) {
    err = launch_op<kSum>(vec, per, v, o, k, off, part, part_keys, y, E, S, d,
                          group, R1, RL, s);
  } else if (op == kMax) {
    err = launch_op<kMax>(vec, per, v, o, k, off, part, part_keys, y, E, S, d,
                          group, R1, RL, s);
  } else {
    err = launch_op<kMin>(vec, per, v, o, k, off, part, part_keys, y, E, S, d,
                          group, R1, RL, s);
  }
  return static_cast<int>(err);
}

const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
