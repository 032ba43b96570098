// Segment reduction over rows in one fixed order: the GNNs' aggregation.
//
//   out[s, c] = op over e in segment s, in ascending edge id, of values[e, c]
//
// with op one of sum, max, min. values (E, d) float32; the segment plan
// (kernels/ops.py, SegmentPlan) holds order (E,) int32, the stable sort of
// the segment index, so that segment s is order[offsets[s] : offsets[s+1]]
// in ascending edge id, and offsets (S + 1,) int32. An empty segment gives
// the op's identity: 0 for sum, -inf for max, +inf for min (as
// jax.ops.segment_* give them). An edge whose index lies outside [0, S) is
// in no segment and is never read. Built with nvcc into a shared library
// with a plain C interface and called through ctypes from
// repro_torch/kernels/segment_reduce.py, which checks every argument first.
//
// It replaces no TPU kernel: the JAX package aggregates with XLA's
// jax.ops.segment_sum/max/min (repro/models/gnn/common.py:44-61). The
// port's ground rule is that no float fold is left on atomics, and
// index_add_ and scatter_reduce sum with float atomics on a card, in an
// order that changes from run to run. Here every output cell has one
// summation order, fixed by the plan alone, so a second launch gives the
// same bits; max and min are exact in any order.
//
// 1. segment_pieces (only where the plan has pieces): a segment longer than
//    PIECE = 128 edges (kernels/segment_reduce.py) would keep one lane group
//    busy alone (the masked edges that the models redirect to a trash
//    segment number tens of thousands on a sampled batch), so the plan cuts
//    it into pieces of PIECE consecutive edges, and a piece's rows are
//    folded, left to right, into its row of the partials scratch.
// 2. segment_rows: a group of lanes a segment (32 lanes over the columns,
//    fewer where d is narrow, so that a warp holds 32 / group segments),
//    128-bit loads where d allows, a grid-stride loop over the segments.
//    A short segment's rows are folded left to right in edge order; a long
//    one's piece partials are folded in piece order. So the order of a cell
//    of a segment of at most PIECE edges is the left fold over its edges,
//    and of a longer one the left fold of its pieces' left folds.
//
// A lane holds kPer column units (a unit is 4, 2 or 1 floats) and issues
// the loads of kUnroll edges before it adds them in order, to keep loads in
// flight; wider rows take several column chunks.
//
// What bounds it on the H100: bytes. The function reads the E rows of d
// floats once (gathered through order), the order and offsets, and writes
// S rows of d floats: at GCN's layer on ogb_products (E = 61.9 M, d = 16)
// about 4.37 GB, 1.30 ms at 3.35 TB/s. This design adds the pieces'
// partials (written once, read once) and reads each row at 16-byte
// granularity where d is a multiple of 4.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_units.cuh"

namespace {

using segment::blocks_for;
using segment::group_of;
using segment::identity;
using segment::kMax;
using segment::kMin;
using segment::kPer;
using segment::kSum;
using segment::kThreads;
using segment::load_unit;
using segment::store_unit;
using segment::Unit;

constexpr int kUnroll = 4;    // edges whose loads a lane issues together

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if constexpr (OP == kSum) {
    return a + b;
  } else if constexpr (OP == kMax) {
    return fmaxf(a, b);
  } else {
    return fminf(a, b);
  }
}

// Folds the rows r(e) for e in [begin, end), in e order, into acc: r(e) is
// rows[e] where rows is given, else e. The lane's units are col + j * group
// for j < kPer, those below units.
template <int OP, int V>
__device__ __forceinline__ void fold_rows(
    const float* __restrict__ values, const int32_t* __restrict__ rows,
    int64_t begin, int64_t end, int d, int units, int col, int group,
    float (&acc)[kPer][V]) {
  int64_t e = begin;
  for (; e + kUnroll <= end; e += kUnroll) {
    int64_t base[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      base[u] = (rows != nullptr ? static_cast<int64_t>(__ldg(rows + e + u))
                                 : e + u) * d;
    }
    Unit<V> x[kUnroll][kPer];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = col + j * group;
        if (c < units) x[u][j] = load_unit<V>(values + base[u] + c * V);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (col + j * group < units) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            acc[j][k] = combine<OP>(acc[j][k], x[u][j].v[k]);
          }
        }
      }
    }
  }
  for (; e < end; ++e) {
    const int64_t base =
        (rows != nullptr ? static_cast<int64_t>(__ldg(rows + e)) : e) * d;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col + j * group;
      if (c < units) {
        const Unit<V> x = load_unit<V>(values + base + c * V);
#pragma unroll
        for (int k = 0; k < V; ++k) acc[j][k] = combine<OP>(acc[j][k], x.v[k]);
      }
    }
  }
}

// Writes the op over rows r(e), e in [begin, end), of every column of d to
// dst (one row of d floats), a chunk of group * kPer units at a time.
template <int OP, int V>
__device__ __forceinline__ void reduce_into(
    const float* __restrict__ values, const int32_t* __restrict__ rows,
    int64_t begin, int64_t end, int d, int g, int group,
    float* __restrict__ dst) {
  const int units = d / V;
  for (int c0 = 0; c0 < units; c0 += group * kPer) {
    float acc[kPer][V];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
#pragma unroll
      for (int k = 0; k < V; ++k) acc[j][k] = identity<OP>();
    }
    fold_rows<OP, V>(values, rows, begin, end, d, units, c0 + g, group, acc);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = c0 + g + j * group;
      if (c < units) store_unit<V>(dst + c * V, acc[j]);
    }
  }
}

// One lane group a piece: partials[p] = the piece's rows folded in order.
// Pieces past piece_off[S] (the plan's bound on their number is loose) and
// empty ones are skipped.
template <int OP, int V>
__global__ void __launch_bounds__(kThreads) segment_pieces(
    const float* __restrict__ values, const int32_t* __restrict__ order,
    const int32_t* __restrict__ piece_off, const int32_t* __restrict__ bounds,
    float* __restrict__ partials, int S, int P, int d, int group) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t made = __ldg(piece_off + S);
  const int64_t used = made < P ? made : P;
  for (int64_t p = warp * per_warp + lane / group; p < used;
       p += warps * per_warp) {
    const int64_t begin = __ldg(bounds + p);
    const int64_t end = __ldg(bounds + P + p);
    if (end <= begin) continue;
    reduce_into<OP, V>(values, order, begin, end, d, lane % group, group,
                       partials + p * d);
  }
}

// One lane group a segment: out[s] from its edges, or from its pieces'
// partials where it has pieces.
template <int OP, int V>
__global__ void __launch_bounds__(kThreads) segment_rows(
    const float* __restrict__ values, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ piece_off,
    const float* __restrict__ partials, float* __restrict__ out, int S, int d,
    int group) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t s = warp * per_warp + lane / group; s < S;
       s += warps * per_warp) {
    const int64_t p0 = __ldg(piece_off + s);
    const int64_t p1 = __ldg(piece_off + s + 1);
    float* dst = out + s * d;
    if (p1 > p0) {
      reduce_into<OP, V>(partials, nullptr, p0, p1, d, lane % group, group,
                         dst);
    } else {
      reduce_into<OP, V>(values, order, __ldg(offsets + s),
                         __ldg(offsets + s + 1), d, lane % group, group, dst);
    }
  }
}

template <int OP, int V>
cudaError_t launch(const float* values, const int32_t* order,
                   const int32_t* offsets, const int32_t* piece_off,
                   const int32_t* bounds, float* partials, float* out, int S,
                   int P, int d, int sms, cudaStream_t stream) {
  const int group = group_of(d / V);
  if (P > 0) {
    segment_pieces<OP, V><<<blocks_for(P, group, sms), kThreads, 0, stream>>>(
        values, order, piece_off, bounds, partials, S, P, d, group);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  segment_rows<OP, V><<<blocks_for(S, group, sms), kThreads, 0, stream>>>(
      values, order, offsets, piece_off, partials, out, S, d, group);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(int vec, const float* values, const int32_t* order,
                      const int32_t* offsets, const int32_t* piece_off,
                      const int32_t* bounds, float* partials, float* out,
                      int S, int P, int d, int sms, cudaStream_t stream) {
  if (vec == 4) {
    return launch<OP, 4>(values, order, offsets, piece_off, bounds, partials,
                         out, S, P, d, sms, stream);
  }
  if (vec == 2) {
    return launch<OP, 2>(values, order, offsets, piece_off, bounds, partials,
                         out, S, P, d, sms, stream);
  }
  return launch<OP, 1>(values, order, offsets, piece_off, bounds, partials,
                       out, S, P, d, sms, stream);
}

}  // namespace

extern "C" {

// values (E, d) f32; order (E,) i32; offsets, piece_off (S + 1,) i32;
// bounds (2, P) i32 (piece starts, then ends); partials (P, d) f32 scratch
// and out (S, d) f32 are caller-allocated. op: 0 sum, 1 max, 2 min. vec:
// floats a load (4, 2 or 1), which d and the pointers' alignment must allow.
int segment_reduce_launch(const void* values, const void* order,
                          const void* offsets, const void* piece_off,
                          const void* bounds, void* partials, void* out,
                          int S, int P, int d, int op, int vec, int sms,
                          void* stream) {
  if (S < 1 || P < 0 || d < 1 || sms < 1 || op < 0 || op > 2
      || !(vec == 1 || vec == 2 || vec == 4) || d % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* v = static_cast<const float*>(values);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* po = static_cast<const int32_t*>(piece_off);
  const auto* b = static_cast<const int32_t*>(bounds);
  auto* part = static_cast<float*>(partials);
  auto* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (op == kSum) {
    err = launch_op<kSum>(vec, v, o, off, po, b, part, y, S, P, d, sms, s);
  } else if (op == kMax) {
    err = launch_op<kMax>(vec, v, o, off, po, b, part, y, S, P, d, sms, s);
  } else {
    err = launch_op<kMin>(vec, v, o, off, po, b, part, y, S, P, d, sms, s);
  }
  return static_cast<int>(err);
}

const char* segment_reduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
