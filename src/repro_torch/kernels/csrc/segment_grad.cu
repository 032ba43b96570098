// The backward of the segment reduction (segment_reduce.cu): the gradient
// of out[s] = op over the edges e of segment s of values[e] with respect
// to values, given the output's gradient g_out (S, d):
//
//   sum:      grad[e] = g_out[s]
//   max, min: grad[e, c] = g_out[s, c] * (1 / ties[s, c])
//             where values[e, c] == out[s, c], else 0
//   an edge in no segment: grad[e] = 0
//
// ties[s, c] counts the segment's edges equal to out[s, c] in column c,
// plus one where out[s, c] is the op's identity (-inf for max, +inf for
// min): jax.grad of jax.ops.segment_max/min splits the gradient equally
// among ties, counts the scatter's initial value among them, and
// multiplies by the float32 reciprocal (kernels/ref.py,
// segment_reduce_grad_ref). values (E, d) and out (S, d) are read for max
// and min only. The plan is the forward's (kernels/ops.py, SegmentPlan):
// keys (E,) int32, the sorted segment index clamped to [-1, S], offsets,
// and on the gathered route order (E,), position p holding row order[p];
// on the contiguous route (order null) position p holds row p. Built with
// nvcc into a shared library with a plain C interface and called through
// ctypes from repro_torch/kernels/segment_reduce.py, which checks every
// argument first.
//
// It replaces no TPU kernel: the JAX package differentiates XLA's
// jax.ops.segment_sum/max/min (repro/models/gnn/common.py:44-61), and the
// reference has no Pallas backward. A plain PyTorch backward on the card
// would be index_select for a sum, or scatter_reduce's autograd (a scatter
// of tie counts) for max and min.
//
// 1. (max and min) the tie counts: the fold over runs of the forward
//    (segment_units.cuh, fold_runs), counting in int32 the row's words
//    equal to out[s] at level 1 and adding the partial counts at later
//    levels: every segment's count by a fixed tree, the trash segment's
//    too, and no atomics (integer sums would be exact in any order, but
//    none is needed).
// 2. grad_flat: the gradient as one flat (E * d) array in aligned 16-byte
//    units, a block a range of rows, so that every store is a whole
//    16-byte unit at any d (d 47, 75) and the rows are written in order:
//    row r of segment keys[r] on the contiguous route (row = position),
//    of segment index[r] on the gathered route (row = edge, the plan's
//    index). Each word finds its row, column and segment; g_out (and out,
//    ties) are read by segment, from L2 where segments repeat.
// Every gradient word is written once, by one thread, and never read: no
// memset, and a second launch gives the same bits.
//
// What bounds it on the H100: bytes. A sum writes the E gradient rows
// once and reads g_out (S rows), the keys or index and the offsets: at
// GCN's first layer on ogb_products (E = 61.9 M, d = 16) about 4.2 GB,
// 1.26 ms at 3.35 TB/s. Max and min read the E value rows twice (once to
// count, once to write) and the output rows of the segments. Both routes
// stream the gradient and its segments; only the g_out rows are gathered.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_units.cuh"

namespace {

using segment::fold_runs;
using segment::identity;
using segment::kMax;
using segment::kMin;
using segment::kSum;
using segment::kThreads;

template <bool GATHER, int U, int V>
__global__ void __launch_bounds__(
    kThreads, (segment::min_blocks<GATHER, true, U, V>())) ties_first(
    const float* __restrict__ values, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ keys, const float* __restrict__ out,
    int* __restrict__ ties, int* __restrict__ part,
    int32_t* __restrict__ part_keys, int64_t n, int S, int d, int R,
    int group) {
  fold_runs<kSum, true, GATHER, float, int, U, V>(
      values, rows, keys, out, ties, part, part_keys, nullptr, n, S, d, R,
      group);
}

template <int U, int V>
__global__ void __launch_bounds__(
    kThreads, (segment::min_blocks<false, false, U, V>())) ties_level(
    const int* __restrict__ src, const int32_t* __restrict__ keys,
    int* __restrict__ ties, int* __restrict__ part,
    int32_t* __restrict__ part_keys, int64_t n, int S, int d, int R,
    int group) {
  fold_runs<kSum, false, false, int, int, U, V>(
      src, nullptr, keys, nullptr, ties, part, part_keys, nullptr, n, S, d, R,
      group);
}

// The segment of row r of the gradient: segs[r] where it lies in [0, S),
// else none (-1).
__device__ __forceinline__ int segment_at(const int32_t* __restrict__ segs,
                                          int64_t r, int S) {
  const int k = __ldg(segs + r);
  return k >= 0 && k < S ? k : -1;
}

// The four gradient words at columns c .. c + 3 of one row of segment s
// (c a multiple of 4 and d too, so one 16-byte unit of each row), with v
// the row's values there.
template <int OP>
__device__ __forceinline__ float4 grad_unit(int s, int c, float4 v,
                                            const float* __restrict__ g_out,
                                            const float* __restrict__ out,
                                            const int* __restrict__ ties,
                                            int d) {
  if (s < 0) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int64_t at = static_cast<int64_t>(s) * d + c;
  const float4 g = __ldg(reinterpret_cast<const float4*>(g_out + at));
  if constexpr (OP == kSum) {
    return g;
  } else {
    const float4 o = __ldg(reinterpret_cast<const float4*>(out + at));
    const int4 t = __ldg(reinterpret_cast<const int4*>(ties + at));
    const float id = identity<OP>();
    auto share = [id](float gv, float vv, float ov, int tv) {
      const int n = tv + (ov == id ? 1 : 0);
      return vv == ov ? gv * (1.0f / static_cast<float>(n > 0 ? n : 1))
                      : 0.0f;
    };
    return make_float4(share(g.x, v.x, o.x, t.x), share(g.y, v.y, o.y, t.y),
                       share(g.z, v.z, o.z, t.z), share(g.w, v.w, o.w, t.w));
  }
}

constexpr int kUnitsAThread = 4;

// The flat (E * d) gradient in aligned 16-byte units, row r of segment
// segs[r]: the keys on the contiguous route (row = position), the index
// on the gathered route (row = edge). A block takes rows [row0, row0 +
// rows_per_block) (a multiple of 4, so its units are whole and its column
// arithmetic stays in 32 bits);
// V = 4: d is a multiple of 4, so a unit is one unit of one row; V = 1: a
// unit's four words may span two rows.
template <int OP, int V>
__global__ void __launch_bounds__(kThreads) grad_flat(
    const float* __restrict__ g_out, const float* __restrict__ values,
    const float* __restrict__ out, const int* __restrict__ ties,
    const int32_t* __restrict__ segs, float* __restrict__ grad, int64_t E,
    int S, int d, int rows_per_block) {
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t rows_here =
      E - row0 < rows_per_block ? E - row0 : rows_per_block;
  const int words = static_cast<int>(rows_here) * d;
  float* gbase = grad + row0 * d;
  const float* vbase = values == nullptr ? nullptr : values + row0 * d;
  // kUnitsAThread units a thread, their loads issued together
  for (int i0 = threadIdx.x; 4 * i0 < words;
       i0 += kThreads * kUnitsAThread) {
    int s[kUnitsAThread];
    int r[kUnitsAThread];
    int c[kUnitsAThread];
#pragma unroll
    for (int q = 0; q < kUnitsAThread; ++q) {
      const int i = i0 + q * kThreads;
      r[q] = (4 * i) / d;
      c[q] = 4 * i - r[q] * d;
      s[q] = 4 * i < words ? segment_at(segs, row0 + r[q], S) : -1;
    }
    if constexpr (V == 4) {
      float4 v[kUnitsAThread];
#pragma unroll
      for (int q = 0; q < kUnitsAThread; ++q) {
        v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if constexpr (OP != kSum) {
          if (s[q] >= 0) {
            v[q] = __ldg(reinterpret_cast<const float4*>(vbase) + i0
                         + q * kThreads);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kUnitsAThread; ++q) {
        const int i = i0 + q * kThreads;
        if (4 * i < words) {
          reinterpret_cast<float4*>(gbase)[i] =
              grad_unit<OP>(s[q], c[q], v[q], g_out, out, ties, d);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kUnitsAThread; ++q) {
        const int i = i0 + q * kThreads;
        if (4 * i >= words) continue;
        const bool whole = 4 * i + 4 <= words;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if constexpr (OP != kSum) {
          if (whole) {
            const float4 t = __ldg(reinterpret_cast<const float4*>(vbase) + i);
            v[0] = t.x;
            v[1] = t.y;
            v[2] = t.z;
            v[3] = t.w;
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (4 * i + j < words) v[j] = __ldg(vbase + 4 * i + j);
            }
          }
        }
        // each word's segment and column first (a unit spans at most two
        // rows), then every load of the unit's four words together
        int sw[4];
        int cw[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (c[q] == d) {
            c[q] = 0;
            ++r[q];
            s[q] = 4 * i + j < words ? segment_at(segs, row0 + r[q], S) : -1;
          }
          sw[j] = 4 * i + j < words ? s[q] : -1;
          cw[j] = c[q]++;
        }
        float w[4];
        if constexpr (OP == kSum) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w[j] = sw[j] >= 0
                ? __ldg(g_out + static_cast<int64_t>(sw[j]) * d + cw[j])
                : 0.0f;
          }
        } else {
          float o[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            o[j] = sw[j] >= 0
                ? __ldg(out + static_cast<int64_t>(sw[j]) * d + cw[j])
                : 0.0f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            w[j] = 0.0f;
            if (sw[j] >= 0 && v[j] == o[j]) {
              const int64_t at = static_cast<int64_t>(sw[j]) * d + cw[j];
              const int t = __ldg(ties + at)
                  + (o[j] == identity<OP>() ? 1 : 0);
              w[j] = __ldg(g_out + at)
                  * (1.0f / static_cast<float>(t > 0 ? t : 1));
            }
          }
        }
        if (whole) {
          reinterpret_cast<float4*>(gbase)[i] =
              make_float4(w[0], w[1], w[2], w[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (4 * i + j < words) gbase[4 * i + j] = w[j];
          }
        }
      }
    }
  }
}

// The tie counts of max and min: every level of the fold over runs.
template <int U, int V>
cudaError_t count_ties(const float* values, const float* out,
                       const int32_t* order, const int32_t* keys, int* ties,
                       int* const part[2], int32_t* const part_keys[2],
                       int64_t E, int S, int d, int group, int R1, int RL,
                       cudaStream_t stream) {
  int64_t n = E;
  int R = R1;
  const int* src = nullptr;
  const int32_t* k = keys;
  for (int level = 0;; ++level) {
    const int64_t runs = (n + R - 1) / R;
    const int64_t per_block = kThreads / group;
    const int64_t used = (runs + per_block - 1) / per_block;
    const bool last = used <= 1;
    int* p = last ? nullptr : part[level & 1];
    int32_t* pk = last ? nullptr : part_keys[level & 1];
    const auto blocks = static_cast<unsigned>(used < 1 ? 1 : used);
    if (level == 0 && order != nullptr) {
      ties_first<true, U, V><<<blocks, kThreads, 0, stream>>>(
          values, order, keys, out, ties, p, pk, n, S, d, R, group);
    } else if (level == 0) {
      ties_first<false, U, V><<<blocks, kThreads, 0, stream>>>(
          values, order, keys, out, ties, p, pk, n, S, d, R, group);
    } else {
      ties_level<U, V><<<blocks, kThreads, 0, stream>>>(src, k, ties, p, pk,
                                                        n, S, d, R, group);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    src = p;
    k = pk;
    n = 2 * used;
    R = RL;
  }
}

template <int V>
cudaError_t count_ties_u(int per, const float* values, const float* out,
                         const int32_t* order, const int32_t* keys, int* ties,
                         int* const part[2], int32_t* const part_keys[2],
                         int64_t E, int S, int d, int group, int R1, int RL,
                         cudaStream_t stream) {
  if (per == 4) {
    return count_ties<4, V>(values, out, order, keys, ties, part, part_keys,
                            E, S, d, group, R1, RL, stream);
  }
  if (per == 2) {
    return count_ties<2, V>(values, out, order, keys, ties, part, part_keys,
                            E, S, d, group, R1, RL, stream);
  }
  return count_ties<1, V>(values, out, order, keys, ties, part, part_keys, E,
                          S, d, group, R1, RL, stream);
}

template <int OP, int V>
cudaError_t write_grad(const float* g_out, const float* values,
                       const float* out, const int* ties,
                       const int32_t* segs, float* grad, int64_t E, int S,
                       int d, cudaStream_t stream) {
  // at most kUnitsAThread units a thread, in whole blocks of 4 rows
  const int fit = kUnitsAThread * kThreads / d;
  const int rows_per_block = 4 * (fit > 1 ? fit : 1);
  const unsigned blocks = static_cast<unsigned>(
      E < 1 ? 1 : (E + rows_per_block - 1) / rows_per_block);
  grad_flat<OP, V><<<blocks, kThreads, 0, stream>>>(
      g_out, values, out, ties, segs, grad, E, S, d, rows_per_block);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(int vec, int per, const float* g_out,
                      const float* values, const float* out,
                      const int32_t* order, const int32_t* keys,
                      const int32_t* index, int* ties,
                      int* const part[2], int32_t* const part_keys[2],
                      float* grad, int64_t E, int S, int d, int group, int R1,
                      int RL, cudaStream_t stream) {
  if constexpr (OP != kSum) {
    const cudaError_t err =
        vec == 4 ? count_ties_u<4>(per, values, out, order, keys, ties, part,
                                   part_keys, E, S, d, group, R1, RL, stream)
                 : count_ties_u<1>(per, values, out, order, keys, ties, part,
                                   part_keys, E, S, d, group, R1, RL, stream);
    if (err != cudaSuccess) return err;
  }
  const int32_t* segs = order == nullptr ? keys : index;
  return vec == 4 ? write_grad<OP, 4>(g_out, values, out, ties, segs, grad, E,
                                      S, d, stream)
                  : write_grad<OP, 1>(g_out, values, out, ties, segs, grad, E,
                                      S, d, stream);
}

}  // namespace

extern "C" {

// g_out (S, d) f32; values (E, d) and out (S, d) f32 (max, min; ignored
// for a sum); order (E,) i32 or null (the contiguous route); keys (E,)
// i32 in [-1, S]; index (E,) i32, each edge's segment in edge order (the
// gathered route; an entry outside [0, S) is in none); ties (S, d) i32,
// part0/part1 (slots, d) i32 and keys0/keys1 (slots,) i32 scratch (max and
// min; segment_reduce.py, _scratch()); grad (E, d) f32. All
// caller-allocated and 16-byte aligned.
// op: 0 sum, 1 max, 2 min. vec: 4 where d is a multiple of 4, else 1;
// per, group, R1, RL: the tie counts' fold (as segment_reduce_launch's).
int segment_reduce_grad_launch(const void* g_out, const void* values,
                               const void* out, const void* order,
                               const void* keys, const void* index,
                               void* ties, void* part0,
                               void* part1, void* keys0, void* keys1,
                               void* grad, int64_t E, int S, int d, int op,
                               int vec, int per, int group, int R1, int RL,
                               void* stream) {
  if (E < 0 || S < 1 || d < 1 || op < 0 || op > 2 || !(vec == 1 || vec == 4)
      || d % vec != 0 || !(per == 1 || per == 2 || per == 4) || group < 1
      || group > 32 || (group & (group - 1)) != 0 || R1 < 1 || RL < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* const part[2] = {static_cast<int*>(part0), static_cast<int*>(part1)};
  int32_t* const part_keys[2] = {static_cast<int32_t*>(keys0),
                                 static_cast<int32_t*>(keys1)};
  const auto* g = static_cast<const float*>(g_out);
  const auto* v = static_cast<const float*>(values);
  const auto* y = static_cast<const float*>(out);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* ix = static_cast<const int32_t*>(index);
  auto* t = static_cast<int*>(ties);
  auto* x = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (op == kSum) {
    err = launch_op<kSum>(vec, per, g, v, y, o, k, ix, t, part, part_keys, x, E,
                          S, d, group, R1, RL, s);
  } else if (op == kMax) {
    err = launch_op<kMax>(vec, per, g, v, y, o, k, ix, t, part, part_keys, x, E,
                          S, d, group, R1, RL, s);
  } else {
    err = launch_op<kMin>(vec, per, g, v, y, o, k, ix, t, part, part_keys, x, E,
                          S, d, group, R1, RL, s);
  }
  return static_cast<int>(err);
}

const char* segment_reduce_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
