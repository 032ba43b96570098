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
// and min only. The segment plan (kernels/ops.py, SegmentPlan) is the
// forward's: order (E,) int32, offsets (S + 1,), and the pieces of the
// segments over PIECE = 128 edges (piece_off (S + 1,), bounds (2, P)).
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes from repro_torch/kernels/segment_reduce.py, which
// checks every argument first.
//
// It replaces no TPU kernel: the JAX package differentiates XLA's
// jax.ops.segment_sum/max/min, and the reference has no Pallas backward.
// A plain PyTorch backward on the card would be index_select for a sum,
// or scatter_reduce's autograd (a scatter of tie counts) for max and min;
// this kernel writes every gradient row from exactly one lane group, with
// integer tie counts, so a second launch gives the same bits.
//
// 1. grad_piece_ties (max and min, only where the plan has pieces): a lane
//    group a piece counts its ties, column by column, into the int32
//    scratch ties (P, d).
// 2. grad_rows: a lane group a segment. A segment without pieces: sum
//    writes g_out[s] to each of its rows; max and min count the ties over
//    the segment, then write each row's share. A segment with pieces: max
//    and min add their pieces' counts, in piece order (integers: exact in
//    any order), into the scratch row of the segment's first piece; sum
//    has nothing to do. Then the lane groups write zeros to the rows of
//    the edges in no segment: order[:offsets[0]] and order[offsets[S]:].
// 3. grad_pieces (only where the plan has pieces): a lane group a piece
//    finds its segment (a binary search over piece_off) and writes its
//    rows: g_out[s] for a sum, each row's share from the segment's total
//    ties for max and min.
//
// order is a permutation of the edges, so every row of grad is written
// once, by one lane group, and never read: no atomics, no memset.
//
// What bounds it on the H100: bytes. A sum reads g_out once (S rows), the
// order and offsets, and writes the E gradient rows once: at GCN's layer
// on ogb_products (E = 61.9 M, d = 16) about 4.2 GB, 1.26 ms at 3.35 TB/s.
// Max and min read the E value rows as well (this design reads them twice:
// once to count, once to write). Loads and stores are 128-bit where d is a
// multiple of 4 and the rows are 16-byte aligned.

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

// Adds, column by column, the edges order[begin:end] whose value equals
// o to cnt. The lane's units are col + j * group for j < kPer, those
// below units.
template <int V>
__device__ __forceinline__ void count_ties(
    const float* __restrict__ values, const int32_t* __restrict__ order,
    int64_t begin, int64_t end, int d, int units, int col, int group,
    const float (&o)[kPer][V], int (&cnt)[kPer][V]) {
  for (int64_t e = begin; e < end; ++e) {
    const int64_t base = static_cast<int64_t>(__ldg(order + e)) * d;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col + j * group;
      if (c < units) {
        const Unit<V> x = load_unit<V>(values + base + c * V);
#pragma unroll
        for (int k = 0; k < V; ++k) cnt[j][k] += (x.v[k] == o[j][k]) ? 1 : 0;
      }
    }
  }
}

// Writes the gradient rows of the edges order[begin:end], one column chunk
// of group * kPer units at c0: g (sum), or share where the value equals o
// and 0 elsewhere (max, min).
template <int OP, int V>
__device__ __forceinline__ void write_rows(
    const float* __restrict__ values, const int32_t* __restrict__ order,
    int64_t begin, int64_t end, int d, int units, int col, int group,
    const float (&o)[kPer][V], const float (&share)[kPer][V],
    float* __restrict__ grad) {
  for (int64_t e = begin; e < end; ++e) {
    const int64_t base = static_cast<int64_t>(__ldg(order + e)) * d;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = col + j * group;
      if (c < units) {
        float r[V];
        if constexpr (OP == kSum) {
#pragma unroll
          for (int k = 0; k < V; ++k) r[k] = share[j][k];
        } else {
          const Unit<V> x = load_unit<V>(values + base + c * V);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            r[k] = (x.v[k] == o[j][k]) ? share[j][k] : 0.0f;
          }
        }
        store_unit<V>(grad + base + c * V, r);
      }
    }
  }
}

// The lane's out[s] and g_out[s] units of one chunk.
template <int OP, int V>
__device__ __forceinline__ void load_head(
    const float* __restrict__ g_out, const float* __restrict__ out, int64_t s,
    int d, int units, int col, int group, float (&o)[kPer][V],
    float (&g)[kPer][V]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int c = col + j * group;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      o[j][k] = 0.0f;
      g[j][k] = 0.0f;
    }
    if (c < units) {
      const Unit<V> gu = load_unit<V>(g_out + s * d + c * V);
#pragma unroll
      for (int k = 0; k < V; ++k) g[j][k] = gu.v[k];
      if constexpr (OP != kSum) {
        const Unit<V> ou = load_unit<V>(out + s * d + c * V);
#pragma unroll
        for (int k = 0; k < V; ++k) o[j][k] = ou.v[k];
      }
    }
  }
}

// share = g * (1 / (ties + [o is the identity])), JAX's rule.
template <int OP, int V>
__device__ __forceinline__ void shares_of(const float (&o)[kPer][V],
                                          const int (&cnt)[kPer][V],
                                          float (&g)[kPer][V]) {
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int ties = cnt[j][k] + (o[j][k] == identity<OP>() ? 1 : 0);
      g[j][k] = g[j][k] * (1.0f / static_cast<float>(ties > 0 ? ties : 1));
    }
  }
}

// The segment owning piece p: the s with piece_off[s] <= p < piece_off[s+1].
__device__ __forceinline__ int64_t segment_of_piece(
    const int32_t* __restrict__ piece_off, int S, int64_t p) {
  int lo = 0;
  int hi = S;
  while (lo < hi) {
    const int mid = lo + (hi - lo) / 2;
    if (__ldg(piece_off + mid + 1) <= p) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One lane group a piece: its tie counts, column by column, into ties[p].
template <int OP, int V>
__global__ void __launch_bounds__(kThreads) grad_piece_ties(
    const float* __restrict__ values, const float* __restrict__ out,
    const int32_t* __restrict__ order, const int32_t* __restrict__ piece_off,
    const int32_t* __restrict__ bounds, int* __restrict__ ties, int S, int P,
    int d, int group) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const int units = d / V;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t made = __ldg(piece_off + S);
  const int64_t used = made < P ? made : P;
  for (int64_t p = warp * per_warp + lane / group; p < used;
       p += warps * per_warp) {
    const int64_t s = segment_of_piece(piece_off, S, p);
    const int64_t begin = __ldg(bounds + p);
    const int64_t end = __ldg(bounds + P + p);
    for (int c0 = 0; c0 < units; c0 += group * kPer) {
      const int col = c0 + lane % group;
      float o[kPer][V] = {};
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = col + j * group;
        if (c < units) {
          const Unit<V> ou = load_unit<V>(out + s * d + c * V);
#pragma unroll
          for (int k = 0; k < V; ++k) o[j][k] = ou.v[k];
        }
      }
      int cnt[kPer][V] = {};
      count_ties<V>(values, order, begin, end, d, units, col, group, o, cnt);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int c = col + j * group;
        if (c < units) {
#pragma unroll
          for (int k = 0; k < V; ++k) ties[p * d + c * V + k] = cnt[j][k];
        }
      }
    }
  }
}

// One lane group a segment, then one a row of an edge in no segment.
template <int OP, int V>
__global__ void __launch_bounds__(kThreads) grad_rows(
    const float* __restrict__ g_out, const float* __restrict__ values,
    const float* __restrict__ out, const int32_t* __restrict__ order,
    const int32_t* __restrict__ offsets, const int32_t* __restrict__ piece_off,
    int* __restrict__ ties, float* __restrict__ grad, int64_t E, int S, int d,
    int group) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const int units = d / V;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t first = warp * per_warp + lane / group;
  const int64_t stride = warps * per_warp;
  for (int64_t s = first; s < S; s += stride) {
    const int64_t p0 = __ldg(piece_off + s);
    const int64_t p1 = __ldg(piece_off + s + 1);
    if (p1 > p0) {
      if constexpr (OP != kSum) {
        // the segment's total ties, into its first piece's row
        for (int c = lane % group; c < d; c += group) {
          int total = 0;
          for (int64_t p = p0; p < p1; ++p) total += ties[p * d + c];
          ties[p0 * d + c] = total;
        }
      }
      continue;
    }
    const int64_t begin = __ldg(offsets + s);
    const int64_t end = __ldg(offsets + s + 1);
    if (end <= begin) continue;
    for (int c0 = 0; c0 < units; c0 += group * kPer) {
      const int col = c0 + lane % group;
      float o[kPer][V];
      float g[kPer][V];
      load_head<OP, V>(g_out, out, s, d, units, col, group, o, g);
      if constexpr (OP != kSum) {
        int cnt[kPer][V] = {};
        count_ties<V>(values, order, begin, end, d, units, col, group, o,
                      cnt);
        shares_of<OP, V>(o, cnt, g);
      }
      write_rows<OP, V>(values, order, begin, end, d, units, col, group, o, g,
                        grad);
    }
  }
  // the edges in no segment: order[:offsets[0]] and order[offsets[S]:]
  const int64_t lo = __ldg(offsets);
  const int64_t hi = __ldg(offsets + S);
  const int64_t outside = lo + (E - hi);
  for (int64_t q = first; q < outside; q += stride) {
    const int64_t pos = q < lo ? q : hi + (q - lo);
    const int64_t base = static_cast<int64_t>(__ldg(order + pos)) * d;
    for (int c = lane % group; c < units; c += group) {
      float zero[V];
#pragma unroll
      for (int k = 0; k < V; ++k) zero[k] = 0.0f;
      store_unit<V>(grad + base + c * V, zero);
    }
  }
}

// One lane group a piece: its rows of a long segment.
template <int OP, int V>
__global__ void __launch_bounds__(kThreads) grad_pieces(
    const float* __restrict__ g_out, const float* __restrict__ values,
    const float* __restrict__ out, const int32_t* __restrict__ order,
    const int32_t* __restrict__ piece_off, const int32_t* __restrict__ bounds,
    const int* __restrict__ ties, float* __restrict__ grad, int S, int P,
    int d, int group) {
  const int lane = threadIdx.x & 31;
  const int per_warp = 32 / group;
  const int units = d / V;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t made = __ldg(piece_off + S);
  const int64_t used = made < P ? made : P;
  for (int64_t p = warp * per_warp + lane / group; p < used;
       p += warps * per_warp) {
    const int64_t s = segment_of_piece(piece_off, S, p);
    const int64_t begin = __ldg(bounds + p);
    const int64_t end = __ldg(bounds + P + p);
    for (int c0 = 0; c0 < units; c0 += group * kPer) {
      const int col = c0 + lane % group;
      float o[kPer][V];
      float g[kPer][V];
      load_head<OP, V>(g_out, out, s, d, units, col, group, o, g);
      if constexpr (OP != kSum) {
        const int64_t head = static_cast<int64_t>(__ldg(piece_off + s)) * d;
        int cnt[kPer][V] = {};
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const int c = col + j * group;
          if (c < units) {
#pragma unroll
            for (int k = 0; k < V; ++k) cnt[j][k] = ties[head + c * V + k];
          }
        }
        shares_of<OP, V>(o, cnt, g);
      }
      write_rows<OP, V>(values, order, begin, end, d, units, col, group, o, g,
                        grad);
    }
  }
}

template <int OP, int V>
cudaError_t launch(const float* g_out, const float* values, const float* out,
                   const int32_t* order, const int32_t* offsets,
                   const int32_t* piece_off, const int32_t* bounds, int* ties,
                   float* grad, int64_t E, int S, int P, int d, int sms,
                   cudaStream_t stream) {
  const int group = group_of(d / V);
  cudaError_t err;
  if (OP != kSum && P > 0) {
    grad_piece_ties<OP, V><<<blocks_for(P, group, sms), kThreads, 0,
                             stream>>>(values, out, order, piece_off, bounds,
                                       ties, S, P, d, group);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  grad_rows<OP, V><<<blocks_for(S, group, sms), kThreads, 0, stream>>>(
      g_out, values, out, order, offsets, piece_off, ties, grad, E, S, d,
      group);
  err = cudaGetLastError();
  if (err != cudaSuccess || P == 0) return err;
  grad_pieces<OP, V><<<blocks_for(P, group, sms), kThreads, 0, stream>>>(
      g_out, values, out, order, piece_off, bounds, ties, grad, S, P, d,
      group);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_op(int vec, const float* g_out, const float* values,
                      const float* out, const int32_t* order,
                      const int32_t* offsets, const int32_t* piece_off,
                      const int32_t* bounds, int* ties, float* grad,
                      int64_t E, int S, int P, int d, int sms,
                      cudaStream_t stream) {
  if (vec == 4) {
    return launch<OP, 4>(g_out, values, out, order, offsets, piece_off,
                         bounds, ties, grad, E, S, P, d, sms, stream);
  }
  if (vec == 2) {
    return launch<OP, 2>(g_out, values, out, order, offsets, piece_off,
                         bounds, ties, grad, E, S, P, d, sms, stream);
  }
  return launch<OP, 1>(g_out, values, out, order, offsets, piece_off, bounds,
                       ties, grad, E, S, P, d, sms, stream);
}

}  // namespace

extern "C" {

// g_out (S, d) f32; values (E, d) and out (S, d) f32 (max, min; ignored
// for a sum); order (E,) i32; offsets, piece_off (S + 1,) i32; bounds
// (2, P) i32 (piece starts, then ends); ties (P, d) i32 scratch (max and
// min with P > 0) and grad (E, d) f32 are caller-allocated. op: 0 sum,
// 1 max, 2 min. vec: floats an access (4, 2 or 1), which d and the
// pointers' alignment must allow.
int segment_reduce_grad_launch(const void* g_out, const void* values,
                               const void* out, const void* order,
                               const void* offsets, const void* piece_off,
                               const void* bounds, void* ties, void* grad,
                               int64_t E, int S, int P, int d, int op,
                               int vec, int sms, void* stream) {
  if (E < 0 || S < 1 || P < 0 || d < 1 || sms < 1 || op < 0 || op > 2
      || !(vec == 1 || vec == 2 || vec == 4) || d % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* g = static_cast<const float*>(g_out);
  const auto* v = static_cast<const float*>(values);
  const auto* y = static_cast<const float*>(out);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* off = static_cast<const int32_t*>(offsets);
  const auto* po = static_cast<const int32_t*>(piece_off);
  const auto* b = static_cast<const int32_t*>(bounds);
  auto* t = static_cast<int*>(ties);
  auto* x = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (op == kSum) {
    err = launch_op<kSum>(vec, g, v, y, o, off, po, b, t, x, E, S, P, d, sms,
                          s);
  } else if (op == kMax) {
    err = launch_op<kMax>(vec, g, v, y, o, off, po, b, t, x, E, S, P, d, sms,
                          s);
  } else {
    err = launch_op<kMin>(vec, g, v, y, o, off, po, b, t, x, E, S, P, d, sms,
                          s);
  }
  return static_cast<int>(err);
}

const char* segment_reduce_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
