// The backward of the weighted embedding bag (K5, embedding_bag.cu):
// given the output's gradient g (B, d) of
//
//   out[b, :] = sum_l w[b, l] * table[ids[b, l], :]
//
// the gradients of the weights and of the table,
//
//   dw[b, l] = <table[ids[b, l], :], g[b, :]>                 (bag_grad_weights)
//   dT[v, :] = sum over (b, l) with ids[b, l] = v of w[b, l] * g[b, :]
//                                                             (bag_grad_table)
//
// dT dense (V, d), 0 on the rows no id names: the JAX gradient is dense, and
// AdamW decays every row. table (V, d), g (B, d), w (B, L) float32
// contiguous; ids (B, L) int32 with contiguous rows and a row stride given.
// Ids are read as the forward reads them (an id in [-V, 0) is row id + V;
// one outside [-V, V) gives a NaN dw). The table gradient is taken over the
// segment plan of the flat ids (kernels/ops.py, SegmentPlan, built from ids
// in [0, V)): keys (B * L,) int32, the sorted ids clamped to [-1, V],
// offsets (V + 1,) and order (B * L,), position p holding the flat position
// order[p] = b * L + l. Built with nvcc into a shared library with a plain C
// interface and called through ctypes from repro_torch/kernels/
// embedding_bag.py (embedding_bag_grad_cuda), which checks every argument
// first.
//
// It replaces no TPU kernel: the reference has no Pallas backward. JAX
// differentiates DIN's jnp.take and einsum pooling (repro/models/recsys/
// din.py, _pair_embed and _interest), the function the Pallas kernel
// repro/kernels/embedding_bag.py:40 computes forward. A plain PyTorch
// backward on the card would add the table's gradient rows by id with
// index_add_ (F.embedding_bag's backward with per_sample_weights does the
// same with atomics), a float fold whose order changes from run to run. The
// port's rule is one summation order a cell, so a second call gives the
// same bits: no atomics here at all.
//
// * bag_grad_weights: one (b, l) a group of lanes (a power of two, enough
//   that a lane holds at most 4 units of the row: 4 lanes at DIN's d = 18
//   in 8-byte units). Lane j of the group loads units j, j + group, ... of
//   the table row and of g[b] (g's rows are read by L consecutive items, so
//   from L1), adds its products in column order, and the group adds its
//   lanes by a butterfly of shuffles, whose every lane ends with the same
//   bits; lane 0 writes dw[b, l].
// * bag_grad_table: the fold over runs of segment_units.cuh (fold_runs) on
//   the plan of the ids, the segment reduction's levels, with each
//   position's row formed as it is loaded, w[r] * g[r / L] for r =
//   order[p] (BAG): the (B * L, d) products are never written. Level 1 also
//   writes 0 to every row of the table no id names, so every row of dT is
//   written once, by one thread. A row's terms are added in plan order (the
//   flat positions ascending) by the run-and-level tree, whose shape
//   depends on the plan, B * L and d alone: a hot id (DIN's Zipf histories
//   give one item a quarter of all positions) is folded by every group and
//   block its positions touch, never by one group alone.
//
// What bounds it on the H100: bytes. The table gradient writes V rows (DIN's
// item table: 10M x 18 floats, 720 MB, 214.9 us at 3.35 TB/s) and reads the
// plan (order and keys, 8 bytes a position; offsets 4 bytes a row), w and
// the g rows (from L2: 4.7 MB at B = 65,536); the weights' gradient reads
// the ids, the rows they name and g, and writes B * L floats.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_units.cuh"

namespace {

using segment::fold_runs;
using segment::kSum;
using segment::kThreads;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnitsALane = 4;          // bag_grad_weights: units a lane, at most

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);
}

// dw[b, l] for one (b, l) a group of `group` lanes (a power of two up to
// 32), W floats a unit (2 where d is even and the table and g 8-byte
// aligned, else 1). A group's lanes are consecutive lanes of one warp, and
// the grid covers whole warps, so every shuffle has its partners.
template <int W>
__global__ void __launch_bounds__(kThreads) bag_grad_weights(
    const float* __restrict__ table, const int32_t* __restrict__ ids,
    const float* __restrict__ g, float* __restrict__ dw, int64_t items,
    int L, int V, int d, int64_t ids_stride, int group) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int j = threadIdx.x & (group - 1);
  // the item by a shift (group is a power of two), its bag by a 32-bit
  // quotient (items < 2^31), not by 64-bit divisions
  const int64_t item = t >> (__ffs(group) - 1);
  const bool live = item < items;
  const int it = live ? static_cast<int>(item) : 0;
  const int64_t b = it / L;
  const int l = it - static_cast<int>(b) * L;
  const int units = d / W;
  float acc = 0.0f;
  bool bad = false;
  if (live) {
    int64_t id = __ldg(ids + b * ids_stride + l);
    bad = id < -static_cast<int64_t>(V) || id >= V;
    if (id < 0) id += V;
    if (!bad) {
      const float* row = table + id * d;
      const float* gb = g + b * d;
      // the lane's units, loaded together, then added in column order
      float tv[kUnitsALane * W];
      float gv[kUnitsALane * W];
#pragma unroll
      for (int u = 0; u < kUnitsALane; ++u) {
        const int c = j + u * group;
        if (c < units) {
          if constexpr (W == 2) {
            const float2 a = __ldg(reinterpret_cast<const float2*>(row) + c);
            const float2 e = __ldg(reinterpret_cast<const float2*>(gb) + c);
            tv[2 * u] = a.x;
            tv[2 * u + 1] = a.y;
            gv[2 * u] = e.x;
            gv[2 * u + 1] = e.y;
          } else {
            tv[u] = __ldg(row + c);
            gv[u] = __ldg(gb + c);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kUnitsALane; ++u) {
        if (j + u * group < units) {
#pragma unroll
          for (int k = 0; k < W; ++k) {
            acc = fmaf(tv[u * W + k], gv[u * W + k], acc);
          }
        }
      }
    }
  }
  // the group's butterfly: every lane ends with the same sum
  for (int off = group >> 1; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (live && j == 0) dw[item] = bad ? nan_value() : acc;
}

// Level 1 of the table gradient: the BAG fold over the plan of the ids,
// which also writes 0 to every row no id names.
template <int U, int V>
__global__ void __launch_bounds__(
    kThreads, (segment::min_blocks<true, false, U, V>())) bag_table_first(
    const float* __restrict__ g, const float* __restrict__ w,
    const int32_t* __restrict__ order, const int32_t* __restrict__ keys,
    const int32_t* __restrict__ offsets, float* __restrict__ out,
    float* __restrict__ part, int32_t* __restrict__ part_keys, int64_t n,
    int S, int d, int L, int R, int group) {
  fold_runs<kSum, false, true, float, float, U, V, true>(
      g, order, keys, nullptr, out, part, part_keys, offsets, n, S, d, R,
      group, w, L);
}

// A later level: the slots the level before wrote, as segment_reduce.cu's
// reduce_level folds them (offsets null, passed at run time as there, which
// keeps its register allocation: no variant spills).
template <int U, int V>
__global__ void __launch_bounds__(
    kThreads, (segment::min_blocks<false, false, U, V>())) bag_table_level(
    const float* __restrict__ src, const int32_t* __restrict__ keys,
    float* __restrict__ out, float* __restrict__ part,
    int32_t* __restrict__ part_keys, const int32_t* __restrict__ offsets,
    int64_t n, int S, int d, int R, int group) {
  fold_runs<kSum, false, false, float, float, U, V>(
      src, nullptr, keys, nullptr, out, part, part_keys, offsets, n, S, d, R,
      group);
}

template <int U, int V>
cudaError_t launch_table(const float* g, const float* w, const int32_t* order,
                         const int32_t* keys, const int32_t* offsets,
                         float* const part[2], int32_t* const part_keys[2],
                         float* out, int64_t E, int S, int d, int L,
                         int group, int R1, int RL, cudaStream_t stream) {
  const float* src = nullptr;
  const int32_t* k = keys;
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
    if (level == 0) {
      bag_table_first<U, V><<<blocks, kThreads, 0, stream>>>(
          g, w, order, k, offsets, out, p, pk, n, S, d, L, R, group);
    } else {
      bag_table_level<U, V><<<blocks, kThreads, 0, stream>>>(
          src, k, out, p, pk, nullptr, n, S, d, R, group);
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
cudaError_t launch_table_u(int per, const float* g, const float* w,
                           const int32_t* order, const int32_t* keys,
                           const int32_t* offsets, float* const part[2],
                           int32_t* const part_keys[2], float* out, int64_t E,
                           int S, int d, int L, int group, int R1, int RL,
                           cudaStream_t stream) {
  if (per == 4) {
    return launch_table<4, V>(g, w, order, keys, offsets, part, part_keys, out,
                              E, S, d, L, group, R1, RL, stream);
  }
  if (per == 2) {
    return launch_table<2, V>(g, w, order, keys, offsets, part, part_keys, out,
                              E, S, d, L, group, R1, RL, stream);
  }
  return launch_table<1, V>(g, w, order, keys, offsets, part, part_keys, out,
                            E, S, d, L, group, R1, RL, stream);
}

}  // namespace

extern "C" {

// dw (B, L) f32 from table (V, d) f32, ids (B, L) i32 (row stride
// ids_stride), g (B, d) f32. width: floats a unit (1 or 2; 2 needs d even
// and the table and g 8-byte aligned); group: lanes an item (a power of two
// up to 32, with d / width <= 4 * group).
int bag_grad_weights_launch(const void* table, const void* ids, const void* g,
                            void* dw, int B, int L, int V, int d,
                            int64_t ids_stride, int width, int group,
                            void* stream) {
  if (B < 1 || L < 1 || V < 1 || d < 1 || !(width == 1 || width == 2)
      || d % width != 0 || group < 1 || group > 32
      || (group & (group - 1)) != 0 || d / width > kUnitsALane * group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t items = static_cast<int64_t>(B) * L;
  const int64_t threads = items * group;
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1)
                                            / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* gg = static_cast<const float*>(g);
  auto* y = static_cast<float*>(dw);
  if (width == 2) {
    bag_grad_weights<2><<<blocks, kThreads, 0, s>>>(t, i, gg, y, items, L, V,
                                                    d, ids_stride, group);
  } else {
    bag_grad_weights<1><<<blocks, kThreads, 0, s>>>(t, i, gg, y, items, L, V,
                                                    d, ids_stride, group);
  }
  return static_cast<int>(cudaGetLastError());
}

// dT (S, d) f32 from g (B, d) and w (B, L) f32 over the plan of the flat ids:
// order and keys (E = B * L,) i32, offsets (S + 1,) i32; part0/part1 (slots,
// d) f32 and keys0/keys1 (slots,) i32 scratch (segment_reduce.py,
// _scratch()). vec, per, group, R1, RL: the segment reduction's geometry of
// E rows of d words (segment_reduce.py, _geometry()).
int bag_grad_table_launch(const void* g, const void* w, const void* order,
                          const void* keys, const void* offsets, void* part0,
                          void* part1, void* keys0, void* keys1, void* out,
                          int64_t E, int S, int d, int L, int vec, int per,
                          int group, int R1, int RL, void* stream) {
  if (E < 1 || S < 1 || d < 1 || L < 1 || !(vec == 1 || vec == 4)
      || d % vec != 0 || !(per == 1 || per == 2 || per == 4) || group < 1
      || group > 32 || (group & (group - 1)) != 0 || R1 < 1 || RL < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float* const part[2] = {static_cast<float*>(part0),
                          static_cast<float*>(part1)};
  int32_t* const part_keys[2] = {static_cast<int32_t*>(keys0),
                                 static_cast<int32_t*>(keys1)};
  const auto* gg = static_cast<const float*>(g);
  const auto* ww = static_cast<const float*>(w);
  const auto* o = static_cast<const int32_t*>(order);
  const auto* k = static_cast<const int32_t*>(keys);
  const auto* off = static_cast<const int32_t*>(offsets);
  auto* y = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (vec == 4) {
    err = launch_table_u<4>(per, gg, ww, o, k, off, part, part_keys, y, E, S,
                            d, L, group, R1, RL, s);
  } else {
    err = launch_table_u<1>(per, gg, ww, o, k, off, part, part_keys, y, E, S,
                            d, L, group, R1, RL, s);
  }
  return static_cast<int>(err);
}

const char* embedding_bag_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
