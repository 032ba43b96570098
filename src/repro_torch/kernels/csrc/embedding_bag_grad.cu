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
// * bag_grad_weights: one (b, l) a lane where the row has at most 32 words
//   (bag_grad_weights_lane; DIN's d = 18): a block's 256 consecutive items
//   (ids read coalesced) span at most 256 / L + 2 bags, whose g rows it
//   stages in shared memory once; each lane loads its id, then its whole
//   table row (float2 units where d is even and the table 8-byte aligned)
//   before it uses any of it, adds its d products in column order with
//   fmaf, and writes dw[b, l]: one coalesced store a warp, no shuffles.
//   Wider rows take a group of lanes an item (bag_grad_weights: a power of
//   two, enough that a lane holds at most 4 units of the row): lane j loads
//   units j, j + group, ... of the table row and of g[b], adds its products
//   in column order, and the group adds its lanes by a butterfly of
//   shuffles; lane 0 writes dw[b, l]. embedding_bag.py's grad_group says
//   which a shape takes.
// * bag_grad_table: the fold over runs of segment_units.cuh (fold_runs) on
//   the plan of the ids, the segment reduction's levels, each position's
//   row the product w[r] * g[r / L] for r = order[p] (BAG): the (B * L, d)
//   products are never written to device memory. At level 1, where a run
//   is a warp's and a lane a word of the row (d from 17 to 31, not a
//   multiple of 4: DIN's d = 18, a run of 32 positions a warp), the warp
//   stages its run's products first, one lane a position: its order entry
//   and key (the first round's loaded with the run's edge keys), one
//   division r / L, w[r] and its g row in 8-byte units, all in flight
//   together, the products by __fmul_rn into shared memory at an odd row
//   stride; then one ballot marks where segments start, and the warp walks
//   the staged rows piece by piece, lanes 0 .. d - 1 adding their column
//   (walk_staged). Other rows are formed as they are loaded, a lane its
//   units. Either way a row's terms are added in plan order (the flat
//   positions ascending) by the run-and-level tree, whose shape depends on
//   the plan, B * L and d alone, so dT has the bits of segment_reduce.cu
//   over the float32 products on the same plan: a hot id (DIN's Zipf
//   histories give one item a quarter of all positions) is folded by every
//   group and block its positions touch, never by one group alone. The
//   rows no id names get 0 from fill blocks of the same level-1 launch
//   (fill_unnamed; one an SM, first in the grid, so that they run beside
//   the fold from the start): a streaming pass over the flat (V, d) words
//   in 16-byte units, each written whole where its rows are all empty and
//   word by word where it meets a named row. Every word of dT is written
//   once, by one thread.
//
// What bounds it on the H100: bytes, in the end. The table gradient writes
// V rows (DIN's item table: 10M x 18 floats, 720 MB, 214.9 us at 3.35
// TB/s) and reads the plan (order and keys, 8 bytes a position; offsets 4
// bytes a row), w and the g rows (4.7 MB at B = 65,536, from L2). Today
// its fold is held instead by each block's chain of dependent steps (the
// run's keys and order entries, then w and the g rows, the walk, the
// block's two barriers), and the fill, which runs beside it, by the
// writes. The weights' gradient reads the ids, the rows they name (random
// 72-byte rows, from L2 mostly) and g, and writes B * L floats.

#include <cstdint>
#include <cuda_runtime.h>

#include "segment_units.cuh"

namespace {

using segment::fold_runs;
using segment::kSum;
using segment::kThreads;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnitsALane = 4;          // bag_grad_weights: units a lane, at most
constexpr int kLaneWords = 32;          // bag_grad_weights_lane: a row's words
constexpr int kFillPerSM = 1;           // level 1's fill blocks an SM
constexpr int kFillRows = 1024;         // rows a fill tile
constexpr int kStagedBlocks = 4;        // the staged level 1's blocks an SM

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);
}

// dw[b, l] for one (b, l) a group of `group` lanes (a power of two from 2
// to 32), W floats a unit (2 where d is even and the table and g 8-byte
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

// dw[b, l] for one (b, l) a lane, rows of d <= kLaneWords words, W floats a
// unit as above. The block's items i0 .. i0 + kThreads - 1 belong to the
// bags b0 .. b0 + rows - 1, whose g rows (rows * d floats, the kernel's
// dynamic shared memory) the block stages once; the lane's id and table
// row are in flight meanwhile.
template <int W>
__global__ void __launch_bounds__(kThreads) bag_grad_weights_lane(
    const float* __restrict__ table, const int32_t* __restrict__ ids,
    const float* __restrict__ g, float* __restrict__ dw, int64_t items,
    int L, int V, int d, int64_t ids_stride) {
  extern __shared__ float g_rows[];
  // items < 2^31: 32-bit quotients
  const int i0 = static_cast<int>(blockIdx.x) * kThreads;
  const int64_t end = items < static_cast<int64_t>(i0) + kThreads
      ? items : static_cast<int64_t>(i0) + kThreads;
  const int b0 = i0 / L;
  const int rows = static_cast<int>(end - 1) / L - b0 + 1;
  const int item = i0 + static_cast<int>(threadIdx.x);
  const bool live = item < end;
  const int b = (live ? item : i0) / L;
  const int l = (live ? item : i0) - b * L;
  int64_t id = live ? __ldg(ids + b * ids_stride + l) : 0;
  const bool bad = id < -static_cast<int64_t>(V) || id >= V;
  if (id < 0) id += V;
  const float* row = table + (bad ? 0 : id) * d;
  float t[kLaneWords];
#pragma unroll
  for (int c = 0; c < kLaneWords / W; ++c) {
    if (live && !bad && c * W < d) {
      if constexpr (W == 2) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(row) + c);
        t[2 * c] = a.x;
        t[2 * c + 1] = a.y;
      } else {
        t[c] = __ldg(row + c);
      }
    }
  }
  const float* gb = g + static_cast<int64_t>(b0) * d;
  for (int k = threadIdx.x; k < rows * d; k += kThreads) {
    g_rows[k] = __ldg(gb + k);
  }
  __syncthreads();
  const float* gs = g_rows + (b - b0) * d;
  float acc = 0.0f;
  if constexpr (W == 2) {
#pragma unroll
    for (int c = 0; c < kLaneWords / 2; ++c) {
      if (2 * c < d) {
        const float2 e = reinterpret_cast<const float2*>(gs)[c];
        acc = fmaf(t[2 * c], e.x, acc);
        acc = fmaf(t[2 * c + 1], e.y, acc);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kLaneWords; ++c) {
      if (c < d) acc = fmaf(t[c], gs[c], acc);
    }
  }
  if (live) dw[item] = bad ? nan_value() : acc;
}

// Zeros to the words of the rows no position names (offsets[s] ==
// offsets[s + 1]) of the flat (S, d) output, a tile of kFillRows rows at a
// time, a block the tiles tile0, tile0 + step, ...: the block reads the
// tile's offsets (kFillRows / kThreads rows a thread, the next tile's
// while it writes this one), keeps which rows are empty in shared memory,
// and writes the tile's words as 16-byte units (a tile's kFillRows d words
// start 16-byte aligned: out is), thread k the units k, k + kThreads, ...:
// a unit whole where all its words lie in empty rows, else only the words
// of empty rows. A unit spans at most two rows where d >= 2 (its first
// d - c words are row r's, c its first word's column), four where d = 1;
// which of its words to write is a 4-bit mask from those rows' flags, read
// once a unit. The fold writes every named row, so every word is written
// once.
__device__ __forceinline__ void fill_unnamed(
    const int32_t* __restrict__ offsets, float* __restrict__ out, int64_t S,
    int d, int64_t tile0, int64_t step) {
  constexpr int kRows = kFillRows / kThreads;     // rows a thread reads
  // row u of the tile at u, and three rows past its end, which a unit's
  // reads may reach: empty or not
  __shared__ bool empty[kFillRows + 3];
  const int64_t tiles = (S + kFillRows - 1) / kFillRows;
  // unit k's first word in a tile: row r0, column c0; kThreads units on,
  // 4 kThreads words: dr rows and dc columns more
  const int r0 = 4 * static_cast<int>(threadIdx.x) / d;
  const int c0 = 4 * static_cast<int>(threadIdx.x) - r0 * d;
  const int dr = 4 * kThreads / d;
  const int dc = 4 * kThreads - dr * d;
  bool next[kRows];
  auto read = [&](int64_t t) {
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int64_t s = t * kFillRows + kRows * threadIdx.x + i;
      next[i] = t < tiles && s < S
          && __ldg(offsets + s) == __ldg(offsets + s + 1);
    }
  };
  read(tile0);
  if (threadIdx.x < 3) empty[kFillRows + threadIdx.x] = false;
  for (int64_t t = tile0; t < tiles; t += step) {
    __syncthreads();                              // the tile before is written
#pragma unroll
    for (int i = 0; i < kRows; ++i) empty[kRows * threadIdx.x + i] = next[i];
    __syncthreads();
    read(t + step);
    const int64_t first = t * kFillRows;
    const int64_t rows = S - first < kFillRows ? S - first : kFillRows;
    const int64_t words = rows * d;
    float* tile = out + first * d;
    int r = r0;
    int c = c0;
    for (int64_t w0 = 4 * threadIdx.x; w0 < words; w0 += 4 * kThreads) {
      unsigned zero;
      if (d == 1) {
        zero = empty[r] | empty[r + 1] << 1 | empty[r + 2] << 2
            | empty[r + 3] << 3;
      } else {
        const int cut = d - c;                    // row r's words, >= 1
        const unsigned mine = cut >= 4 ? 0xfu : (1u << cut) - 1u;
        zero = (empty[r] ? mine : 0u)
            | (cut < 4 && empty[r + 1] ? 0xfu & ~mine : 0u);
      }
      if (words - w0 < 4) zero &= (1u << (words - w0)) - 1u;
      if (zero == 0xfu) {
        *reinterpret_cast<float4*>(tile + w0) = make_float4(0.f, 0.f, 0.f,
                                                            0.f);
      } else if (zero != 0u) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((zero >> k) & 1u) tile[w0 + k] = 0.0f;
        }
      }
      r += dr;
      c += dc;
      if (c >= d) {
        c -= d;
        ++r;
      }
    }
  }
}

// Level 1 of the table gradient: the fill's blocks first (fill_blocks of
// them, the rows no id names), then the BAG fold over the plan of the ids,
// STAGED (a run a warp, a word a unit and a lane) into the kernel's dynamic
// shared memory, kThreads rows of `stride` words.
template <int U, int V, bool STAGED>
__global__ void __launch_bounds__(
    kThreads, (STAGED ? kStagedBlocks
                      : segment::min_blocks<true, false, U, V>()))
    bag_table_first(const float* __restrict__ g, const float* __restrict__ w,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ offsets,
                    float* __restrict__ out, float* __restrict__ part,
                    int32_t* __restrict__ part_keys, int64_t n, int S, int d,
                    int L, int R, int group, int stride, int fill_blocks) {
  if (blockIdx.x < fill_blocks) {
    fill_unnamed(offsets, out, S, d, blockIdx.x, fill_blocks);
    return;
  }
  extern __shared__ float stage[];
  fold_runs<kSum, false, true, float, float, U, V, true, STAGED>(
      g, order, keys, nullptr, out, part, part_keys, nullptr, n, S, d, R,
      group, w, L, stage, stride, fill_blocks);
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

struct TableArgs {
  const float* g;
  const float* w;
  const int32_t* order;
  const int32_t* keys;
  const int32_t* offsets;
  float* part[2];
  int32_t* part_keys[2];
  float* out;
  int64_t E;
  int S, d, L, group, R1, RL, sms;
  cudaStream_t stream;
};

template <int U, int V, bool STAGED>
cudaError_t launch_table(const TableArgs& a) {
  const float* src = nullptr;
  const int32_t* k = a.keys;
  int64_t n = a.E;
  int R = a.R1;
  // the staged rows: an odd number of words (d <= 31)
  const int stride = a.d % 2 == 1 ? a.d : a.d + 1;
  const size_t smem = STAGED ? sizeof(float) * kThreads * stride : 0;
  const int fill = kFillPerSM * a.sms;
  for (int level = 0;; ++level) {
    const int64_t runs = (n + R - 1) / R;
    const int64_t per_block = kThreads / a.group;
    const int64_t used = (runs + per_block - 1) / per_block;
    const bool last = used <= 1;
    float* p = last ? nullptr : a.part[level & 1];
    int32_t* pk = last ? nullptr : a.part_keys[level & 1];
    if (level == 0) {
      const int64_t fold = used;
      const auto blocks = static_cast<unsigned>(fill + fold);
      bag_table_first<U, V, STAGED><<<blocks, kThreads, smem, a.stream>>>(
          a.g, a.w, a.order, k, a.offsets, a.out, p, pk, n, a.S, a.d, a.L, R,
          a.group, stride, fill);
    } else {
      const auto blocks = static_cast<unsigned>(used);
      bag_table_level<U, V><<<blocks, kThreads, 0, a.stream>>>(
          src, k, a.out, p, pk, nullptr, n, a.S, a.d, R, a.group);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    src = p;
    k = pk;
    n = 2 * used;
    R = a.RL;
  }
}

template <int V>
cudaError_t launch_table_u(int per, const TableArgs& a) {
  if constexpr (V == 1) {
    // a run a warp, a word a unit and a lane (d from 17 to 31, not a
    // multiple of 4): the staged level 1
    if (per == 1 && a.group == 32) return launch_table<1, 1, true>(a);
  }
  if (per == 4) return launch_table<4, V, false>(a);
  if (per == 2) return launch_table<2, V, false>(a);
  return launch_table<1, V, false>(a);
}

}  // namespace

extern "C" {

// dw (B, L) f32 from table (V, d) f32, ids (B, L) i32 (row stride
// ids_stride), g (B, d) f32. width: floats a unit (1 or 2; 2 needs d even
// and the table and g 8-byte aligned); group: lanes an item, 1 (the lane
// route, d <= 32) or a power of two up to 32 with d / width <= 4 * group.
int bag_grad_weights_launch(const void* table, const void* ids, const void* g,
                            void* dw, int B, int L, int V, int d,
                            int64_t ids_stride, int width, int group,
                            void* stream) {
  if (B < 1 || L < 1 || V < 1 || d < 1 || !(width == 1 || width == 2)
      || d % width != 0 || group < 1 || group > 32
      || (group & (group - 1)) != 0
      || (group == 1 ? d > kLaneWords : d / width > kUnitsALane * group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t items = static_cast<int64_t>(B) * L;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const float*>(table);
  const auto* i = static_cast<const int32_t*>(ids);
  const auto* gg = static_cast<const float*>(g);
  auto* y = static_cast<float*>(dw);
  if (group == 1) {
    const auto blocks = static_cast<unsigned>((items + kThreads - 1)
                                              / kThreads);
    // a block's bags: at most (kThreads - 1) / L + 2
    const int64_t rows = (kThreads - 1) / L + 2 < B ? (kThreads - 1) / L + 2
                                                    : B;
    const size_t smem = sizeof(float) * rows * d;
    if (width == 2) {
      bag_grad_weights_lane<2><<<blocks, kThreads, smem, s>>>(
          t, i, gg, y, items, L, V, d, ids_stride);
    } else {
      bag_grad_weights_lane<1><<<blocks, kThreads, smem, s>>>(
          t, i, gg, y, items, L, V, d, ids_stride);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t threads = items * group;
  const auto blocks = static_cast<unsigned>((threads + kThreads - 1)
                                            / kThreads);
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
// scratch_buffers()); out 16-byte aligned, g 8-byte aligned. vec, per,
// group, R1, RL: the segment reduction's geometry of E rows of d words
// (segment_reduce.py, geometry()); sms: the card's SMs (the fill's blocks).
int bag_grad_table_launch(const void* g, const void* w, const void* order,
                          const void* keys, const void* offsets, void* part0,
                          void* part1, void* keys0, void* keys1, void* out,
                          int64_t E, int S, int d, int L, int vec, int per,
                          int group, int R1, int RL, int sms, void* stream) {
  if (E < 1 || S < 1 || d < 1 || L < 1 || !(vec == 1 || vec == 4)
      || d % vec != 0 || !(per == 1 || per == 2 || per == 4) || group < 1
      || group > 32 || (group & (group - 1)) != 0 || R1 < 32 || R1 % 32 != 0
      || RL < 2 || sms < 1 || reinterpret_cast<uintptr_t>(out) % 16 != 0
      || reinterpret_cast<uintptr_t>(g) % 8 != 0
      || (vec == 1 && per == 1 && d > group)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TableArgs a{static_cast<const float*>(g), static_cast<const float*>(w),
              static_cast<const int32_t*>(order),
              static_cast<const int32_t*>(keys),
              static_cast<const int32_t*>(offsets),
              {static_cast<float*>(part0), static_cast<float*>(part1)},
              {static_cast<int32_t*>(keys0), static_cast<int32_t*>(keys1)},
              static_cast<float*>(out), E, S, d, L, group, R1, RL, sms,
              static_cast<cudaStream_t>(stream)};
  const cudaError_t err = vec == 4 ? launch_table_u<4>(per, a)
                                   : launch_table_u<1>(per, a);
  return static_cast<int>(err);
}

const char* embedding_bag_grad_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
