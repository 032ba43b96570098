// What the segment reduction (segment_reduce.cu) and its backward
// (segment_grad.cu) share: the ops and their identities, 32-bit words read
// and written V at a time, the segment a position's key names, and the
// fold over runs of positions that both launch (the forward for its
// output, the backward for max's and min's tie counts; K5's backward,
// embedding_bag_grad.cu, for the table's gradient). It replaces no TPU
// kernel: the JAX package leaves the aggregation to XLA's
// jax.ops.segment_sum/max/min (repro/models/gnn/common.py:44-61). On the
// H100 the fold is bound by the bytes of the rows it reads; what follows
// is how it keeps them streaming: equal work a group, no serial tail on a
// long segment, no register spills, 16-byte units where the rows allow.
//
// The fold over runs (fold_runs), one kernel a level. A level sees n
// positions, each with a key (the segment it belongs to) and, where the
// key says so, a row of d words. The positions are cut into runs of R
// consecutive positions, one run a group of lanes, whatever the segments'
// lengths, so that no warp waits on its longest segment. A group folds
// its run left to right and writes each segment that starts and ends in
// it to its output row. A segment that crosses the run's start or end
// leaves a partial in one of the run's two slots of the block's shared
// table instead: slot 2g the part that entered the run from the left,
// slot 2g + 1 the part of the one that leaves it to the right (where one
// segment covers the whole run, slot 2g holds the run's fold and slot
// 2g + 1 a "phantom" key of it with no row, so that a segment's slots are
// consecutive). The block then folds its table left to right in the same
// way, a chain of a segment's slots by the run where the segment ends,
// writing the segments that end in the block and leaving the block's two
// open parts in the next level's slots 2 blk and 2 blk + 1. The next
// level folds those slots, in runs of its own length, until one block
// holds them all: a segment of any length (the models' trash segment of
// masked edges) is folded by every group and block its positions touch
// and by a fixed tree of later levels, whose shape
// depends on the plan, E and d alone (kernels/segment_reduce.py,
// levels()), never by one group of lanes over all its partials.
//
// Keys. Level 1 reads the plan's keys, the sorted segment index clamped
// to [-1, S]: -1 and S name no segment (an edge outside [0, S)). A slot's
// key at a later level is its segment s >= 0, -1 for an unused slot, or
// -(s + 2) for a phantom of s.
//
// The lanes. A row of d words is d / V units of V = 4 or 1 words; a group
// of lanes (a power of two, a warp where the row is wide) takes a run,
// lane l holding units c0 + l + j * group for j < U of each chunk of
// group * U units at c0. U (1, 2 or 4) is the units a lane really holds,
// so a narrow row does not reserve registers for four. A lane issues the
// loads of K positions before it folds them (K * U * V <= 16 words); on
// the gathered route it loads the next batch's order entries and keys
// while it folds, on a stream it loads a batch's keys beside its rows.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <type_traits>

namespace segment {

constexpr int kThreads = 256;

// Blocks an SM for __launch_bounds__: 4 (at most 64 registers) for a
// stream of narrow rows, 3 (85) where a lane also holds the gathered
// route's next order entries or the tie counts' reference row, 2 (128)
// where it holds 16 words a unit set; no variant spills.
template <bool GATHER, bool TIES, int U, int V>
__host__ __device__ constexpr int min_blocks() {
  return U * V >= 16 ? 2 : ((GATHER || TIES || U * V > 4) ? 3 : 4);
}

enum Op { kSum = 0, kMax = 1, kMin = 2 };

// K: positions whose rows a lane loads together (K * U * V <= 16 words).
template <int U, int V>
__host__ __device__ constexpr int batch() {
  return 16 / (U * V) > 8 ? 8 : (16 / (U * V) < 1 ? 1 : 16 / (U * V));
}

template <typename T, int V>
struct Vec {
  T v[V];
};

template <typename T>
__device__ __forceinline__ T from_bits(int w) {
  if constexpr (std::is_same<T, float>::value) {
    return __int_as_float(w);
  } else {
    return w;
  }
}

template <typename T>
__device__ __forceinline__ int to_bits(T x) {
  if constexpr (std::is_same<T, float>::value) {
    return __float_as_int(x);
  } else {
    return x;
  }
}

// V (4 or 1) 32-bit words at p (aligned to 4 * V bytes), through the
// read-only path.
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_vec(const T* p) {
  Vec<T, V> u;
  const int* w = reinterpret_cast<const int*>(p);
  if constexpr (V == 4) {
    const int4 t = __ldg(reinterpret_cast<const int4*>(w));
    u.v[0] = from_bits<T>(t.x);
    u.v[1] = from_bits<T>(t.y);
    u.v[2] = from_bits<T>(t.z);
    u.v[3] = from_bits<T>(t.w);
  } else {
    u.v[0] = from_bits<T>(__ldg(w));
  }
  return u;
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const Vec<T, V>& a) {
  int* w = reinterpret_cast<int*>(p);
  if constexpr (V == 4) {
    *reinterpret_cast<int4*>(w) = make_int4(to_bits(a.v[0]), to_bits(a.v[1]),
                                            to_bits(a.v[2]), to_bits(a.v[3]));
  } else {
    *w = to_bits(a.v[0]);
  }
}

template <int OP>
__device__ __forceinline__ float identity() {
  if constexpr (OP == kMax) {
    return -CUDART_INF_F;
  } else if constexpr (OP == kMin) {
    return CUDART_INF_F;
  } else {
    return 0.0f;
  }
}

template <int OP, typename T>
__device__ __forceinline__ T combine(T a, T b) {
  if constexpr (OP == kMax) {
    return fmaxf(a, b);
  } else if constexpr (OP == kMin) {
    return fminf(a, b);
  } else {
    return a + b;
  }
}

// The segment a key names, or -1 for none (level 1: -1 and S; later
// levels: -1; a phantom -(s + 2) names s).
__device__ __forceinline__ int segment_of(int key, int S) {
  if (key >= 0) return key < S ? key : -1;
  return key == -1 ? -1 : -key - 2;
}

// Whether the key's position has a row to fold.
__device__ __forceinline__ bool has_row(int key, int S) {
  return key >= 0 && key < S;
}

// The ints a[p .. p + K - 1] below end (-1 past it), as 16-byte loads
// where the batch is whole (p is a multiple of K from a run start, itself
// a multiple of R, so 16-byte aligned for K >= 4).
template <int K>
__device__ __forceinline__ void load_ints(const int32_t* __restrict__ a,
                                          int64_t p, int64_t end,
                                          int (&out)[K]) {
  if constexpr (K >= 4) {
    if (p + K <= end) {
#pragma unroll
      for (int u = 0; u < K; u += 4) {
        const int4 t = __ldg(reinterpret_cast<const int4*>(a + p + u));
        out[u] = t.x;
        out[u + 1] = t.y;
        out[u + 2] = t.z;
        out[u + 3] = t.w;
      }
      return;
    }
  }
#pragma unroll
  for (int u = 0; u < K; ++u) out[u] = p + u < end ? __ldg(a + p + u) : -1;
}

// The lane's units of a row of d words at dst, from acc.
template <typename T, int U, int V>
__device__ __forceinline__ void store_units(T* __restrict__ dst,
                                            const Vec<T, V> (&acc)[U], int c0,
                                            int l, int group, int units) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int c = c0 + l + j * group;
    if (c < units) store_vec<T, V>(dst + c * V, acc[j]);
  }
}

template <typename T, int U, int V>
__device__ __forceinline__ void fill_units(Vec<T, V> (&acc)[U], T value) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
#pragma unroll
    for (int k = 0; k < V; ++k) acc[j].v[k] = value;
  }
}

// A slot of the block's shared table: the chunk's group * U units of V
// words, lane l's units at l + j * group.
template <typename T, int U, int V>
__device__ __forceinline__ void put_slot(T* slot, const Vec<T, V> (&acc)[U],
                                         int c0, int l, int group,
                                         int units) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = l + j * group;
    if (c0 + u < units) {
#pragma unroll
      for (int k = 0; k < V; ++k) slot[u * V + k] = acc[j].v[k];
    }
  }
}

// acc op= the lane's units of a shared slot.
template <int OP, typename T, int U, int V>
__device__ __forceinline__ void fold_slot(Vec<T, V> (&acc)[U], const T* slot,
                                          int c0, int l, int group,
                                          int units) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = l + j * group;
    if (c0 + u < units) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        acc[j].v[k] = combine<OP, T>(acc[j].v[k], slot[u * V + k]);
      }
    }
  }
}

// The fold of one level (see the header). OP is the op; TIES (level 1 of
// max's and min's backward) counts, as int, the row's words equal to the
// forward's output ref[s] instead of folding them. In is the rows' type
// (float at level 1, T at later levels), T the accumulators' and the
// outputs'. GATHER: the row of position p is rows[p] (the plan's order,
// level 1 of the gathered route); otherwise p. part/part_keys: the next
// level's slots, two a block, nullptr at the last level (one block).
// offsets: level 1 of the forward, to write the op's identity to every
// empty segment; nullptr otherwise. BAG (level 1 of K5's table gradient,
// embedding_bag_grad.cu; GATHER too): the plan is of the flat (B * L) ids
// and its order names flat positions r = b * bag_len + l, so position p's
// row is the product scale[r] * src[r / bag_len] (w[b, l] g[b]), formed as
// it is loaded: no (B * L, d) rows are written first.
//
// Two stages a column chunk. The groups: group g of the block folds run
// blk * G + g (R positions) left to right, writes the segments that start
// and end in it to out, and leaves the part of the segment that entered
// from the left in the block's shared slot 2g and the part of the one that
// leaves to the right in 2g + 1 (the whole run's fold in 2g and a phantom
// in 2g + 1 where one segment covers it). The block: the parts of a
// segment in consecutive runs (a chain of shared slots) are folded left to
// right by the run where it ends, and the chain leaving the block to the
// right by the block's last run; a chain that entered the block from the
// left, or leaves it, goes to the next level's slots 2 blk and 2 blk + 1,
// the others to out. The same order as one left fold of the block's
// slots, with no group waiting on another's chain.
template <int OP, bool TIES, bool GATHER, typename In, typename T, int U,
          int V, bool BAG = false>
__device__ __forceinline__ void fold_runs(
    const In* __restrict__ src, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ keys, const float* __restrict__ ref,
    T* __restrict__ out, T* __restrict__ part, int32_t* __restrict__ part_keys,
    const int32_t* __restrict__ offsets, int64_t n, int S, int d, int R,
    int group, const float* __restrict__ scale = nullptr, int bag_len = 1) {
  static_assert(!BAG || (GATHER && !TIES), "a bag's rows are gathered sums");
  constexpr int K = batch<U, V>();
  __shared__ T slot_rows[2 * kThreads * U * V];
  __shared__ int slot_keys[2 * kThreads];
  __shared__ int block_open[2];
  const T ident = static_cast<T>(identity<TIES ? kSum : OP>());
  const int lane = threadIdx.x & 31;
  const int l = lane % group;
  const int G = kThreads / group;
  const int g = threadIdx.x / group;
  const int64_t blk = blockIdx.x;
  const int64_t run = blk * G + g;
  const int64_t a = run * R;
  const bool active = a < n;
  const int64_t first_run_end = blk * G * R;
  const int runs_here = static_cast<int>(
      n - first_run_end >= static_cast<int64_t>(G) * R
          ? G : (n - first_run_end + R - 1) / R);
  const int units = d / V;
  const int width = group * U * V;      // words a shared slot
  const int64_t b = active ? (a + R < n ? a + R : n) : a;
  int first_seg = -1;
  int last_seg = -1;
  bool left_open = false;
  bool right_open = false;
  if (active) {
    first_seg = segment_of(__ldg(keys + a), S);
    left_open = a > 0 && first_seg >= 0
        && segment_of(__ldg(keys + a - 1), S) == first_seg;
    last_seg = segment_of(__ldg(keys + b - 1), S);
    right_open = b < n && last_seg >= 0
        && segment_of(__ldg(keys + b), S) == last_seg;
    if (l == 0) {
      slot_keys[2 * g] = -1;
      slot_keys[2 * g + 1] = -1;
      if (g == 0) block_open[0] = left_open;
      if (g == runs_here - 1) block_open[1] = right_open;
    }
  }
  for (int c0 = 0; c0 < units; c0 += group * U) {
    if (active) {
      Vec<T, V> acc[U];
      Vec<float, V> o[U];       // TIES: the current segment's output
      fill_units<T, U, V>(acc, ident);
      int cur = first_seg;
      bool head = left_open;    // cur entered the run from the left
      if constexpr (TIES) {
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const int c = c0 + l + j * group;
          if (cur >= 0 && c < units) {
            o[j] = load_vec<float, V>(ref + static_cast<int64_t>(cur) * d
                                      + c * V);
          }
        }
      }
      int key[K];
      int row[K];
      if constexpr (GATHER) {
        load_ints<K>(keys, a, b, key);
        load_ints<K>(rows, a, b, row);
      }
      for (int64_t p = a; p < b; p += K) {
        // a stream loads the batch's keys beside its rows, whatever the
        // keys (a slot without a row is read and not folded)
        if constexpr (!GATHER) load_ints<K>(keys, p, b, key);
        Vec<In, V> x[K][U];
#pragma unroll
        for (int u = 0; u < K; ++u) {
          if (GATHER ? has_row(key[u], S) : p + u < b) {
            const int64_t r = GATHER ? row[u] : p + u;
            // a bag's row: a 32-bit quotient (order entries are int32)
            const In* base = src + (BAG ? static_cast<int64_t>(row[u]
                                                           / bag_len)
                                        : r) * d;
#pragma unroll
            for (int j = 0; j < U; ++j) {
              const int c = c0 + l + j * group;
              if (c < units) x[u][j] = load_vec<In, V>(base + c * V);
            }
            if constexpr (BAG) {
              // __fmul_rn: a product rounded on its own, never contracted
              // into the fold's add, so the terms are the float32 products
              // w[r] * g[r / L] and dT has segment_reduce's bits on them
              const float w = __ldg(scale + r);
#pragma unroll
              for (int j = 0; j < U; ++j) {
#pragma unroll
                for (int k = 0; k < V; ++k)
                  x[u][j].v[k] = __fmul_rn(x[u][j].v[k], w);
              }
            }
          }
        }
        // a position past the run's end keeps the current segment
        int seg[K];
        bool rowed[K];
#pragma unroll
        for (int u = 0; u < K; ++u) {
          seg[u] = p + u < b ? segment_of(key[u], S) : -2;
          rowed[u] = p + u < b && has_row(key[u], S);
        }
        // the gathered route: the next batch's keys and order entries,
        // while this one folds
        if constexpr (GATHER) {
          if (p + K < b) {
            load_ints<K>(keys, p + K, b, key);
            load_ints<K>(rows, p + K, b, row);
          }
        }
        // the common batch: every position a row of the current segment
        bool uniform = cur >= 0;
#pragma unroll
        for (int u = 0; u < K; ++u) {
          uniform = uniform && seg[u] == cur && rowed[u];
        }
        if (uniform) {
#pragma unroll
          for (int u = 0; u < K; ++u) {
#pragma unroll
            for (int j = 0; j < U; ++j) {
#pragma unroll
              for (int k = 0; k < V; ++k) {
                if constexpr (TIES) {
                  acc[j].v[k] += x[u][j].v[k] == o[j].v[k] ? 1 : 0;
                } else {
                  acc[j].v[k] = combine<OP, T>(acc[j].v[k], x[u][j].v[k]);
                }
              }
            }
          }
          continue;
        }
#pragma unroll
        for (int u = 0; u < K; ++u) {
          if (seg[u] != -2 && seg[u] != cur) {
            if (cur >= 0) {
              if (head) {
                put_slot<T, U, V>(slot_rows + 2 * g * width, acc, c0, l,
                                  group, units);
                if (l == 0) slot_keys[2 * g] = cur;
              } else {
                store_units<T, U, V>(out + static_cast<int64_t>(cur) * d,
                                     acc, c0, l, group, units);
              }
            }
            head = false;
            cur = seg[u];
            fill_units<T, U, V>(acc, ident);
            if constexpr (TIES) {
#pragma unroll
              for (int j = 0; j < U; ++j) {
                const int c = c0 + l + j * group;
                if (cur >= 0 && c < units) {
                  o[j] = load_vec<float, V>(
                      ref + static_cast<int64_t>(cur) * d + c * V);
                }
              }
            }
          }
          if (rowed[u]) {
#pragma unroll
            for (int j = 0; j < U; ++j) {
#pragma unroll
              for (int k = 0; k < V; ++k) {
                if constexpr (TIES) {
                  acc[j].v[k] += x[u][j].v[k] == o[j].v[k] ? 1 : 0;
                } else {
                  acc[j].v[k] = combine<OP, T>(acc[j].v[k], x[u][j].v[k]);
                }
              }
            }
          }
        }
      }
      if (cur >= 0) {
        if (right_open) {
          // the segment leaving to the right: slot 2g + 1, or slot 2g with
          // a phantom in 2g + 1 where it also entered from the left
          put_slot<T, U, V>(slot_rows + (2 * g + (head ? 0 : 1)) * width,
                            acc, c0, l, group, units);
          if (l == 0) {
            if (head) slot_keys[2 * g] = cur;
            slot_keys[2 * g + 1] = head ? -cur - 2 : cur;
          }
        } else if (head) {
          put_slot<T, U, V>(slot_rows + 2 * g * width, acc, c0, l, group,
                            units);
          if (l == 0) slot_keys[2 * g] = cur;
        } else {
          store_units<T, U, V>(out + static_cast<int64_t>(cur) * d, acc, c0,
                               l, group, units);
        }
      }
    }
    __syncthreads();
    // the block: each chain of shared slots (a segment's parts in
    // consecutive runs) is folded left to right by the run where it ends,
    // and the one leaving the block to the right by the block's last run
    if (g < runs_here) {
      const int left_key = slot_keys[2 * g];
      const int right_key = slot_keys[2 * g + 1];
      const bool whole = right_key <= -2;
      const bool last = g == runs_here - 1;
      if ((left_key >= 0 && !whole) || (last && right_key != -1)) {
        // the first run of the chain: past the whole runs to the left
        int j = g - 1;
        while (j >= 0 && slot_keys[2 * j + 1] <= -2) --j;
        if (left_key >= 0 && !whole) {
          // the chain that entered run g from the left ends in it
          Vec<T, V> acc[U];
          fill_units<T, U, V>(acc, ident);
          if (j >= 0) {
            fold_slot<TIES ? kSum : OP, T, U, V>(acc, slot_rows
                                                 + (2 * j + 1) * width, c0,
                                                 l, group, units);
          }
          for (int k = j + 1; k <= g; ++k) {
            fold_slot<TIES ? kSum : OP, T, U, V>(acc, slot_rows + 2 * k
                                                 * width, c0, l, group,
                                                 units);
          }
          store_units<T, U, V>(j >= 0 ? out + static_cast<int64_t>(left_key)
                                            * d
                                      : part + 2 * blk * d,
                               acc, c0, l, group, units);
          if (j < 0 && l == 0 && c0 == 0) part_keys[2 * blk] = left_key;
        }
        if (last && right_key != -1) {
          // the chain leaving the block to the right
          const int seg_r = segment_of(right_key, S);
          Vec<T, V> acc[U];
          fill_units<T, U, V>(acc, ident);
          if (!whole) {
            fold_slot<TIES ? kSum : OP, T, U, V>(acc, slot_rows
                                                 + (2 * g + 1) * width, c0,
                                                 l, group, units);
          } else {
            if (j >= 0) {
              fold_slot<TIES ? kSum : OP, T, U, V>(acc, slot_rows
                                                   + (2 * j + 1) * width,
                                                   c0, l, group, units);
            }
            for (int k = j + 1; k <= g; ++k) {
              fold_slot<TIES ? kSum : OP, T, U, V>(acc, slot_rows + 2 * k
                                                   * width, c0, l, group,
                                                   units);
            }
          }
          // a block covered by one segment: slot 2 blk and a phantom
          const bool all = whole && j < 0;
          store_units<T, U, V>(part + (2 * blk + (all ? 0 : 1)) * d, acc, c0,
                               l, group, units);
          if (l == 0 && c0 == 0) {
            if (all) part_keys[2 * blk] = seg_r;
            part_keys[2 * blk + 1] = all ? -seg_r - 2 : seg_r;
          }
        }
      }
      if (part_keys != nullptr && l == 0 && c0 == 0) {
        if (g == 0 && block_open[0] == 0) part_keys[2 * blk] = -1;
        if (last && block_open[1] == 0) part_keys[2 * blk + 1] = -1;
      }
    }
    __syncthreads();
  }
  if (offsets == nullptr) return;
  // the empty segments: the op's identity, 32 segments a warp at a time
  const int64_t warp = (static_cast<int64_t>(blockIdx.x) * kThreads
                        + threadIdx.x) >> 5;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * kThreads) >> 5;
  for (int64_t s0 = warp * 32; s0 < S; s0 += warps * 32) {
    const int64_t s = s0 + lane;
    const bool empty = s < S && __ldg(offsets + s) == __ldg(offsets + s + 1);
    unsigned mask = __ballot_sync(0xffffffffu, empty);
    while (mask != 0) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      T* dst = out + (s0 + j) * d;
      for (int c = lane; c < d; c += 32) dst[c] = ident;
    }
  }
}

}  // namespace segment
