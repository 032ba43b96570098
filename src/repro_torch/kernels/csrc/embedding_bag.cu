// Weighted embedding bag (K5), DIN's history pooling:
//
//   out[b, :] = sum_l w[b, l] * table[ids[b, l], :]
//
// table (V, d) float32, contiguous; ids (B, L) int32 and w (B, L) float32,
// each row contiguous, with row strides given (a stride of 0 lets every bag
// read one shared history, as retrieval does, without a copy). out (B, d)
// float32, contiguous. Ids are read as the JAX package's jnp.take reads
// them: an id in [-V, 0) is row id + V, and a bag holding any id outside
// [-V, V) comes out NaN in every column. The ids are not checked on the
// host, which would cost a synchronisation a call. Built with nvcc into a
// shared library with a plain C interface and called through ctypes from
// repro_torch/kernels/embedding_bag.py, which checks every other argument
// first and picks the route and the launch geometry (`route`, `plan`).
//
// The TPU kernel (repro/kernels/embedding_bag.py, _bag_kernel) keeps the
// whole table resident in VMEM and gathers (block_b, d) rows per step of a
// loop over l. DIN's item table is 10M x 18 floats (720 MB), which no
// on-chip memory holds; here each row is read from device memory where it
// lies.
//
// What bounds it on the H100: latency, not bytes. At DIN's shapes a call
// moves 2-6 MB (1-2 us at 3.35 TB/s), but a bag's rows are random reads
// that each cost a whole memory latency (~0.5 us from HBM). A design that
// walks a bag's items one after another pays L latencies a bag (the
// first port did: ~480 ns a step at L = 100). So no route here chains
// reads over l: every row load a bag needs starts before its sum needs
// one, and what is left is a few latencies a bag (ids, then rows) plus the
// fold. Route S then meets a second limit: shared memory hands the lanes
// 32 words a cycle an SM, and each bag reads all L staged rows (B * L * 24
// floats at DIN's d = 18: ~4,650 cycles of each of the card's 132 SMs).
//
// * Route G, `bag_gather` (ids row stride != 0: each bag its own history).
//   A bag gets `bag_warps` warps (enough lanes for its L items, at most
//   8); thread t of the bag takes items t, t + 32 * bag_warps, ... and
//   loads each item's row whole into registers, 32 columns a pass, in
//   8-byte units where d is even and the table 8-byte aligned (`Unit` =
//   float2; 9 loads in flight a thread at d = 18), else 4-byte units. It
//   scales the row by w[b, l] into 32 accumulators. The warp then folds
//   its lanes' accumulators column by column (`fold_columns`), the bag's
//   warps' sums are added in warp order through shared memory, and lane c
//   writes column c. Bags a block (`bags_per_block`) come from the plan,
//   which gives the card at least 2 blocks an SM where B allows (DIN's B =
//   512 at L = 100: 512 blocks of 4 warps).
// * Route S, `bag_shared` (ids row stride 0: one history for every bag,
//   retrieval). A block of 256 threads stages the history's rows in shared
//   memory, 256 items and 32 columns a pass, padded with zeros to a
//   multiple of 8 columns (100 x 24 floats at DIN), while each lane's
//   weights are already in flight. Each group of 8 lanes then sums a bag
//   over the staged rows, lane g taking items g, g + 8, ... (so the
//   group's weight reads are coalesced) and reading each row as float4s;
//   the group folds its 8 lanes (`fold_group`), leaving lane g columns
//   [g C / 8, (g + 1) C / 8). Longer histories fold pass by pass, the
//   passes added in order.
//
// A bad id turns its thread's accumulators to NaN (route G), or the block's
// whole output (route S, where the history is every bag's), so every column
// of the bag comes out NaN whatever thread read it. Each output is summed
// in one fixed order (a lane's items in order, the fold's tree, the warps
// or passes in order) with no atomics: the same bits on every launch.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // a block's, at most, both routes
constexpr int kCols = 32;               // columns a pass, a lane's after a fold
constexpr int kSharedItems = kThreads;  // route S: items staged a pass
constexpr int kGroup = 8;               // route S: lanes a bag
constexpr int kChunk = 16;              // route S: weights a lane loads at once
constexpr int kBagsPerBlock = kThreads / kGroup;  // route S
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_value() {
  return __int_as_float(0x7fc00000);
}

// The row an id names, as jnp.take reads it, or -1 for one outside [-V, V).
__device__ __forceinline__ long long row_of(int32_t id, int V) {
  if (id < -V || id >= V) return -1;
  return id < 0 ? static_cast<long long>(id) + V : id;
}

// Sums v[c] over a group of 2 * O lanes (those whose indices differ only in
// bits O, O / 2, ..., 1) for each of the N columns c, and leaves N / (2 *
// O) of the sums in v[0, N / (2 * O)) of each lane: lane g of the group
// holds columns [g * N / (2 * O), (g + 1) * N / (2 * O)). At each halving
// a lane keeps half of its columns and sends the other half to the lane
// whose index differs in that bit, so every column is added up in one
// fixed tree (N - N / (2 * O) shuffles a lane in all).
template <int O, int N, int M>
__device__ __forceinline__ void fold_group(float (&v)[M], int lane) {
  constexpr int H = N / 2;
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    const float send = upper ? v[j] : v[j + H];
    const float keep = upper ? v[j + H] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, O);
  }
  if constexpr (O > 1) fold_group<O / 2, H>(v, lane);
}

// Sums v[c] over the warp's 32 lanes for every column c and returns column
// `lane`'s sum (31 shuffles a warp).
__device__ __forceinline__ float fold_columns(float (&v)[kCols], int lane) {
  fold_group<16, kCols>(v, lane);
  return v[0];
}

__device__ __forceinline__ void fma_unit(float* v, float wt, float r) {
  v[0] = fmaf(wt, r, v[0]);
}

__device__ __forceinline__ void fma_unit(float* v, float wt, float2 r) {
  v[0] = fmaf(wt, r.x, v[0]);
  v[1] = fmaf(wt, r.y, v[1]);
}

template <typename Unit>
__global__ void __launch_bounds__(kThreads)
bag_gather(const float* __restrict__ table, const int32_t* __restrict__ ids,
           const float* __restrict__ w, float* __restrict__ out, int B, int L,
           int V, int d, long long ids_stride, long long w_stride,
           int bag_warps, int bags_per_block) {
  constexpr int kWidth = sizeof(Unit) / sizeof(float);
  constexpr int kUnits = kCols / kWidth;
  __shared__ float part[kThreads / 32][kCols];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int bag_threads = bag_warps * 32;
  const int t = threadIdx.x % bag_threads;        // thread within its bag
  const long long b = static_cast<long long>(blockIdx.x) * bags_per_block
                      + threadIdx.x / bag_threads;
  const bool live = b < B;
  for (int c0 = 0; c0 < d; c0 += kCols) {
    const int dc = min(kCols, d - c0);            // even when kWidth is 2
    const int units = dc / kWidth;
    float v[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) v[j] = 0.0f;
    if (live) {
      for (int l = t; l < L; l += bag_threads) {
        const long long row = row_of(ids[b * ids_stride + l], V);
        const float wt = w[b * w_stride + l];
        if (row < 0) {
#pragma unroll
          for (int j = 0; j < kCols; ++j) v[j] = nan_value();
          continue;
        }
        const Unit* src =
            reinterpret_cast<const Unit*>(table + row * d + c0);
        Unit r[kUnits];
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          if (u < units) r[u] = __ldg(src + u);
        }
#pragma unroll
        for (int u = 0; u < kUnits; ++u) {
          if (u < units) fma_unit(v + u * kWidth, wt, r[u]);
        }
      }
    }
    part[warp][lane] = fold_columns(v, lane);     // this warp's items
    __syncthreads();
    if (t < 32 && live && lane < dc) {            // the bag's first warp
      float acc = part[warp][lane];
      for (int i = 1; i < bag_warps; ++i) acc += part[warp + i][lane];
      out[b * d + c0 + lane] = acc;
    }
    __syncthreads();
  }
}

// One 32-column pass of route S over columns [c0, c0 + dc), padded to C (a
// multiple of 8) with staged zeros, so each staged row is read as C / 4
// float4s. Group `threadIdx.x / 8` of 8 lanes takes bag b; its lane g
// takes items l0 + g + 8 i of each staged pass [l0, l0 + 256).
template <int C>
__device__ __forceinline__ void shared_pass(
    const float* __restrict__ table, const int32_t* __restrict__ ids,
    const float* __restrict__ w, float* __restrict__ out, int B, int L,
    int V, int d, long long w_stride, int c0, int dc, float* rows,
    long long* rows_of) {
  // row stride in floats: C / 4 + 1 float4s, odd, so 8 lanes' float4
  // reads of 8 consecutive rows fall in different banks
  constexpr int kStride = C + 4;
  constexpr int kPer = C / kGroup;                // columns a lane writes
  const int g = threadIdx.x % kGroup;
  const long long b = static_cast<long long>(blockIdx.x) * kBagsPerBlock
                      + threadIdx.x / kGroup;
  float total[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) total[j] = 0.0f;
  int bad = 0;
  float wt[kChunk];
  // this lane's weights of items l0 + i0 + 8 i, i < kChunk
  auto load = [&](int l0, int i0, int n) {
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int l = i0 + i * kGroup;
      wt[i] = b < B && l < n ? w[b * w_stride + l0 + l] : 0.0f;
    }
  };
  for (int l0 = 0; l0 < L; l0 += kSharedItems) {
    const int n = min(kSharedItems, L - l0);
    load(l0, g, n);                               // in flight while staging
    long long row = 0;
    if (threadIdx.x < n) {
      row = row_of(ids[l0 + threadIdx.x], V);
      rows_of[threadIdx.x] = row;
    }
    bad |= __syncthreads_or(row < 0);
    for (int e = threadIdx.x; e < n * C; e += kThreads) {
      const int l = e / C;
      const int c = e - l * C;
      const long long r = rows_of[l];
      rows[l * kStride + c] = r < 0 || c >= dc ? 0.0f
                                               : table[r * d + c0 + c];
    }
    __syncthreads();
    float v[C];
#pragma unroll
    for (int j = 0; j < C; ++j) v[j] = 0.0f;
    for (int i0 = g; i0 < n; i0 += kGroup * kChunk) {
      if (i0 > g) load(l0, i0, n);
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int l = i0 + i * kGroup;
        if (l < n) {
          const float4* r =
              reinterpret_cast<const float4*>(rows + l * kStride);
#pragma unroll
          for (int q = 0; q < C / 4; ++q) {
            const float4 x = r[q];
            v[4 * q] = fmaf(wt[i], x.x, v[4 * q]);
            v[4 * q + 1] = fmaf(wt[i], x.y, v[4 * q + 1]);
            v[4 * q + 2] = fmaf(wt[i], x.z, v[4 * q + 2]);
            v[4 * q + 3] = fmaf(wt[i], x.w, v[4 * q + 3]);
          }
        }
      }
    }
    fold_group<kGroup / 2, C>(v, g);
#pragma unroll
    for (int j = 0; j < kPer; ++j) total[j] += v[j];
    __syncthreads();                              // rows are staged anew
  }
  if (b < B) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int c = g * kPer + j;
      if (c < dc) out[b * d + c0 + c] = bad ? nan_value() : total[j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bag_shared(const float* __restrict__ table, const int32_t* __restrict__ ids,
           const float* __restrict__ w, float* __restrict__ out, int B, int L,
           int V, int d, long long w_stride) {
  __shared__ __align__(16) float rows[kSharedItems * (kCols + 4)];
  __shared__ long long rows_of[kSharedItems];
  for (int c0 = 0; c0 < d; c0 += kCols) {
    const int dc = min(kCols, d - c0);
    switch ((dc + kGroup - 1) / kGroup) {
      case 1:
        shared_pass<8>(table, ids, w, out, B, L, V, d, w_stride, c0, dc,
                       rows, rows_of);
        break;
      case 2:
        shared_pass<16>(table, ids, w, out, B, L, V, d, w_stride, c0, dc,
                        rows, rows_of);
        break;
      case 3:
        shared_pass<24>(table, ids, w, out, B, L, V, d, w_stride, c0, dc,
                        rows, rows_of);
        break;
      default:
        shared_pass<32>(table, ids, w, out, B, L, V, d, w_stride, c0, dc,
                        rows, rows_of);
    }
  }
}

}  // namespace

extern "C" {

// route 0: bag_gather (vec 2: float2 units, else float); route 1:
// bag_shared, 32 bags a block (ids row 0 is the history; ids_stride, vec,
// bag_warps and bags_per_block unused). Returns a cudaError_t.
int embedding_bag_launch(const void* table, const void* ids,
                         const void* weights, void* out, int B, int L, int V,
                         int d, long long ids_stride, long long w_stride,
                         int route, int vec, int blocks, int bag_warps,
                         int bags_per_block, void* stream) {
  const auto* tab = static_cast<const float*>(table);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* wt = static_cast<const float*>(weights);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    bag_shared<<<blocks, kThreads, 0, s>>>(tab, id, wt, o, B, L, V, d,
                                           w_stride);
  } else if (vec == 2) {
    bag_gather<float2><<<blocks, bags_per_block * bag_warps * 32, 0, s>>>(
        tab, id, wt, o, B, L, V, d, ids_stride, w_stride, bag_warps,
        bags_per_block);
  } else {
    bag_gather<float><<<blocks, bags_per_block * bag_warps * 32, 0, s>>>(
        tab, id, wt, o, B, L, V, d, ids_stride, w_stride, bag_warps,
        bags_per_block);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
