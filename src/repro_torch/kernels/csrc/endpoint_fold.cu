// Live walk-endpoint fold as an order-free fixed-point sum.
//
//   out[b, t] = sum_i w[b,i] * [pos[b,i] == t]
//
// pos (B, W) int32 holds each walk lane's endpoint, weights (B, W) float32
// its weight (r_sum / active on the active lanes, 0 beyond). Built with
// nvcc into a shared library with a plain C interface and called through
// ctypes from repro_torch/kernels/endpoint_fold.py, which checks every
// argument first.
//
// This is the JAX package's segment_sum of the live walk phase
// (repro/ppr/random_walk.py, residual_walks and source_walks), an XLA op,
// not a Pallas kernel; the port's plain version is index_add_, which sums
// with float atomics on a card, so its last bits change from run to run.
// Here every lane's weight becomes an integer on a scale set by its row,
// and the integers are added with 64-bit integer atomics: an integer sum
// has the same bits in any order, so a second launch, another grid, a
// permutation of a row's lanes or the row's place in a batch give the same
// bits. No float atomics, no sort. A lane of weight 0 (past its row's
// active walks) or with pos outside [0, n) takes no part, in the sums and
// in the scale.
//
// The arithmetic (kernels/ref.py, endpoint_fold_fixed_ref, repeats it step
// by step in torch and gives these bits exactly):
// * M = the largest weight of a row's lanes that take part, E its biased
//   float32 exponent (M's bits >> 23, 0 where no lane takes part), so that
//   M < 2^e with e = E - 126; l = ceil(log2 W);
// * the row's scale S = 2^s with s = 62 - l - e = 188 - l - E;
// * a lane's q = round-half-even(double(w) * 2^s), an int64: the product
//   is exact (a power of two), so this rounding is the lane's only one;
// * a cell's sum Q = sum of its lanes' q, exact in int64;
// * out = float32(double(Q) * 2^-s): int64 to float64 to nearest, an exact
//   product, float64 to float32 to nearest.
//
// Range: w < 2^e gives w * 2^s < 2^(62 - l), so q <= 2^(62 - l), and the W
// <= 2^l lanes of a row sum to at most 2^62: no cell overflows int64.
//
// Error bound. A lane's rounding is at most half a unit, 2^-(s+1) =
// 2^(e + l - 63) in weight units (and at most w itself, which rounds to 0
// below half a unit). A cell of k lanes is off by at most
// k * 2^(e + l - 63) before its two final roundings (2^-53 and 2^-24 of
// the result). For a row whose weights are all equal (or 0), w >= 2^(e-1)
// and every lane rounds alike, so the relative error is at most
// 2^(l - 62) + 2^-53 + 2^-24: about 6.0e-8 at l = 22. Every path of the
// port gives such rows: r_sum / w_eff on the active lanes and 0 beyond
// (random_walk.py lane_weights, fora.py), 0 where the walk index covers a
// lane, 1/W in Monte Carlo PPR.
// For other weights the bound is absolute: with k <= W <= 2^l and the
// largest output >= M >= 2^(e-1), a cell's error is at most 2^(2l - 62)
// of the largest output: 2^-22 = 2.4e-7 at l = 20 (the paper path), 2^-20
// = 9.5e-7 at l = 21, both under chip_smoke.py's ATOL_FRAC of 1e-6. At
// l = 22 (2^22 lanes, the lane cap reached on the Pokec-order path) the
// bound is 3.8e-6: a row of mixed weights that puts more than 2^20 lanes,
// each of a weight near half a unit (about 2^(e - 41)), into one cell can
// pass ATOL_FRAC. The design does not guard against that row (a second
// word a cell would, at twice the atomics); the input class for which
// the check's limit is guaranteed is therefore: any finite nonnegative
// weights up to W = 2^21 lanes, and rows of equal weights at any W.
//
// The kernels, three a call:
// 1. scale_rows, a block a slice of a row: the largest participating
//    weight's bits of its lanes (float bits order as integers for
//    nonnegative floats) to parts[b, g], and zeros of its slice of the
//    (B, n) int64 sums. No atomics, no memset.
// 2. add_lanes, a block a span of kSpan lanes of a row: it reduces the
//    row's parts to s (block 0 stores s for step 3), then each thread
//    takes kPer lanes, a warp 32 consecutive lanes at a time (the walks'
//    starts are stratified, so neighbouring lanes often end at one node).
//    Lanes of one cell within a warp combine by __match_any_sync and an
//    exact int64 sum (three 21-bit limbs, each added by
//    __reduce_add_sync). The first of them then adds the sum to the
//    block's table of kTable cells in shared memory (twice the block's
//    lanes, linear probes), or with a global 64-bit atomicAdd where its
//    cell has no slot. A cell claims a slot where two lanes of a warp
//    share it, or on one lane in 2^kSampleBits (by the lane's index);
//    other lanes only look for the cell's slot. So a cell that many lanes
//    reach (a hub, the walks' popular endpoints) soon has a slot and
//    takes one global atomic a block, while a cell met once costs one
//    global atomic and a shared load: on the H100 a shared atomic costs
//    more than a global one to a distinct address, so a table that every
//    lane claims into is slower on uniform endpoints, while global atomics
//    alone queue on a popular cell (python3 tools/fold_probe.py --variants
//    times these choices). The 64-bit shared adds are two 32-bit atomics
//    and a carry (a 64-bit shared atomicAdd compiles to a compare-and-swap
//    loop). The block then adds its table's cells to the global sums.
// 3. write_out, a thread a cell: the float conversion above, every cell
//    written once, zeros included.
//
// What bounds it on the H100: bytes. The function reads pos and the
// weights once (8 bytes a lane) and writes the (B, n) output once. This
// design reads the lanes twice (steps 1 and 2: 16 bytes a lane; step 2
// streams them past L2) and writes, adds to and reads back 8 bytes a cell
// of sums, which stay in the 50 MB L2 (2.3 MB a row at the paper path's
// n). What it reaches is set by L2's atomics: one global atomic a lane on
// uniform endpoints, fewer but queued on the walks' own, where popular
// cells that no slot caught still meet on one address.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                   // lanes a thread of add_lanes takes
constexpr int kSpan = kThreads * kPer;    // lanes a block of add_lanes: 4,096
constexpr int kMaxParts = 256;            // scale_rows blocks a row, at most
static_assert(kMaxParts <= kThreads, "add_lanes reads a part a thread");
constexpr int kSampleBits = 1;            // a lone lane claims 1 time in 2
constexpr int kTableBits = 13;
constexpr int kTable = 1 << kTableBits;   // cells of a block's table: 8,192
constexpr int kTableBytes = kTable * (8 + 4);
constexpr int kProbes = 32;
constexpr int kOutPer = 4;                // cells a thread of write_out
constexpr int kLimb = 21;                 // bits of a limb of q
constexpr unsigned long long kLimbMask = (1ull << kLimb) - 1;

// The lane's cell, or -1 where it takes no part.
__device__ __forceinline__ int cell_of(int p, float w, int n) {
  return (w > 0.f && p >= 0 && p < n) ? p : -1;
}

// 2^k as a double, exact, for -1022 <= k <= 1023.
__device__ __forceinline__ double pow2(int k) {
  return __longlong_as_double(static_cast<long long>(k + 1023) << 52);
}

// The largest of the block's values; valid in thread 0.
__device__ __forceinline__ unsigned block_max(unsigned v, unsigned* warp_max) {
  v = __reduce_max_sync(0xffffffffu, v);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? warp_max[lane] : 0u;
    v = __reduce_max_sync(0xffffffffu, v);
  }
  return v;
}

// Slice blockIdx.x of row blockIdx.y: lanes [g * lanes, (g + 1) * lanes)
// and cells [g * cells, (g + 1) * cells).
__global__ void __launch_bounds__(kThreads)
scale_rows(const int32_t* __restrict__ pos, const float* __restrict__ weights,
           unsigned* __restrict__ parts, unsigned long long* __restrict__ sums,
           int n, int W, int lanes, int cells) {
  __shared__ unsigned warp_max[kWarps];
  const int g = blockIdx.x;
  const long long row = blockIdx.y;
  const long long lo = static_cast<long long>(g) * lanes;
  const long long hi = min(static_cast<long long>(W), lo + lanes);
  unsigned m = 0u;
#pragma unroll 4
  for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
    const float w = weights[row * W + i];
    if (cell_of(pos[row * W + i], w, n) >= 0) m = max(m, __float_as_uint(w));
  }
  const long long c_hi = min(static_cast<long long>(n),
                             static_cast<long long>(g + 1) * cells);
  for (long long c = static_cast<long long>(g) * cells + threadIdx.x;
       c < c_hi; c += kThreads) {
    sums[row * n + c] = 0ull;
  }
  m = block_max(m, warp_max);
  if (threadIdx.x == 0) parts[row * gridDim.x + g] = m;
}

// A lane's integer, round-half-even(w * 2^s): the product is exact.
__device__ __forceinline__ unsigned long long lane_q(float w, double scale) {
  return static_cast<unsigned long long>(
      __double2ll_rn(__dmul_rn(static_cast<double>(w), scale)));
}

// The exact sum of q over the lanes of `peers` (all of them call it).
__device__ __forceinline__ unsigned long long group_sum(unsigned peers,
                                                        unsigned long long q) {
  const unsigned long long s0 = __reduce_add_sync(
      peers, static_cast<unsigned>(q & kLimbMask));
  const unsigned long long s1 = __reduce_add_sync(
      peers, static_cast<unsigned>((q >> kLimb) & kLimbMask));
  const unsigned long long s2 = __reduce_add_sync(
      peers, static_cast<unsigned>(q >> (2 * kLimb)));
  return s0 + (s1 << kLimb) + (s2 << (2 * kLimb));
}

__device__ __forceinline__ int table_slot(int cell) {
  return static_cast<int>((static_cast<unsigned>(cell) * 2654435761u)
                          >> (32 - kTableBits));
}

// value += q in shared memory as two 32-bit atomics and the low word's
// carry (a 64-bit shared atomicAdd compiles to a compare-and-swap loop):
// the two words hold the sum mod 2^64 exactly, in any order.
__device__ __forceinline__ void table_add(unsigned long long* value,
                                          unsigned long long q) {
  unsigned* word = reinterpret_cast<unsigned*>(value);
  const unsigned lo = static_cast<unsigned>(q);
  const unsigned old = atomicAdd(word, lo);
  atomicAdd(word + 1, static_cast<unsigned>(q >> 32) + (old + lo < old));
}

// Adds q to cell c's slot of the block's table and returns true, or
// returns false where the cell has none. A cell that `claims` takes a free
// slot on its way (up to kProbes linear probes); one that does not only
// looks for a slot that another cell's lanes claimed before.
__device__ __forceinline__ bool table_put(int* key,
                                          unsigned long long* value, int c,
                                          unsigned long long q, bool claims) {
  int j = table_slot(c);
  for (int t = 0; t < kProbes; ++t) {
    const int held = claims ? atomicCAS(&key[j], -1, c)
                            : *static_cast<volatile int*>(&key[j]);
    if (held == c || (claims && held == -1)) {
      table_add(&value[j], q);
      return true;
    }
    if (held == -1) return false;
    j = (j + 1) & (kTable - 1);
  }
  return false;
}

// Span blockIdx.x of row blockIdx.y: lanes [x * kSpan, (x + 1) * kSpan).
__global__ void __launch_bounds__(kThreads)
add_lanes(const int32_t* __restrict__ pos, const float* __restrict__ weights,
          const unsigned* __restrict__ parts, int nparts,
          int* __restrict__ shift, unsigned long long* __restrict__ sums,
          int n, int W, int log_w) {
  extern __shared__ __align__(16) unsigned long long value[];  // kTable
  int* key = reinterpret_cast<int*>(value + kTable);           // kTable
  __shared__ unsigned warp_max[kWarps];
  __shared__ int row_shift;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const long long row = blockIdx.y;
  const long long first = static_cast<long long>(blockIdx.x) * kSpan;

  // the row's lanes in flight while the scale is reduced
  int p[kPer];
  float w[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const long long i = first + k * kThreads + tid;
    p[k] = i < W ? __ldcs(pos + row * W + i) : -1;
    w[k] = i < W ? __ldcs(weights + row * W + i) : 0.f;
  }
  const unsigned m = block_max(
      tid < nparts ? parts[row * nparts + tid] : 0u, warp_max);
  if (tid == 0) {
    row_shift = 188 - log_w - static_cast<int>(m >> 23);
    if (blockIdx.x == 0) shift[row] = row_shift;
  }
  for (int j = tid; j < kTable; j += kThreads) {
    key[j] = -1;
    value[j] = 0ull;
  }
  __syncthreads();
  const double scale = pow2(row_shift);
  unsigned long long* out = sums + row * n;

#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int c = cell_of(p[k], w[k], n);
    const unsigned peers = __match_any_sync(0xffffffffu, c);
    if (c < 0) continue;
    const int count = __popc(peers);
    unsigned long long q = lane_q(w[k], scale);
    if (count > 1) q = group_sum(peers, q);
    if (lane != __ffs(peers) - 1) continue;
    // a cell that two lanes of a warp share claims a slot, as does a lone
    // lane one time in 2^kSampleBits (by its index), so that a cell that
    // many lanes reach finds one soon; the others only look for a slot
    const unsigned i = static_cast<unsigned>(first + k * kThreads + tid);
    const bool claims =
        count > 1 || (i * 2654435761u) >> (32 - kSampleBits) == 0u;
    if (!table_put(key, value, c, q, claims)) atomicAdd(&out[c], q);
  }
  __syncthreads();
  for (int j = tid; j < kTable; j += kThreads) {
    if (key[j] >= 0) atomicAdd(&out[key[j]], value[j]);
  }
}

// Cells [x * kOutPer * kThreads, ...) of row blockIdx.y.
__global__ void __launch_bounds__(kThreads)
write_out(const unsigned long long* __restrict__ sums,
          const int* __restrict__ shift, float* __restrict__ out, int n) {
  const long long row = blockIdx.y;
  const double inv = pow2(-shift[row]);
  const long long first =
      static_cast<long long>(blockIdx.x) * kOutPer * kThreads + threadIdx.x;
#pragma unroll
  for (int k = 0; k < kOutPer; ++k) {
    const long long c = first + k * kThreads;
    if (c < n) {
      const double x =
          __ll2double_rn(static_cast<long long>(sums[row * n + c]));
      out[row * n + c] = __double2float_rn(__dmul_rn(x, inv));
    }
  }
}

}  // namespace

extern "C" {

// out (B, n) f32; sums (B, n) i64, parts (B, nparts) u32 and shift (B,)
// i32 are caller-allocated scratch, none of them initialised;
// (nparts, log_w) = endpoint_fold.fold_scratch(n, W), log_w = ceil(log2 W).
int endpoint_fold_launch(const void* pos, const void* weights, void* sums,
                         void* parts, void* shift, void* out, int n, int W,
                         int B, int nparts, int log_w, void* stream) {
  if (n < 1 || W < 1 || B < 1 || B > 65535 || nparts < 1
      || nparts > kMaxParts || log_w < 0 || log_w > 31
      || (1ll << log_w) < W || (log_w > 0 && (1ll << (log_w - 1)) >= W)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int lanes = static_cast<int>((W + nparts - 1ll) / nparts);
  const int cells = static_cast<int>((n + nparts - 1ll) / nparts);
  const int spans = static_cast<int>((W + kSpan - 1ll) / kSpan);
  const int per_block = kOutPer * kThreads;
  const int out_blocks = static_cast<int>((n + per_block - 1ll) / per_block);
  auto* sum64 = static_cast<unsigned long long*>(sums);
  scale_rows<<<dim3(nparts, B), kThreads, 0, s>>>(
      static_cast<const int32_t*>(pos), static_cast<const float*>(weights),
      static_cast<unsigned*>(parts), sum64, n, W, lanes, cells);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      add_lanes, cudaFuncAttributeMaxDynamicSharedMemorySize, kTableBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  add_lanes<<<dim3(spans, B), kThreads, kTableBytes, s>>>(
      static_cast<const int32_t*>(pos), static_cast<const float*>(weights),
      static_cast<const unsigned*>(parts), nparts,
      static_cast<int*>(shift), sum64, n, W, log_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  write_out<<<dim3(out_blocks, B), kThreads, 0, s>>>(
      sum64, static_cast<const int*>(shift), static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

const char* endpoint_fold_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
