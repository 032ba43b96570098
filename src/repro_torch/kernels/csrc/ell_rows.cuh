// The row kernel shared by the dense pull-form ELL products: K1's push
// sweep (ell_spmm.cu) and K4's power-iteration step (ell_spmv.cu). K2
// (ell_spmm_sliced.cu) takes its first pass, prepare_x, from here too.
//
//   y[b, i] = sum_{j < extent[i]} mask[i,j] * w[i,j] * xT[nbr[i,j], b]
//
// over the dense (rows, K) table: int32 neighbours, bool mask, float32
// weights. xT is (n, B) row-major, so one gather reads B contiguous floats.
// extent[i] is 1 + the last live column of row i (0 for a row with no live
// cell), a constant of the table built once (ell_spmv.py::dense_plan).
//
// Lanes (one warp, 32 lanes): lane = (row, kg, b) with b the fastest index.
// BL = 2^lg_bl lanes cover the batch (B <= 32 in one pass, more in chunks
// of 32), KG = 2^lg_kg lanes stride over the row's units, and the remaining
// 32 / (BL * KG) lane groups take one row each. KG comes from the table's
// extents (the plan's lanes), not from K, so lanes are not spent on padding.
// A unit is kVec = 4 cells read as one 16-byte load of neighbours, one of
// weights and 4 bytes of mask, when K % 4 == 0 and the pointers allow it;
// else one cell. Only the units that hold cells below the row's extent are
// loaded, and a cell at or past the extent is neither gathered nor added,
// whatever its mask byte says.
//
// Each lane loads kUnits units (its units u, u + KG, ...) before it gathers
// any, so up to kUnits * kVec gathers are in flight a lane, and adds them in
// unit order, each 4-cell unit as (t0 + t1) + (t2 + t3). A fixed xor
// butterfly then combines the KG lanes. Every output has one summation
// order for a given (extent, K, B, KG), whatever kUnits: no atomics, the
// same bits on every launch.
//
// The frontier route (K1 at B = 1, ell_rows_frontier): a first pass writes
// xm = f(x) and a bitmap of the frontier over x's n nodes, one bit for each
// group of g nodes, set where any of them has xm != 0. The table may be a
// block of rows (a shard of a node-sharded residency, rows != n): the
// bitmap covers the n sources its cells gather, the rows loop its rows.
// Each block of the rows kernel
// loads the bitmap into shared memory and gathers no cell whose source's
// bit is clear: a skipped term is w * 0, so the bits of the output are the
// plain route's. Two blocks of 1024 threads an SM walk the rows' warps;
// the bitmap takes at most kFrontierBytes a block, so most of the SM's
// 256 KB stays L1, whose room the gathers need.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;

inline int ceil_log2(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// xm[i, b] = f(x[b, i]) for x (B, n) at strides (sb, si), f(v) = v * [v >
// thr[i]] when a threshold is given, else v: FORA's push condition applied
// once a source instead of once a cell, and x laid out (n, B) for the rows'
// gathers.
__global__ void __launch_bounds__(kBlock)
prepare_x(const float* __restrict__ x, const float* __restrict__ thr,
          float* __restrict__ xm, long long sb, long long si, int n, int B) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= static_cast<long long>(n) * B) return;
  const long long i = idx / B;
  const long long b = idx - i * B;
  float v = x[b * sb + i * si];
  if (thr != nullptr && !(v > thr[i])) v = 0.f;
  xm[idx] = v;
}

constexpr int kFrontierBlock = 1024;
constexpr int kFrontierBlocksPerSm = 2;
constexpr int kFrontierBytes = 64 << 10;

// xm[i] = f(x[i * si]) as prepare_x at B = 1, and the frontier bitmap:
// bit k of bits is set where any node of [k g, k g + g) has xm != 0, g =
// 2^lg_g. One thread a group, a warp a 32-bit word.
__global__ void __launch_bounds__(kBlock)
prepare_frontier(const float* __restrict__ x, const float* __restrict__ thr,
                 float* __restrict__ xm, unsigned* __restrict__ bits,
                 long long si, int n, int lg_g) {
  const long long group =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  bool any = false;
  for (int k = 0; k < (1 << lg_g); ++k) {
    const long long i = (group << lg_g) + k;
    if (i < n) {
      float v = x[i * si];
      if (thr != nullptr && !(v > thr[i])) v = 0.f;
      xm[i] = v;
      any = any || v != 0.f;
    }
  }
  // every lane of the warp takes part; a word past the bitmap is not kept
  const unsigned word = __ballot_sync(0xffffffffu, any);
  const long long groups = (static_cast<long long>(n) + (1 << lg_g) - 1) >>
                           lg_g;
  if ((threadIdx.x & 31) == 0 && group < groups) bits[group >> 5] = word;
}

// One lane's sum over its units of the row whose cells start at `base`:
// units kg, kg + KG, kg + 2 KG, ... below ceil(e / kVec), kUnits of them
// loaded before any is gathered. With kFilter, a cell whose source's group
// has its bit clear in the shared-memory bitmap `front` gathers nothing.
template <int kVec, int kUnits, bool kFilter = false>
__device__ __forceinline__ float lane_sum(
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ xT,
    long long base, int e, int kg, int lg_kg, int B, int b,
    const unsigned* front = nullptr, int lg_g = 0) {
  const int units = (e + kVec - 1) / kVec;
  const int kgs = 1 << lg_kg;
  float acc = 0.f;
  for (int u0 = kg; u0 < units; u0 += kUnits * kgs) {
    int id[kUnits * kVec];
    float wt[kUnits * kVec];
    bool live[kUnits * kVec];
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      const int u = u0 + k * kgs;
      const long long c = base + static_cast<long long>(u) * kVec;
      if (u < units) {
        if constexpr (kVec == 4) {
          const int4 i4 = __ldcs(reinterpret_cast<const int4*>(nbr + c));
          const float4 w4 = __ldcs(reinterpret_cast<const float4*>(w + c));
          const unsigned m =
              __ldcs(reinterpret_cast<const unsigned*>(mask + c));
          const int left = e - u * 4;        // cells of the unit below e
          id[4 * k] = i4.x;
          id[4 * k + 1] = i4.y;
          id[4 * k + 2] = i4.z;
          id[4 * k + 3] = i4.w;
          wt[4 * k] = w4.x;
          wt[4 * k + 1] = w4.y;
          wt[4 * k + 2] = w4.z;
          wt[4 * k + 3] = w4.w;
          live[4 * k] = (m & 0xffu) != 0u;
          live[4 * k + 1] = (m & 0xff00u) != 0u && left > 1;
          live[4 * k + 2] = (m & 0xff0000u) != 0u && left > 2;
          live[4 * k + 3] = (m & 0xff000000u) != 0u && left > 3;
        } else {
          live[k] = __ldcs(mask + c) != 0;
          id[k] = __ldcs(nbr + c);
          wt[k] = __ldcs(w + c);
        }
      } else {
#pragma unroll
        for (int t = 0; t < kVec; ++t) {
          id[kVec * k + t] = 0;
          wt[kVec * k + t] = 0.f;
          live[kVec * k + t] = false;
        }
      }
    }
    float g[kUnits * kVec];
#pragma unroll
    for (int t = 0; t < kUnits * kVec; ++t) {
      bool on = live[t];
      if constexpr (kFilter) {
        const int bit = id[t] >> lg_g;
        on = on && ((front[bit >> 5] >> (bit & 31)) & 1u) != 0u;
      }
      g[t] = on ? wt[t] * __ldg(xT + static_cast<long long>(id[t]) * B + b)
                : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kUnits; ++k) {
      if constexpr (kVec == 4) {
        acc += (g[4 * k] + g[4 * k + 1]) + (g[4 * k + 2] + g[4 * k + 3]);
      } else {
        acc += g[k];
      }
    }
  }
  return acc;
}

template <int kVec, int kUnits>
__global__ void __launch_bounds__(kBlock)
ell_rows(const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
         const float* __restrict__ w, const int32_t* __restrict__ extent,
         const float* __restrict__ xT, float* __restrict__ out, int rows,
         int K, int B, int lg_bl, int lg_kg) {
  const int lane = threadIdx.x & 31;
  const int b_lane = lane & ((1 << lg_bl) - 1);
  const int kg = (lane >> lg_bl) & ((1 << lg_kg) - 1);
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long row =
      (warp << (5 - lg_bl - lg_kg)) + (lane >> (lg_bl + lg_kg));
  const bool live = row < rows;
  // a row past the table reads nothing; an extent above K is cut to K
  const int e = live ? min(__ldcs(extent + row), K) : 0;
  const long long base = row * K;
  for (int b0 = 0; b0 < B; b0 += 1 << lg_bl) {
    const int b = b0 + b_lane;
    float acc = b < B ? lane_sum<kVec, kUnits>(nbr, mask, w, xT, base, e, kg,
                                               lg_kg, B, b)
                      : 0.f;
    // every lane of the warp takes part, live or not
    for (int off = 1 << lg_bl; off < (1 << (lg_bl + lg_kg)); off <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (live && b < B && kg == 0) out[row * B + b] = acc;
  }
}

// The frontier route's rows at B = 1: the bitmap (words 32-bit words) into
// shared memory, then the block's warps walk the rows' warps with a stride
// of the grid's. kVec = 4 takes one unit a lane at a time, a scalar row
// four cells: the same order of adds as ell_rows, fewer registers (two
// blocks of 1024 threads an SM leave 32 a thread).
template <int kVec>
__global__ void __launch_bounds__(kFrontierBlock, kFrontierBlocksPerSm)
ell_rows_frontier(const int32_t* __restrict__ nbr,
                  const uint8_t* __restrict__ mask,
                  const float* __restrict__ w,
                  const int32_t* __restrict__ extent,
                  const float* __restrict__ xm,
                  const unsigned* __restrict__ bits, float* __restrict__ out,
                  int rows, int K, int words, int lg_kg, int lg_g) {
  extern __shared__ unsigned front[];
  for (int k = threadIdx.x; k < words; k += kFrontierBlock) front[k] = bits[k];
  __syncthreads();
  constexpr int kUnits = kVec == 4 ? 1 : 4;
  const int lane = threadIdx.x & 31;
  const int kg = lane & ((1 << lg_kg) - 1);
  const long long row_warps =
      (static_cast<long long>(rows) + (32 >> lg_kg) - 1) >> (5 - lg_kg);
  const long long stride =
      static_cast<long long>(gridDim.x) * (kFrontierBlock / 32);
  for (long long warp = static_cast<long long>(blockIdx.x) *
                            (kFrontierBlock / 32) + (threadIdx.x >> 5);
       warp < row_warps; warp += stride) {
    const long long row = (warp << (5 - lg_kg)) + (lane >> lg_kg);
    const bool live = row < rows;
    const int e = live ? min(__ldcs(extent + row), K) : 0;
    float acc = lane_sum<kVec, kUnits, true>(
        nbr, mask, w, xm, row * K, e, kg, lg_kg, 1, 0, front, lg_g);
    for (int off = 1; off < (1 << lg_kg); off <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (live && kg == 0) out[row] = acc;
  }
}

// The lane map of a launch: lg_bl from B, lg_kg the plan's lanes cut to the
// room the batch leaves in the warp.
inline void lane_map(int B, int lg_lanes, int* lg_bl, int* lg_kg) {
  *lg_bl = ceil_log2(B < 32 ? B : 32);
  const int room = 5 - *lg_bl;
  *lg_kg = lg_lanes < room ? (lg_lanes < 0 ? 0 : lg_lanes) : room;
}

// yT (rows, B) from the table, its extents and xT (n, B): 16-byte units
// when the rows split into them and the pointers allow it, else one cell a
// unit. Returns cudaGetLastError().
inline cudaError_t launch_rows(const int32_t* nbr, const uint8_t* mask,
                        const float* w, const int32_t* extent,
                        const float* xT, float* out, int rows, int K, int B,
                        int lg_lanes, cudaStream_t stream) {
  int lg_bl, lg_kg;
  lane_map(B, lg_lanes, &lg_bl, &lg_kg);
  const long long rows_per_warp = 32 >> (lg_bl + lg_kg);
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const unsigned grid =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const bool vec = K % 4 == 0 && aligned(nbr, 16) && aligned(w, 16) &&
                   aligned(mask, 4);
  if (vec) {
    ell_rows<4, 2><<<grid, kBlock, 0, stream>>>(
        nbr, mask, w, extent, xT, out, rows, K, B, lg_bl, lg_kg);
  } else {
    ell_rows<1, 4><<<grid, kBlock, 0, stream>>>(
        nbr, mask, w, extent, xT, out, rows, K, B, lg_bl, lg_kg);
  }
  return cudaGetLastError();
}

template <int kVec>
cudaError_t launch_frontier_rows(const int32_t* nbr, const uint8_t* mask,
                                 const float* w, const int32_t* extent,
                                 const float* xm, const unsigned* bits,
                                 float* out, int rows, int K, int words,
                                 int lg_kg, int lg_g, cudaStream_t stream) {
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return err;
  // the bitmap's room: an attribute of the function on the current device,
  // set once a device and process (every launch on a device past the table)
  constexpr int kDevices = 64;
  static bool sized[kDevices] = {};
  if (dev >= kDevices || !sized[dev]) {
    err = cudaFuncSetAttribute(ell_rows_frontier<kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kFrontierBytes);
    if (err != cudaSuccess) return err;
    if (dev < kDevices) sized[dev] = true;
  }
  const long long row_warps =
      (static_cast<long long>(rows) + (32 >> lg_kg) - 1) >> (5 - lg_kg);
  const long long need = (row_warps + kFrontierBlock / 32 - 1) /
                         (kFrontierBlock / 32);
  const long long most = static_cast<long long>(sms) * kFrontierBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(need < most ? need : most);
  ell_rows_frontier<kVec><<<grid, kFrontierBlock, words * 4, stream>>>(
      nbr, mask, w, extent, xm, bits, out, rows, K, words, lg_kg, lg_g);
  return cudaGetLastError();
}

// K1's frontier route at B = 1: prepare_frontier over x's n nodes, then
// ell_rows_frontier over the table's rows. words * 4 bytes (the bitmap of
// n nodes) must not exceed kFrontierBytes.
inline cudaError_t launch_frontier(const int32_t* nbr, const uint8_t* mask,
                                   const float* w, const int32_t* extent,
                                   const float* x, const float* thr,
                                   float* xm, unsigned* bits, float* out,
                                   long long si, int rows, int n, int K,
                                   int lg_lanes, int lg_g,
                                   cudaStream_t stream) {
  if (lg_g < 0) return cudaErrorInvalidValue;
  const long long groups = (static_cast<long long>(n) + (1 << lg_g) - 1)
                           >> lg_g;
  const long long words = (groups + 31) / 32;
  if (words * 4 > kFrontierBytes) return cudaErrorInvalidValue;
  prepare_frontier<<<static_cast<unsigned>((groups + kBlock - 1) / kBlock),
                     kBlock, 0, stream>>>(x, thr, xm, bits, si, n, lg_g);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int lg_bl, lg_kg;
  lane_map(1, lg_lanes, &lg_bl, &lg_kg);
  const bool vec = K % 4 == 0 && aligned(nbr, 16) && aligned(w, 16) &&
                   aligned(mask, 4);
  return vec ? launch_frontier_rows<4>(nbr, mask, w, extent, xm, bits, out,
                                       rows, K, static_cast<int>(words),
                                       lg_kg, lg_g, stream)
             : launch_frontier_rows<1>(nbr, mask, w, extent, xm, bits, out,
                                       rows, K, static_cast<int>(words),
                                       lg_kg, lg_g, stream);
}

}  // namespace
