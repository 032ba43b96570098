// Pull-form ELL SpMM for FORA's push sweep, dense (K1) and sliced (K2).
//
//   y[b, i] = sum_j mask[i,j] * w[i,j] * f(x[b, nbr[i,j]])
//   f(v)    = v * [v > thr[nbr[i,j]]]   when a threshold is given, else v
//
// x and y are carried transposed, xT (n, B) and yT (rows, B), so that one
// neighbour gather reads B contiguous floats. Built with nvcc into a shared
// library with a plain C interface and called through ctypes from
// repro_torch/kernels/ell_spmv.py, which checks every argument first.
//
// Lane layout (one warp, 32 lanes): lane = (rw, kg, b) with b the fastest
// index. BL = 2^lg_bl lanes cover the batch (B <= 32 in one pass, more in
// chunks of 32), KG = 2^lg_kg lanes stride over the row's cells, and the
// remaining 32 / (BL*KG) lane groups take one row each. At B = 1 and a
// width-8 table a warp therefore works on four rows at once instead of
// leaving 24 of 32 lanes idle. The KG lane partials are combined with a
// fixed xor butterfly, so every output has one summation order per
// (K, B) shape: no atomics, the same bits on every run.
//
// The sliced table (K2) keeps a row's slices as consecutive virtual rows,
// row_map ascending. Pass 1 runs the same row body over the virtual rows
// into a (n_virtual, B) scratch and, from the ascending row_map, writes the
// CSR offsets row_ptr (n + 1) of every real row. The fold then runs as a
// fixed tree over each row's virtual rows, so that its cost does not follow
// the row: two in-place levels each add groups of kFoldGroup (the first
// level consecutive virtual rows, the second level the first level's group
// heads), one thread per group and batch column, and a root adds the
// remaining heads of each real row in ascending order. A hub with tens of
// thousands of slices is spread over as many threads as any other row's
// slices, and hubs that cluster at low node ids do not pile onto one block.
// Every output has one summation order, fixed by its row's length. Virtual
// rows whose row_map is n (padding) lie past row_ptr[n] and are dropped.
// Rows without a virtual row (in-degree 0) get an empty range and come
// out 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;
constexpr int kFoldGroup = 32;   // fan-in of each fold level
constexpr int kFoldLevels = 2;   // levels before the per-row root

int ceil_log2(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

template <bool kFuse>
__global__ void __launch_bounds__(kBlock)
ell_rows(const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
         const float* __restrict__ w, const float* __restrict__ xT,
         const float* __restrict__ thr, float* __restrict__ out,
         int rows, int K, int B, int lg_bl, int lg_kg,
         const int32_t* __restrict__ row_map, int32_t* __restrict__ row_ptr,
         int n) {
  const int lane = threadIdx.x & 31;
  const int bl = 1 << lg_bl;
  const int kgs = 1 << lg_kg;
  const int b_lane = lane & (bl - 1);
  const int kg = (lane >> lg_bl) & (kgs - 1);
  const int rows_per_warp = 32 >> (lg_bl + lg_kg);
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long row = warp * rows_per_warp + (lane >> (lg_bl + lg_kg));
  const bool live = row < rows;

  if (row_map != nullptr && live && kg == 0 && b_lane == 0) {
    // row_ptr[r] = first virtual row whose real row is >= r (r in [0, n])
    const int cur = min(row_map[row], n);
    const int prev = row == 0 ? -1 : min(row_map[row - 1], n);
    for (int r = prev + 1; r <= cur; ++r) row_ptr[r] = static_cast<int>(row);
    if (row == rows - 1) {
      for (int r = cur + 1; r <= n; ++r) row_ptr[r] = rows;
    }
  }

  const long long base = row * K;
  for (int b0 = 0; b0 < B; b0 += bl) {
    const int b = b0 + b_lane;
    float acc = 0.f;
    if (live && b < B) {
      for (int j = kg; j < K; j += kgs) {
        if (mask[base + j]) {
          const int src = nbr[base + j];
          float v = xT[static_cast<long long>(src) * B + b];
          if (kFuse && !(v > thr[src])) v = 0.f;
          acc += w[base + j] * v;
        }
      }
    }
    for (int off = bl; off < bl * kgs; off <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (live && b < B && kg == 0) out[row * B + b] = acc;
  }
}

// One level of the fold tree, in place over the (nv, B) partials: every
// virtual row v that heads its group at this level (v - lo a multiple of
// stride * kFoldGroup, lo the first virtual row of v's real row) adds the
// kFoldGroup heads of the level below, lo-relative offsets v, v + stride,
// v + 2 * stride, ..., that lie inside the row. Groups are disjoint, so
// each thread reads and writes only its own group.
__global__ void __launch_bounds__(kBlock)
fold_level(float* __restrict__ partials, const int32_t* __restrict__ row_map,
           const int32_t* __restrict__ row_ptr, int nv, int B, int n,
           int stride) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= static_cast<long long>(nv) * B) return;
  const int v = static_cast<int>(idx / B);
  const int b = static_cast<int>(idx - static_cast<long long>(v) * B);
  const int r = row_map[v];
  if (r >= n) return;                        // padding row: dropped
  const int lo = row_ptr[r];
  const int hi = row_ptr[r + 1];
  if ((v - lo) % (static_cast<long long>(stride) * kFoldGroup) != 0) return;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < kFoldGroup; ++k) {
    const long long u = v + static_cast<long long>(k) * stride;
    if (u < hi) acc += partials[u * B + b];
  }
  partials[static_cast<long long>(v) * B + b] = acc;
}

// The root of the fold tree: one thread per (real row, batch column) adds
// the row's top-level heads lo, lo + stride, ... in ascending order.
__global__ void __launch_bounds__(kBlock)
fold_rows(const float* __restrict__ partials,
          const int32_t* __restrict__ row_ptr, float* __restrict__ yT, int n,
          int B, int stride) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (idx >= static_cast<long long>(n) * B) return;
  const int row = static_cast<int>(idx / B);
  const int b = static_cast<int>(idx - static_cast<long long>(row) * B);
  const int lo = row_ptr[row];
  const int hi = row_ptr[row + 1];
  float acc = 0.f;
#pragma unroll 4
  for (int u = lo; u < hi; u += stride) {
    acc += partials[static_cast<long long>(u) * B + b];
  }
  yT[idx] = acc;
}

unsigned blocks_for(long long threads) {
  return static_cast<unsigned>((threads + kBlock - 1) / kBlock);
}

void lane_map(int K, int B, int* lg_bl, int* lg_kg) {
  *lg_bl = ceil_log2(B < 32 ? B : 32);
  const int room = 32 >> *lg_bl;
  *lg_kg = ceil_log2(K < room ? K : room);
}

cudaError_t launch_rows(const int32_t* nbr, const uint8_t* mask,
                        const float* w, const float* xT, const float* thr,
                        float* out, int rows, int K, int B,
                        const int32_t* row_map, int32_t* row_ptr, int n,
                        cudaStream_t stream) {
  int lg_bl, lg_kg;
  lane_map(K, B, &lg_bl, &lg_kg);
  const long long rows_per_warp = 32 >> (lg_bl + lg_kg);
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const unsigned grid =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (thr != nullptr) {
    ell_rows<true><<<grid, kBlock, 0, stream>>>(
        nbr, mask, w, xT, thr, out, rows, K, B, lg_bl, lg_kg, row_map,
        row_ptr, n);
  } else {
    ell_rows<false><<<grid, kBlock, 0, stream>>>(
        nbr, mask, w, xT, thr, out, rows, K, B, lg_bl, lg_kg, row_map,
        row_ptr, n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: yT (n, B) from the dense (n, K) table. thr may be null (no threshold).
int ell_spmm_dense_launch(const void* nbr, const void* mask, const void* w,
                          const void* xT, const void* thr, void* yT, int rows,
                          int K, int B, void* stream) {
  return static_cast<int>(launch_rows(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(xT),
      static_cast<const float*>(thr), static_cast<float*>(yT), rows, K, B,
      nullptr, nullptr, rows, static_cast<cudaStream_t>(stream)));
}

// K2: yT (n, B) from the sliced (nv, W) table and its ascending row_map.
// partials (nv, B) f32 and row_ptr (n + 1) i32 are caller-allocated scratch.
int ell_spmm_sliced_launch(const void* nbr, const void* mask, const void* w,
                           const void* row_map, const void* xT,
                           const void* thr, void* partials, void* row_ptr,
                           void* yT, int nv, int W, int B, int n,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_rows(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(xT),
      static_cast<const float*>(thr), static_cast<float*>(partials), nv, W, B,
      static_cast<const int32_t*>(row_map), static_cast<int32_t*>(row_ptr), n,
      s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int stride = 1;
  for (int level = 0; level < kFoldLevels; ++level) {
    fold_level<<<blocks_for(static_cast<long long>(nv) * B), kBlock, 0, s>>>(
        static_cast<float*>(partials), static_cast<const int32_t*>(row_map),
        static_cast<const int32_t*>(row_ptr), nv, B, n, stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    stride *= kFoldGroup;
  }
  fold_rows<<<blocks_for(static_cast<long long>(n) * B), kBlock, 0, s>>>(
      static_cast<const float*>(partials), static_cast<const int32_t*>(row_ptr),
      static_cast<float*>(yT), n, B, stride);
  return static_cast<int>(cudaGetLastError());
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
