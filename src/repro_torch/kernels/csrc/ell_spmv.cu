// One-vector pull-form ELL SpMV (K4), the step of exact power iteration:
//
//   y[i] = sum_j mask[i,j] * w[i,j] * x[nbr[i,j]]
//
// over the dense (n, K) in-neighbour table (int32 neighbours, bool mask,
// float32 weights 1/deg_out(src)), x and y (n,) float32: y = P^T x. Built
// with nvcc into a shared library with a plain C interface and called
// through ctypes from repro_torch/kernels/ell_spmv.py (ell_spmv_cuda), which
// checks every argument first.
//
// It replaces repro/kernels/ell_spmv.py::ell_spmv_pallas (body _ell_kernel).
// The TPU kernel keeps x resident in VMEM for each block of 256 rows and
// walks K in chunks of 128 lanes. The card has no VMEM of that size; instead
// x (6.5 MB at 1.6M nodes) stays in the 50 MB L2 between gathers, and each
// row's cells are spread over lanes so that a narrow table still fills the
// warp:
//
// * G = 2^ceil(log2(min(K, 32))) lanes take one row, the remaining
//   32 / G lane groups of the warp one row each. At K = 8 a warp works on
//   four rows, at K = 48 on one, and neighbouring lanes read neighbouring
//   cells, so the table is read in whole sectors;
// * lane c of a row adds cells c, c + G, c + 2G, ... in order, and the G
//   lane partials are combined by a fixed xor butterfly: every output has
//   one summation order for a given K, no atomics, the same bits on every
//   launch;
// * a masked-out cell reads neither its neighbour nor its weight, so a row
//   whose mask is all false comes out 0; row * K is a 64-bit offset.
//
// What bounds it on the H100: bytes. Each cell's mask byte is read, and
// each live cell's neighbour and weight (8 bytes) and one float of x from
// L2; y is written once. Two flops a live cell, far below the card's ratio
// of operations to bytes. At Pokec's order (1.6M x 48, 30.6M live cells)
// it takes about four times that bound (PERF.md). A variant with four
// cells a lane and their loads in flight (four rows a warp) was no faster,
// so a row's three dependent loads are not what holds it; each gather of x
// moves a whole 32-byte L2 sector for 4 bytes, 980 MB at that size.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kWarpsPerBlock = kBlock / 32;

int ceil_log2(int v) {
  int lg = 0;
  while ((1 << lg) < v) ++lg;
  return lg;
}

__global__ void __launch_bounds__(kBlock)
spmv_rows(const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
          const float* __restrict__ w, const float* __restrict__ x,
          float* __restrict__ y, int rows, int K, int lg_g) {
  const int lane = threadIdx.x & 31;
  const int g = 1 << lg_g;
  const int cell = lane & (g - 1);
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long row = warp * (32 >> lg_g) + (lane >> lg_g);
  const bool live = row < rows;
  float acc = 0.f;
  if (live) {
    const long long base = row * K;
    for (int j = cell; j < K; j += g) {
      if (mask[base + j]) acc += w[base + j] * __ldg(x + nbr[base + j]);
    }
  }
  // every lane of the warp takes part, live or not
  for (int off = 1; off < g; off <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (live && cell == 0) y[row] = acc;
}

}  // namespace

extern "C" {

// y (rows,) from the dense (rows, K) table and x. Returns a cudaError_t.
int ell_spmv_launch(const void* nbr, const void* mask, const void* w,
                    const void* x, void* y, int rows, int K, void* stream) {
  const int lg_g = ceil_log2(K < 32 ? K : 32);
  const long long rows_per_warp = 32 >> lg_g;
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const unsigned grid =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  spmv_rows<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(x),
      static_cast<float*>(y), rows, K, lg_g);
  return static_cast<int>(cudaGetLastError());
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
