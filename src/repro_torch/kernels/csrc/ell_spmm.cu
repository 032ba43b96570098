// Pull-form dense ELL SpMM for FORA's push sweep (K1).
//
//   y[b, i] = sum_j mask[i,j] * w[i,j] * f(x[b, nbr[i,j]])
//   f(v)    = v * [v > thr[nbr[i,j]]]   when a threshold is given, else v
//
// x and y are carried transposed, xT (n, B) and yT (n, B), so that one
// neighbour gather reads B contiguous floats. Built with nvcc into a shared
// library with a plain C interface and called through ctypes from
// repro_torch/kernels/ell_spmv.py, which checks every argument first. The
// sliced table's product (K2) is ell_spmm_sliced.cu.
//
// Lane layout (one warp, 32 lanes): lane = (rw, kg, b) with b the fastest
// index. BL = 2^lg_bl lanes cover the batch (B <= 32 in one pass, more in
// chunks of 32), KG = 2^lg_kg lanes stride over the row's cells, and the
// remaining 32 / (BL*KG) lane groups take one row each. At B = 1 and a
// width-8 table a warp therefore works on four rows at once instead of
// leaving 24 of 32 lanes idle. The KG lane partials are combined with a
// fixed xor butterfly, so every output has one summation order per
// (K, B) shape: no atomics, the same bits on every run.

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

template <bool kFuse>
__global__ void __launch_bounds__(kBlock)
ell_rows(const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
         const float* __restrict__ w, const float* __restrict__ xT,
         const float* __restrict__ thr, float* __restrict__ out,
         int rows, int K, int B, int lg_bl, int lg_kg) {
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

void lane_map(int K, int B, int* lg_bl, int* lg_kg) {
  *lg_bl = ceil_log2(B < 32 ? B : 32);
  const int room = 32 >> *lg_bl;
  *lg_kg = ceil_log2(K < room ? K : room);
}

cudaError_t launch_rows(const int32_t* nbr, const uint8_t* mask,
                        const float* w, const float* xT, const float* thr,
                        float* out, int rows, int K, int B,
                        cudaStream_t stream) {
  int lg_bl, lg_kg;
  lane_map(K, B, &lg_bl, &lg_kg);
  const long long rows_per_warp = 32 >> (lg_bl + lg_kg);
  const long long warps = (rows + rows_per_warp - 1) / rows_per_warp;
  const unsigned grid =
      static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (thr != nullptr) {
    ell_rows<true><<<grid, kBlock, 0, stream>>>(
        nbr, mask, w, xT, thr, out, rows, K, B, lg_bl, lg_kg);
  } else {
    ell_rows<false><<<grid, kBlock, 0, stream>>>(
        nbr, mask, w, xT, thr, out, rows, K, B, lg_bl, lg_kg);
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
      static_cast<cudaStream_t>(stream)));
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
