// The two floors of the dense ELL products K1 and K4 (src/repro_torch/
// kernels/csrc/ell_spmm.cu, ell_spmv.cu), for measurement only:
// chip_smoke.py's phase 5 builds this file with the port's nvcc flags and
// times both at Pokec's order beside the kernels. No path of the port
// calls them.
//
// * the table floor: each row's live cells read and nothing gathered, one
//   thread a 4-cell unit below the row's extent (16 bytes of neighbours,
//   16 of weights, 4 mask bytes), summing w * nbr;
// * the gather floor: x gathered at a list of indices and summed, each
//   thread reading its indices as 16-byte loads. Given the table's live
//   neighbours it is the least a product can do to gather them; with idx
//   null it gathers at count hashed indices and reads no list, which leaves
//   only the L2 sector rate of random 4-byte reads.
//
// Both run a fixed grid that strides over the work and write one float a
// warp.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr unsigned kBlocks = 132 * 16;

__device__ __forceinline__ void write_warp_sum(float acc, float* out) {
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  const long long t =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if ((threadIdx.x & 31) == 0) out[t >> 5] = acc;
}

__global__ void __launch_bounds__(kBlock)
table_floor(const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
            const float* __restrict__ w, const int32_t* __restrict__ extent,
            int rows, int K, float* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kBlock;
  const int per_row = K / 4;
  const long long units = static_cast<long long>(rows) * per_row;
  float acc = 0.f;
  for (long long u = t; u < units; u += threads) {
    const long long row = u / per_row;
    const int left = __ldg(extent + row) - 4 * static_cast<int>(u - row *
                                                                  per_row);
    if (left <= 0) continue;
    const int4 i4 = __ldcs(reinterpret_cast<const int4*>(nbr) + u);
    const float4 w4 = __ldcs(reinterpret_cast<const float4*>(w) + u);
    const unsigned m = __ldcs(reinterpret_cast<const unsigned*>(mask) + u);
    acc += ((m & 0xffu) ? w4.x * i4.x : 0.f) +
           ((m & 0xff00u) && left > 1 ? w4.y * i4.y : 0.f) +
           ((m & 0xff0000u) && left > 2 ? w4.z * i4.z : 0.f) +
           ((m & 0xff000000u) && left > 3 ? w4.w * i4.w : 0.f);
  }
  write_warp_sum(acc, out);
}

// a scattered index in [0, n): a multiplicative hash of k scaled to n
__device__ __forceinline__ int hashed(long long k, int n) {
  const unsigned h = static_cast<unsigned>(k) * 2654435761u;
  return static_cast<int>((static_cast<unsigned long long>(h) * n) >> 32);
}

__global__ void __launch_bounds__(kBlock)
gather_floor(const int32_t* __restrict__ idx, long long count,
             const float* __restrict__ x, int n, float* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kBlock;
  const long long quads = count / 4;
  float acc = 0.f;
  for (long long q = t; q < quads; q += threads) {
    int4 i4;
    if (idx != nullptr) {
      i4 = __ldcs(reinterpret_cast<const int4*>(idx) + q);
    } else {
      i4 = make_int4(hashed(4 * q, n), hashed(4 * q + 1, n),
                     hashed(4 * q + 2, n), hashed(4 * q + 3, n));
    }
    acc += (__ldg(x + i4.x) + __ldg(x + i4.y)) +
           (__ldg(x + i4.z) + __ldg(x + i4.w));
  }
  for (long long k = 4 * quads + t; k < count; k += threads) {
    acc += __ldg(x + (idx != nullptr ? idx[k] : hashed(k, n)));
  }
  write_warp_sum(acc, out);
}

}  // namespace

extern "C" {

// out (ell_floor_warps(),) = the warps' sums over each row's cells below
// its extent of mask * w * nbr. The (rows, K) table must have K % 4 == 0
// and 16-byte aligned rows.
int ell_table_floor_launch(const void* nbr, const void* mask, const void* w,
                           const void* extent, int rows, int K, void* out,
                           void* stream) {
  if (K % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  table_floor<<<kBlocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(w), static_cast<const int32_t*>(extent),
      rows, K, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out (ell_floor_warps(),) = the warps' sums of x at idx[0:count] (16-byte
// aligned), or at count hashed indices in [0, n) when idx is null.
int ell_gather_floor_launch(const void* idx, long long count, const void* x,
                            int n, void* out, void* stream) {
  gather_floor<<<kBlocks, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(idx), count, static_cast<const float*>(x),
      n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int ell_floor_warps() { return static_cast<int>(kBlocks * kBlock / 32); }

const char* ell_floors_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
