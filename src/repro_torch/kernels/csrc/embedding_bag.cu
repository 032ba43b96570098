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
// first.
//
// The TPU kernel (repro/kernels/embedding_bag.py, _bag_kernel) keeps the
// whole table resident in VMEM and gathers (block_b, d) rows per step of a
// loop over l. DIN's item table is 10M x 18 floats (720 MB), which no
// on-chip memory holds; here each row is read from device memory where it
// lies:
//
// * one warp per bag, lanes over d (32 columns a pass; DIN's d = 18 leaves
//   14 lanes idle);
// * the warp reads 32 of the bag's (id, weight) pairs at once, one per lane,
//   and broadcasts them by shuffle, so each l costs one row read (reading
//   a chunk's 32 rows into registers before summing them measured slower
//   on the H100 at DIN's shapes; PERF.md has the times);
// * l runs in order and every step is one fused multiply-add in float32:
//   one summation order, no atomics, the same bits on every launch.
//
// What bounds it on the H100: bytes. Each (b, l) reads 8 bytes of id and
// weight and one random row of d floats (72 bytes at d = 18, three 32-byte
// sectors); the output is written once; one multiply-add per element.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // bags per block
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
bag_sum(const float* __restrict__ table, const int32_t* __restrict__ ids,
        const float* __restrict__ w, float* __restrict__ out, int B, int L,
        int V, int d, long long ids_stride, long long w_stride) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long b = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (b >= B) return;
  const int32_t* id_row = ids + b * ids_stride;
  const float* w_row = w + b * w_stride;
  for (int d0 = 0; d0 < d; d0 += 32) {
    const int col = d0 + lane;
    float acc = 0.0f;
    for (int l0 = 0; l0 < L; l0 += 32) {
      const int n = min(32, L - l0);
      int my_id = -1;
      float my_w = 0.0f;
      if (lane < n) {
        my_id = id_row[l0 + lane];
        my_w = w_row[l0 + lane];
      }
      for (int t = 0; t < n; ++t) {
        const int id = __shfl_sync(kFull, my_id, t);
        const float wt = __shfl_sync(kFull, my_w, t);
        if (col >= d) continue;
        if (id < -V || id >= V) {
          acc = __int_as_float(0x7fc00000);      // NaN, kept by every fmaf
        } else {
          const long long row = id < 0 ? id + V : id;
          acc = fmaf(wt, table[row * d + col], acc);
        }
      }
    }
    if (col < d) out[b * d + col] = acc;
  }
}

}  // namespace

extern "C" {

// Returns a cudaError_t.
int embedding_bag_launch(const void* table, const void* ids,
                         const void* weights, void* out, int B, int L, int V,
                         int d, long long ids_stride, long long w_stride,
                         void* stream) {
  const int blocks = (B + kWarps - 1) / kWarps;
  bag_sum<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<const float*>(weights), static_cast<float*>(out), B, L, V,
      d, ids_stride, w_stride);
  return static_cast<int>(cudaGetLastError());
}

const char* embedding_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
