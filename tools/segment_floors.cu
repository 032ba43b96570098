// Three floors of the segment reduction and its backward (src/
// repro_torch/kernels/csrc/segment_reduce.cu, segment_grad.cu), for
// measurement only: chip_smoke.py builds this file with the port's nvcc
// flags and times them at the shapes where a kernel loses to its PyTorch
// call. No path of the port calls them.
//
// * the stream read floor: the (E, d) rows read once as one flat array of
//   aligned 16-byte units, and the E keys beside them: the least the
//   contiguous route's reduction reads;
// * the gathered read floor: every position's row read once through the
//   plan's order, and its order entry and key, a group of lanes a row
//   (16-byte units where d is a multiple of 4), four rows in flight a
//   group: the least the gathered route's reduction reads;
// * the write floor: the (E, d) gradient written once as aligned 16-byte
//   units of the flat array, a block a range of rows, each unit the float
//   of its first row's key: the least a backward writes, with no row of
//   g_out read.
// The read floors sum what they read into a register and write one float a
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
stream_floor(const float* __restrict__ values,
             const int32_t* __restrict__ keys, long long words, long long E,
             float* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long threads = static_cast<long long>(gridDim.x) * kBlock;
  float acc = 0.f;
  for (long long i = t; 4 * i + 3 < words; i += threads) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(values) + i);
    acc += x.x + x.y + x.z + x.w;
  }
  for (long long i = t; 4 * i + 3 < E; i += threads) {
    const int4 k = __ldg(reinterpret_cast<const int4*>(keys) + i);
    acc += static_cast<float>(k.x + k.y + k.z + k.w);
  }
  write_warp_sum(acc, out);
}

template <int V>
__global__ void __launch_bounds__(kBlock)
gather_floor(const float* __restrict__ values,
             const int32_t* __restrict__ rows,
             const int32_t* __restrict__ keys, long long E, int d, int group,
             float* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long groups = static_cast<long long>(gridDim.x) * kBlock / group;
  const int l = (threadIdx.x & 31) % group;
  const int units = d / V;
  float acc = 0.f;
  // four positions a group at a time, their loads issued together
  for (long long p0 = t / group; p0 < E; p0 += 4 * groups) {
    long long row[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long p = p0 + q * groups;
      row[q] = p < E ? __ldg(rows + p) : -1;
      if (p < E) acc += static_cast<float>(__ldg(keys + p));
    }
    for (int c = l; c < units; c += group) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (row[q] < 0) continue;
        const float* base = values + row[q] * d;
        if constexpr (V == 4) {
          const float4 x = __ldg(reinterpret_cast<const float4*>(base) + c);
          acc += x.x + x.y + x.z + x.w;
        } else {
          acc += __ldg(base + c);
        }
      }
    }
  }
  write_warp_sum(acc, out);
}

__global__ void __launch_bounds__(kBlock)
write_floor(const int32_t* __restrict__ keys, long long E, int d,
            int rows_per_block, float* __restrict__ grad) {
  const long long row0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long rows_here =
      E - row0 < rows_per_block ? E - row0 : rows_per_block;
  const int words = static_cast<int>(rows_here) * d;
  float* base = grad + row0 * d;
  for (int i = threadIdx.x; 4 * i < words; i += kBlock) {
    // the unit's words take its first row's key: one key read a unit
    const float k = static_cast<float>(__ldg(keys + row0 + (4 * i) / d));
    if (4 * i + 4 <= words) {
      reinterpret_cast<float4*>(base)[i] = make_float4(k, k, k, k);
    } else {
      for (int j = 0; 4 * i + j < words; ++j) base[4 * i + j] = k;
    }
  }
}

}  // namespace

extern "C" {

int segment_floor_warps() { return kBlocks * kBlock / 32; }

// values (E, d) f32, 16-byte aligned; rows (E,) i32 or null (the stream
// floor); keys (E,) i32, 16-byte aligned; out: segment_floor_warps()
// floats.
int segment_read_floor_launch(const void* values, const void* rows,
                              const void* keys, long long E, int d, int vec,
                              void* out, void* stream) {
  if (E < 0 || d < 1 || !(vec == 1 || vec == 4) || d % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const float*>(values);
  const auto* r = static_cast<const int32_t*>(rows);
  const auto* k = static_cast<const int32_t*>(keys);
  auto* o = static_cast<float*>(out);
  if (r == nullptr) {
    stream_floor<<<kBlocks, kBlock, 0, s>>>(v, k, E * d, E, o);
    return static_cast<int>(cudaGetLastError());
  }
  int group = 1;
  while (group < d / vec && group < 32) group <<= 1;
  if (vec == 4) {
    gather_floor<4><<<kBlocks, kBlock, 0, s>>>(v, r, k, E, d, group, o);
  } else {
    gather_floor<1><<<kBlocks, kBlock, 0, s>>>(v, r, k, E, d, group, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// keys (E,) i32; grad (E, d) f32, 16-byte aligned.
int segment_write_floor_launch(const void* keys, long long E, int d,
                               void* grad, void* stream) {
  if (E < 0 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fit = 4 * kBlock / d;
  const int rows_per_block = 4 * (fit > 1 ? fit : 1);
  const long long blocks = E < 1 ? 1 : (E + rows_per_block - 1)
                                           / rows_per_block;
  write_floor<<<static_cast<unsigned>(blocks), kBlock, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), E, d, rows_per_block,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

const char* segment_floors_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
