// The lane layout shared by the segment reduction (segment_reduce.cu) and
// its backward (segment_grad.cu).
//
// A group of lanes takes a segment (or a piece of one): 32 lanes over the
// columns, fewer where d is narrow, so that a warp holds 32 / group of
// them. A row of d floats is d / V column units of V = 4, 2 or 1 floats,
// read and written as one 128-, 64- or 32-bit access; lane g of a group
// holds the units c0 + g + j * group for j < kPer of each chunk of
// group * kPer units starting at c0.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace segment {

constexpr int kThreads = 256;
constexpr int kPer = 4;       // column units a lane holds at once
constexpr int kBlocksPerSm = 16;

enum Op { kSum = 0, kMax = 1, kMin = 2 };

template <int V>
struct Unit {
  float v[V];
};

template <int V>
__device__ __forceinline__ Unit<V> load_unit(const float* p) {
  Unit<V> u;
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    u.v[0] = t.x;
    u.v[1] = t.y;
    u.v[2] = t.z;
    u.v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    u.v[0] = t.x;
    u.v[1] = t.y;
  } else {
    u.v[0] = __ldg(p);
  }
  return u;
}

template <int V>
__device__ __forceinline__ void store_unit(float* p, const float (&a)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    *p = a[0];
  }
}

template <int OP>
__device__ __forceinline__ float identity() {
  if constexpr (OP == kSum) {
    return 0.0f;
  } else if constexpr (OP == kMax) {
    return -CUDART_INF_F;
  } else {
    return CUDART_INF_F;
  }
}

// Lanes a segment: the column units rounded up to a power of two, at most
// a warp.
inline int group_of(int units) {
  int g = 1;
  while (g < units && g < 32) g <<= 1;
  return g;
}

// Blocks for one lane group an item, at most kBlocksPerSm an SM (the
// kernels stride over the rest).
inline int blocks_for(int64_t items, int group, int sms) {
  const int64_t per_block = static_cast<int64_t>(kThreads / 32) * (32 / group);
  const int64_t want = (items + per_block - 1) / per_block;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSm;
  return static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
}

}  // namespace segment
