// Sliced pull-form ELL SpMM for FORA's push sweep (K2).
//
//   y[b, r] = sum over the virtual rows v of real row r, and their cells j,
//             of mask[v,j] * w[v,j] * f(x[b, nbr[v,j]])
//   f(v)    = v * [v > thr[nbr[v,j]]]   when a threshold is given, else v
//
// The sliced table keeps a row's slices as consecutive virtual rows of width
// W (row_map ascending; row_map == n marks padding, which is dropped). Built
// with nvcc into a shared library with a plain C interface and called
// through ctypes from repro_torch/kernels/ell_spmv.py, which checks every
// argument first.
//
// What bounds it on the H100: bytes. A sweep reads each table cell once
// (int32 id, bool mask, f32 weight: 9 bytes), gathers B floats of x per
// live cell, and writes (n, B) floats; two flops per live cell and batch
// column. At web-stanford's size the table is 27.9 MB (388,093 x 8
// cells) and x 1.1 MB a column: x stays in the 50 MB L2, the table streams
// from device memory once, and each gather of 4 bytes moves a 32-byte
// sector from L2 (58 MB of sectors for the 1,825,523 live cells at B = 1).
//
// 0. prepare_x, when a threshold is given or x is not laid out (n, B):
//    xm[i, b] = f(x[b, i]), so the push condition costs one threshold read a
//    source instead of a second gather a cell, and one gather of xm reads B
//    contiguous floats.
//
// The fold's structure is a constant of the table, built once by the
// wrapper's sliced_fold() and passed in: row_ptr (n + 1), the first virtual
// row of each real row; the warp items, each a run of at most
// chunk_slices slices (a warp's share, 256 cells) read by one warp: the
// hubs' chunks first, then the rows of more than short_slices slices (16
// cells) that need no chunk; and the hubs with their chunks' offsets.
//
// 1. sliced_rows, one launch. Its first warps fold the short rows, several
//    to a warp: lane = (row, kg, b) with b the fastest index, BL = 2^lg_bl
//    lanes over the batch (B <= 32 at once, more in chunks of 32) and KG =
//    2^lg_kg lanes striding over the row's cells in units of kVec cells (a
//    16-byte load of ids and of weights, 4 bytes of mask). Each lane adds
//    its units in order, each unit as (t0 + t1) + (t2 + t3); a fixed xor
//    butterfly combines the KG lanes, and the row's lane 0 writes yT once.
//    Rows without a slice come out 0. The remaining warps take one warp
//    item each, all 32 lanes on its slices: a longer row's sum goes to yT,
//    a hub chunk's to partials (hub chunks, B).
// 2. fold_hubs, one warp per hub, when the table has hubs, adds the hub's
//    chunk sums in a fixed order (lanes stride over the chunks, then the
//    butterfly) into yT. A hub's cost no longer follows one thread's walk
//    down its slices: the largest web-stanford hub (23,454 slices) is 733
//    chunks on 733 warps.
//
// Short rows keep a warp's lanes busy with one or two units each, and no
// lane walks more than a warp item's units: at web-stanford's table
// (W = 8) 259,050 rows are short, 8,468 are warp items and 385 hubs are
// 2,596 chunks. Every output has one summation order, fixed by its row's
// length, the batch width and the table's width: no atomics, the same bits
// on every launch. A row's chain of float32 adds is at most units-per-lane
// + 7 (64 + 7 at W = 8 and B > 16), so the error stays near 70 * 2^-24.

#include "ell_rows.cuh"   // prepare_x, shared with K1

namespace {

// The sum of one unit (kVec consecutive cells starting at cell u * kVec).
// The table streams past (evict-first loads), x stays in L2; a masked cell
// gathers nothing and adds 0.
template <int kVec>
__device__ __forceinline__ float unit_sum(
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ xT, long long u,
    int B, int b) {
  if constexpr (kVec == 4) {
    const int4 id = __ldcs(reinterpret_cast<const int4*>(nbr) + u);
    const float4 wt = __ldcs(reinterpret_cast<const float4*>(w) + u);
    const unsigned m = __ldcs(reinterpret_cast<const unsigned*>(mask) + u);
    const auto term = [&](unsigned live, int src, float wt) {
      return live ? wt * xT[static_cast<long long>(src) * B + b] : 0.f;
    };
    const float t0 = term(m & 0xffu, id.x, wt.x);
    const float t1 = term(m & 0xff00u, id.y, wt.y);
    const float t2 = term(m & 0xff0000u, id.z, wt.z);
    const float t3 = term(m & 0xff000000u, id.w, wt.w);
    return (t0 + t1) + (t2 + t3);
  } else {
    return mask[u] ? w[u] * xT[static_cast<long long>(nbr[u]) * B + b] : 0.f;
  }
}

// Units [u0, u1) summed by the 2^lg_kg lanes of one group (lane kg takes
// u0 + kg, u0 + kg + KG, ...), combined by the butterfly over the group.
// Every lane of the warp calls it together.
template <int kVec>
__device__ __forceinline__ float group_sum(
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ w, const float* __restrict__ xT, long long u0,
    long long u1, int kg, int lg_bl, int lg_kg, int B, int b) {
  float acc = 0.f;
  if (b < B) {
    for (long long u = u0 + kg; u < u1; u += 1 << lg_kg) {
      acc += unit_sum<kVec>(nbr, mask, w, xT, u, B, b);
    }
  }
  for (int off = 1 << lg_bl; off < (1 << (lg_bl + lg_kg)); off <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  return acc;
}

template <int kVec>
__global__ void __launch_bounds__(kBlock)
sliced_rows(const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
            const float* __restrict__ w, const int32_t* __restrict__ row_map,
            const int32_t* __restrict__ row_ptr,
            const int32_t* __restrict__ items, const float* __restrict__ xT,
            float* __restrict__ partials, float* __restrict__ yT, int n,
            int B, int units_per_slice, int short_slices, int chunk_slices,
            int lg_bl, int lg_kg, long long row_warps, int n_items,
            int hub_items) {
  const int lane = threadIdx.x & 31;
  const int b_lane = lane & ((1 << lg_bl) - 1);
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (warp < row_warps) {
    // short rows, 32 >> (lg_bl + lg_kg) to a warp
    const int kg = (lane >> lg_bl) & ((1 << lg_kg) - 1);
    const long long row =
        (warp << (5 - lg_bl - lg_kg)) + (lane >> (lg_bl + lg_kg));
    long long u0 = 0;
    long long u1 = 0;
    bool mine = false;
    if (row < n) {
      const int lo = row_ptr[row];
      const int hi = row_ptr[row + 1];
      mine = hi - lo <= short_slices;     // a longer row is a warp item
      if (mine) {
        u0 = static_cast<long long>(lo) * units_per_slice;
        u1 = static_cast<long long>(hi) * units_per_slice;
      }
    }
    for (int b0 = 0; b0 < B; b0 += 1 << lg_bl) {
      const int b = b0 + b_lane;
      const float acc = group_sum<kVec>(nbr, mask, w, xT, u0, u1, kg, lg_bl,
                                        lg_kg, B, b);
      if (mine && kg == 0 && b < B) yT[row * B + b] = acc;
    }
    return;
  }
  // one warp item, every lane on its slices: a hub's chunk (the first
  // hub_items items, summed into partials) or a whole longer row
  const long long c = warp - row_warps;
  if (c >= n_items) return;
  const int lg_kg_all = 5 - lg_bl;
  const int kg = lane >> lg_bl;
  const int first = items[c];
  const int r = row_map[first];
  const int end = min(first + chunk_slices, row_ptr[r + 1]);
  const long long u0 = static_cast<long long>(first) * units_per_slice;
  const long long u1 = static_cast<long long>(end) * units_per_slice;
  float* dest = c < hub_items ? partials + c * B
                              : yT + static_cast<long long>(r) * B;
  for (int b0 = 0; b0 < B; b0 += 1 << lg_bl) {
    const int b = b0 + b_lane;
    const float acc = group_sum<kVec>(nbr, mask, w, xT, u0, u1, kg, lg_bl,
                                      lg_kg_all, B, b);
    if (kg == 0 && b < B) dest[b] = acc;
  }
}

// yT[hubs[h], b] = the hub's chunk sums, lanes striding over the chunks
// hub_chunks[h] .. hub_chunks[h + 1] in order, then the butterfly.
__global__ void __launch_bounds__(kBlock)
fold_hubs(const float* __restrict__ partials, const int32_t* __restrict__ hubs,
          const int32_t* __restrict__ hub_chunks, float* __restrict__ yT,
          int B, int n_hubs, int lg_bl) {
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (h >= n_hubs) return;
  const int b_lane = lane & ((1 << lg_bl) - 1);
  const int kg = lane >> lg_bl;
  const int kgs = 32 >> lg_bl;
  const int lo = hub_chunks[h];
  const int hi = hub_chunks[h + 1];
  const long long row = hubs[h];
  for (int b0 = 0; b0 < B; b0 += 1 << lg_bl) {
    const int b = b0 + b_lane;
    float acc = 0.f;
    if (b < B) {
      for (int k = lo + kg; k < hi; k += kgs) {
        acc += partials[static_cast<long long>(k) * B + b];
      }
    }
    for (int off = 1 << lg_bl; off < 32; off <<= 1) {
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (kg == 0 && b < B) yT[row * B + b] = acc;
  }
}

template <int kVec>
cudaError_t launch(const int32_t* nbr, const uint8_t* mask, const float* w,
                   const int32_t* row_map, const int32_t* row_ptr,
                   const int32_t* items, const int32_t* hubs,
                   const int32_t* hub_chunks, const float* xT,
                   float* partials, float* yT, int n, int W, int B,
                   int n_items, int hub_items, int n_hubs, int short_slices,
                   int chunk_slices, cudaStream_t stream) {
  const int units_per_slice = W / kVec;
  const int lg_bl = ceil_log2(B < 32 ? B : 32);
  const int room = 32 >> lg_bl;
  const int lg_kg = ceil_log2(units_per_slice < room ? units_per_slice : room);
  const long long rows_per_warp = 32 >> (lg_bl + lg_kg);
  const long long row_warps = (n + rows_per_warp - 1) / rows_per_warp;
  const long long warps = row_warps + n_items;
  sliced_rows<kVec>
      <<<static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock),
         kBlock, 0, stream>>>(nbr, mask, w, row_map, row_ptr, items, xT,
                              partials, yT, n, B, units_per_slice,
                              short_slices, chunk_slices, lg_bl, lg_kg,
                              row_warps, n_items, hub_items);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_hubs == 0) return err;
  fold_hubs<<<(n_hubs + kWarpsPerBlock - 1) / kWarpsPerBlock, kBlock, 0,
              stream>>>(partials, hubs, hub_chunks, yT, B, n_hubs, lg_bl);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// yT (n, B) from the sliced (nv, W) table, its row_map and its fold
// structure: row_ptr (n + 1), items (n_items: the first hub_items are hub
// chunks, the rest longer rows), hubs (n_hubs), hub_chunks (n_hubs + 1),
// all int32. x (B, n) f32 lies at strides (sb, si); thr may be null (no
// threshold). xm (n, B) f32 is caller-allocated scratch for x masked by
// the threshold and laid out (n, B); when it is null, x is read as it lies
// and must be (n, B) row-major (si == B, and sb == 1 or B == 1) with no
// threshold. partials (hub_items, B) f32 is caller-allocated scratch, null
// when hub_items is 0.
int ell_spmm_sliced_launch(const void* nbr, const void* mask, const void* w,
                           const void* row_map, const void* row_ptr,
                           const void* items, const void* hubs,
                           const void* hub_chunks, const void* x,
                           const void* thr, void* xm, void* partials,
                           void* yT, long long sb, long long si, int n, int W,
                           int B, int n_items, int hub_items, int n_hubs,
                           int short_slices, int chunk_slices, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xT = static_cast<const float*>(x);
  if (xm != nullptr) {
    const long long cells = static_cast<long long>(n) * B;
    prepare_x<<<static_cast<unsigned>((cells + kBlock - 1) / kBlock), kBlock,
                0, s>>>(xT, static_cast<const float*>(thr),
                        static_cast<float*>(xm), sb, si, n, B);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    xT = static_cast<const float*>(xm);
  } else if (thr != nullptr || si != B || (sb != 1 && B != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* i_nbr = static_cast<const int32_t*>(nbr);
  const auto* u_mask = static_cast<const uint8_t*>(mask);
  const auto* f_w = static_cast<const float*>(w);
  const auto* i_map = static_cast<const int32_t*>(row_map);
  const auto* i_ptr = static_cast<const int32_t*>(row_ptr);
  const auto* i_items = static_cast<const int32_t*>(items);
  const auto* i_hubs = static_cast<const int32_t*>(hubs);
  const auto* i_hub_chunks = static_cast<const int32_t*>(hub_chunks);
  auto* f_part = static_cast<float*>(partials);
  auto* f_y = static_cast<float*>(yT);
  // 16-byte units when the rows split into them and the pointers allow it
  const bool vec = W % 4 == 0 && aligned(nbr, 16) && aligned(w, 16) &&
                   aligned(mask, 4);
  const cudaError_t err =
      vec ? launch<4>(i_nbr, u_mask, f_w, i_map, i_ptr, i_items, i_hubs,
                      i_hub_chunks, xT, f_part, f_y, n, W, B, n_items,
                      hub_items, n_hubs, short_slices, chunk_slices, s)
          : launch<1>(i_nbr, u_mask, f_w, i_map, i_ptr, i_items, i_hubs,
                      i_hub_chunks, xT, f_part, f_y, n, W, B, n_items,
                      hub_items, n_hubs, short_slices, chunk_slices, s);
  return static_cast<int>(err);
}

const char* ell_spmm_sliced_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
