// Pull-form dense ELL SpMM for FORA's push sweep (K1).
//
//   y[b, i] = sum_j mask[i,j] * w[i,j] * f(x[b, nbr[i,j]])
//   f(v)    = v * [v > thr[nbr[i,j]]]   when a threshold is given, else v
//
// It replaces repro/kernels/ell_spmv.py::ell_spmm_pallas (body
// _spmm_partials, run through _spmm_virtual_rows). Built with nvcc into a
// shared library with a plain C interface and called through ctypes from
// repro_torch/kernels/ell_spmv.py (ell_spmm_cuda), which checks every
// argument first. The sliced table's product (K2) is ell_spmm_sliced.cu;
// the row kernel is shared with K4 through ell_rows.cuh, whose header says
// how the lanes are laid out.
//
// What bounds it on the H100, measured at Pokec's order (1,632,803 x 48
// cells, 30.6M live, B = 1; device time, H100 80GB HBM3 at 700 W,
// chip_smoke.py phase 5 with the floors of tools/ell_floors.cu): not the
// table's HBM bytes (spmm_cost's bound, 88 us) but the gathers. Reading
// each row's live cells with no gather takes 137 us (the table floor); a
// minimal kernel that only gathers x at the 30.6M live neighbours takes
// 233 us, 218 us at as many scattered indices with no list (the gather
// floor): each 4-byte gather moves one 32-byte L2 sector, and L2's rate of
// random sectors, not HBM, sets that floor. The gathers also need L1's
// room to keep their misses in flight, so the frontier route below
// keeps its shared memory small. Two passes:
//
// 0. prepare_x, when a threshold is given or x is not laid out (n, B):
//    xm[i, b] = f(x[b, i]), the push condition applied once a source, so the
//    rows gather one float a live cell and never read thr (the old K1
//    gathered x and thr[src], 61.2M random reads at that size).
// 1. ell_rows: KG lanes a row, KG from the table's extents (the plan), so
//    a row with 19 live cells of 48 is read as five 16-byte units on eight
//    lanes instead of two rounds of 32 lanes; each lane loads its units'
//    neighbours, weights and mask bytes before it gathers, up to 8 gathers
//    in flight a lane.
//
// At B = 1 (a FORA query's push) the wrapper takes the frontier route on a
// table large enough for it to pay and whose bitmap fits
// (ell_spmv.py::frontier_group, from n alone): prepare_frontier also
// writes one bit a group of g nodes, and ell_rows_frontier gathers no
// source whose group holds no node above the threshold. Most sweeps of a
// push have a small frontier, and a gather of a zero costs the L2 sector
// all the same.

#include "ell_rows.cuh"

extern "C" {

// K1: yT (rows, B) from the dense (rows, K) table and its extents (rows,)
// int32. x (B, n) f32 lies at strides (sb, si); thr (n,) may be null (no
// threshold). xm (n, B) f32 is caller-allocated scratch for x masked by the
// threshold and laid out (n, B); when it is null, x is read as it lies and
// must be (n, B) row-major (si == B, and sb == 1 or B == 1) with no
// threshold. The table may be a block of rows != n of a node-sharded
// residency: its cells hold global node ids into x's n nodes. lg_lanes is
// log2 of the plan's lanes a row. lg_g >= 0 takes the frontier route
// (B = 1) with groups of 2^lg_g of x's nodes a bit: xm (n,) and bits (one
// bit a group, in 32-bit words) are then required. Returns a cudaError_t.
int ell_spmm_dense_launch(const void* nbr, const void* mask, const void* w,
                          const void* extent, const void* x, const void* thr,
                          void* xm, void* bits, void* yT, long long sb,
                          long long si, int rows, int n, int K, int B,
                          int lg_lanes, int lg_g, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lg_g >= 0) {
    if (B != 1 || xm == nullptr || bits == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_frontier(
        static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(mask),
        static_cast<const float*>(w), static_cast<const int32_t*>(extent),
        static_cast<const float*>(x), static_cast<const float*>(thr),
        static_cast<float*>(xm), static_cast<unsigned*>(bits),
        static_cast<float*>(yT), si, rows, n, K, lg_lanes, lg_g, s));
  }
  const float* xT = static_cast<const float*>(x);
  if (xm != nullptr) {
    const long long cells = static_cast<long long>(n) * B;
    prepare_x<<<static_cast<unsigned>((cells + kBlock - 1) /
                                           kBlock),
                     kBlock, 0, s>>>(xT, static_cast<const float*>(thr),
                                          static_cast<float*>(xm), sb, si, n,
                                          B);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    xT = static_cast<const float*>(xm);
  } else if (thr != nullptr || si != B || (sb != 1 && B != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_rows(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(w), static_cast<const int32_t*>(extent), xT,
      static_cast<float*>(yT), rows, K, B, lg_lanes, s));
}

const char* ell_spmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
