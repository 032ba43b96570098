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
// walks K in chunks of 128 lanes. The card has no VMEM of that size; x
// (6.5 MB at 1.6M nodes) stays in the 50 MB L2 between gathers. It is K1's
// row kernel (ell_rows.cuh) at B = 1 with no threshold, so it reads x as it
// lies and needs no first pass.
//
// What bounds it on the H100, measured at Pokec's order (30.6M live cells;
// device time, H100 80GB HBM3 at 700 W, chip_smoke.py phase 5 with the
// floors of tools/ell_floors.cu): the gathers, not the table's HBM bytes
// (spmm_cost's bound, 86 us). Each 4-byte gather of x moves a 32-byte L2
// sector; gathering x at the table's live neighbours and reading nothing
// else but their list takes 233 us (218 at scattered indices with no list:
// the L2's sector rate), reading the rows' live cells with no gather 137
// us, and this kernel 303 us, about what torch.sparse.mm takes (301). The
// earlier finding that four cells a lane was no faster than one is this
// floor: no lane layout moves fewer sectors. The old kernel gave each row
// 32 lanes at K = 48 (two rounds over j, each a chain of dependent loads:
// mask byte, then neighbour, then x), so most lanes loaded a mask byte and
// waited, 366 us. Here a row takes the plan's lanes (8 at that table), each
// loads up to two 16-byte units of neighbours and weights before it
// gathers, and cells past the row's extent are not read.

#include "ell_rows.cuh"

extern "C" {

// y (rows,) from the dense (rows, K) table, its extents (rows,) int32 and
// x (n,). lg_lanes is log2 of the plan's lanes a row. Returns a cudaError_t.
int ell_spmv_launch(const void* nbr, const void* mask, const void* w,
                    const void* extent, const void* x, void* y, int rows,
                    int K, int lg_lanes, void* stream) {
  return static_cast<int>(launch_rows(
      static_cast<const int32_t*>(nbr), static_cast<const uint8_t*>(mask),
      static_cast<const float*>(w), static_cast<const int32_t*>(extent),
      static_cast<const float*>(x), static_cast<float*>(y), rows, K, 1,
      lg_lanes, static_cast<cudaStream_t>(stream)));
}

const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
