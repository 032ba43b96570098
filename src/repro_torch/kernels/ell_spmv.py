"""CUDA wrappers for the pull-form ELL products: FORA's push sweep and the
power iteration's step.

``ell_spmm_cuda`` (K1) replaces ``repro/kernels/ell_spmv.py::ell_spmm_pallas``
(body ``_spmm_partials``, run through ``_spmm_virtual_rows``) and
``ell_spmm_sliced_cuda`` (K2) replaces ``ell_spmm_sliced_pallas`` (body
``_ell_spmm_fold_kernel``). Both launch ``csrc/ell_spmm.cu``.
``ell_spmv_cuda`` (K4) replaces ``ell_spmv_pallas`` (body ``_ell_kernel``),
the one-vector product ``P^T x`` of exact power iteration, and launches
``csrc/ell_spmv.cu`` (its header says how its lanes are laid out).

What bounds them on the H100: bytes. Per call a sweep reads each table
cell once (int32 neighbour + bool mask + f32 weight, 9 bytes), gathers B
floats of x and one threshold per cell, and writes (rows, B) floats; it
does two flops per cell and batch column, far below the card's ratio of
operations to bytes. The Pallas kernels kept x resident in VMEM and the
sliced fold's (n + 1, B) accumulator resident across a sequential grid;
the card has neither a sequential grid nor a VMEM of that size. Instead:

* x is carried as (n, B), so one gather reads B contiguous floats, and at
  the sizes of this system's datasets x and the threshold stay in the
  50 MB L2 between gathers;
* lanes are laid out (row, cell, batch) so that narrow tables and B = 1
  still fill the warp (see the source's header);
* the sliced fold runs after the first pass, over its (n_virtual, B)
  scratch and the CSR offsets it derives from the ascending ``row_map``,
  as a fixed tree of fan-in 32 over each row's slices, so that a hub row's
  tens of thousands of slices spread over the grid like any other row's.
  No float atomics: each output has one summation order.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on PyTorch's current
stream, raises on a non-zero ``cudaGetLastError()``, and counts its
launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of each wrapper since the last reset_launches(); a K2 call counts
# once although it runs four CUDA kernels (rows, two fold levels, root)
LAUNCHES: dict[str, int] = {"ell_spmm": 0, "ell_spmm_sliced": 0,
                            "ell_spmv": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ell_spmm_dense_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
    "ell_spmm_sliced_launch": ([_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _I, _I, _P], _I),
    "ell_spmm_error_string": ([_I], ctypes.c_char_p),
}
_SPMV_SIGNATURES = {
    "ell_spmv_launch": ([_P, _P, _P, _P, _P, _I, _I, _P], _I),
    "ell_spmv_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_table(neighbors, mask, weights, device) -> tuple[int, int]:
    # messages are formatted only on failure: this runs once per sweep
    for t, name, dtype in ((neighbors, "neighbors", torch.int32),
                           (mask, "mask", torch.bool),
                           (weights, "weights", torch.float32)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, x on {device}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if t.shape != neighbors.shape or t.dim() != 2:
            raise ValueError(f"{name} must be 2-D like neighbors "
                             f"{tuple(neighbors.shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows, width = neighbors.shape
    if rows < 1 or width < 1 or rows > _INT32_MAX or width > _INT32_MAX:
        raise ValueError(f"push table shape {(rows, width)} out of range")
    return rows, width


def _prepare_x(x: torch.Tensor, threshold: torch.Tensor | None):
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be (B, n) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    B, n = x.shape
    if not (1 <= B <= _INT32_MAX and 1 <= n < _INT32_MAX):
        raise ValueError(f"x shape {(B, n)} out of range")
    # (n, B) row-major; free when x is already a transposed (n, B) tensor
    xT = x.t().contiguous()
    if threshold is None:
        return xT, None, B, n
    if threshold.device != x.device or threshold.dtype != torch.float32 \
            or threshold.shape != (n,):
        raise ValueError(f"threshold must be ({n},) float32 on {x.device}, "
                         f"got {threshold.dtype} {tuple(threshold.shape)} on "
                         f"{threshold.device}")
    return xT, threshold.contiguous(), B, n


def _lib() -> ctypes.CDLL:
    return _build.load("ell_spmm", _SIGNATURES)


def _raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.ell_spmm_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _spmv_lib() -> ctypes.CDLL:
    return _build.load("ell_spmv", _SPMV_SIGNATURES)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def ell_spmm_cuda(neighbors: torch.Tensor, mask: torch.Tensor,
                  weights: torch.Tensor, x: torch.Tensor,
                  threshold: torch.Tensor | None = None) -> torch.Tensor:
    """K1: dense pull-form SpMM on the card. neighbors/mask/weights are the
    (n, K) table (int32/bool/float32), x is (B, n) float32, ``threshold``
    (n,) fuses FORA's push condition. Returns (B, n), a transposed view of
    the kernel's (n, B) output."""
    xT, thr, B, n = _prepare_x(x, threshold)
    rows, width = _check_table(neighbors, mask, weights, x.device)
    if rows != n:
        raise ValueError(f"dense table has {rows} rows for n={n}")
    yT = torch.empty((rows, B), dtype=torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device.index).cuda_stream
    err = lib.ell_spmm_dense_launch(
        _ptr(neighbors), _ptr(mask), _ptr(weights), _ptr(xT), _ptr(thr),
        _ptr(yT), rows, width, B, stream)
    _raise_on(lib, err, "ell_spmm")
    LAUNCHES["ell_spmm"] += 1
    return yT.t()


def ell_spmm_sliced_cuda(neighbors: torch.Tensor, mask: torch.Tensor,
                         weights: torch.Tensor, row_map: torch.Tensor,
                         x: torch.Tensor,
                         threshold: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """K2: sliced pull-form SpMM with the row fold on the card.
    neighbors/mask/weights are the (n_virtual, W) table, ``row_map``
    (n_virtual,) int32 ascending maps each virtual row to its real row
    (the value n marks padding, which is dropped). x is (B, n) float32.
    Returns (B, n), a transposed view of the kernel's (n, B) output."""
    xT, thr, B, n = _prepare_x(x, threshold)
    nv, width = _check_table(neighbors, mask, weights, x.device)
    if row_map.device != x.device or row_map.dtype != torch.int32 \
            or row_map.shape != (nv,) or not row_map.is_contiguous():
        raise ValueError(f"row_map must be contiguous ({nv},) int32 on "
                         f"{x.device}, got {row_map.dtype} "
                         f"{tuple(row_map.shape)} on {row_map.device}")
    partials = torch.empty((nv, B), dtype=torch.float32, device=x.device)
    row_ptr = torch.empty((n + 1,), dtype=torch.int32, device=x.device)
    yT = torch.empty((n, B), dtype=torch.float32, device=x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device.index).cuda_stream
    err = lib.ell_spmm_sliced_launch(
        _ptr(neighbors), _ptr(mask), _ptr(weights), _ptr(row_map), _ptr(xT),
        _ptr(thr), _ptr(partials), _ptr(row_ptr), _ptr(yT), nv, width, B, n,
        stream)
    _raise_on(lib, err, "ell_spmm_sliced")
    LAUNCHES["ell_spmm_sliced"] += 1
    return yT.t()


def ell_spmv_cuda(neighbors: torch.Tensor, mask: torch.Tensor,
                  weights: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K4: ``y[i] = sum_j mask[i,j] * w[i,j] * x[neighbors[i,j]]`` on the
    card. neighbors (n, K) int32 and mask (n, K) bool, contiguous; weights
    (n, K) and x (n,) are cast to float32 as the JAX package casts them (a
    copy only when they are not float32 already). Returns (n,) float32."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 1:
        raise ValueError(f"x must be (n,), got {tuple(x.shape)}")
    x = x.to(torch.float32).contiguous()
    weights = weights.to(torch.float32)
    rows, width = _check_table(neighbors, mask, weights, x.device)
    if rows != x.shape[0]:
        raise ValueError(f"dense table has {rows} rows for x of "
                         f"{x.shape[0]}")
    y = torch.empty((rows,), dtype=torch.float32, device=x.device)
    lib = _spmv_lib()
    stream = torch.cuda.current_stream(x.device.index).cuda_stream
    err = lib.ell_spmv_launch(_ptr(neighbors), _ptr(mask), _ptr(weights),
                              _ptr(x), _ptr(y), rows, width, stream)
    if err != 0:
        msg = lib.ell_spmv_error_string(err).decode()
        raise RuntimeError(f"ell_spmv launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["ell_spmv"] += 1
    return y
