"""CUDA wrappers for the pull-form ELL products: FORA's push sweep and the
power iteration's step.

``ell_spmm_cuda`` (K1) replaces ``repro/kernels/ell_spmv.py::ell_spmm_pallas``
(body ``_spmm_partials``, run through ``_spmm_virtual_rows``) and launches
``csrc/ell_spmm.cu``. ``ell_spmm_sliced_cuda`` (K2) replaces
``ell_spmm_sliced_pallas`` (line 234, body ``_ell_spmm_fold_kernel``) and
launches ``csrc/ell_spmm_sliced.cu``. ``ell_spmv_cuda`` (K4) replaces
``ell_spmv_pallas`` (body ``_ell_kernel``), the one-vector product
``P^T x`` of exact power iteration, and launches ``csrc/ell_spmv.cu``. K1
and K4 share one row kernel (``csrc/ell_rows.cuh``). Each source's header
says how its lanes are laid out.

What bounds them on the H100: bytes. Per call a sweep reads each table
cell once (int32 neighbour + bool mask + f32 weight, 9 bytes), gathers B
floats of x a live cell, and writes (rows, B) floats; it does two flops
per cell and batch column, far below the card's ratio of operations to
bytes. Each 4-byte gather moves a 32-byte L2 sector, so on a large table
the gathers, not the table, set the pace. The Pallas kernels kept x
resident in VMEM and the sliced fold's (n + 1, B) accumulator resident
across a sequential grid; the card has neither a sequential grid nor a
VMEM of that size. Instead:

* x is carried as (n, B), so one gather reads B contiguous floats, and at
  the sizes of this system's datasets x stays in the 50 MB L2 between
  gathers; K1 and K2 apply the push threshold once a source in a first
  pass, so a live cell gathers one float and no threshold;
* lanes are laid out (row, cell, batch) so that narrow tables and B = 1
  still fill the warp. On a dense table the lanes a row takes and the
  cells it reads follow its live extent, a constant of the table
  (:class:`DensePlan`, built once by :func:`dense_plan`), not K;
* the sliced fold's structure is a constant of the table
  (:class:`SlicedFold`, built once by :func:`sliced_fold`): each row is
  folded by the lanes that read its cells, in one pass, short rows several
  to a warp and longer rows a warp each, and the few hub rows, longer than
  a warp's share, are cut into chunks of a warp's share whose sums a second
  kernel adds in a fixed order. No float
  atomics: each output has one summation order.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on PyTorch's current
stream, raises on a non-zero ``cudaGetLastError()``, and counts its
launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

# launches of each wrapper since the last reset_launches(); a K1 or K2 call
# counts once although it runs two CUDA kernels when it applies a threshold
# (the first pass, then the rows; K2's hubs' fold a third)
LAUNCHES: dict[str, int] = {"ell_spmm": 0, "ell_spmm_sliced": 0,
                            "ell_spmv": 0}
# of the ell_spmm calls, those that took the frontier route
ROUTES: dict[str, int] = {"ell_spmm_frontier": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "ell_spmm_dense_launch": ([_P] * 9 + [ctypes.c_longlong] * 2
                              + [_I] * 6 + [_P], _I),
    "ell_spmm_error_string": ([_I], ctypes.c_char_p),
}
_SLICED_SIGNATURES = {
    "ell_spmm_sliced_launch": ([_P] * 13 + [ctypes.c_longlong] * 2
                               + [_I] * 8 + [_P], _I),
    "ell_spmm_sliced_error_string": ([_I], ctypes.c_char_p),
}
_SPMV_SIGNATURES = {
    "ell_spmv_launch": ([_P] * 6 + [_I] * 3 + [_P], _I),
    "ell_spmv_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = 2**31 - 1
# cells one warp item holds at most, and cells a short row holds at most:
# a row of more than WARP_CELLS // W slices is a hub, cut into warp items of
# that many slices; a row of more than SHORT_CELLS // W slices is a warp
# item of its own; the rest share warps
WARP_CELLS = 256
SHORT_CELLS = 16
# cells one 16-byte unit of a dense row holds, when K is a multiple of it
DENSE_VEC = 4
# K1's frontier route: the bitmap a block of the rows kernel holds in shared
# memory (two blocks an SM leave the rest of the SM's 256 KB to L1, which
# the gathers need), at most FRONTIER_GROUP nodes a bit
FRONTIER_BYTES = 64 << 10
FRONTIER_GROUP = 4
# ... and the least n that takes it: the least n at which the frontier
# route took less device time over a push than the plain route
# (chip_smoke.py phase 5, PERF.md)
FRONTIER_MIN_N = 1 << 14


class DensePlan(NamedTuple):
    """The row plan of one dense table, a constant of the table: built once
    by :func:`dense_plan` (``DeviceGraph`` carries it as ``in_plan``) and
    passed to every K1 and K4 call on that table. It must come from that
    table's own mask: the wrappers check its shape, not its extents, and a
    plan of another mask of the same shape reads each row only up to that
    mask's extent."""

    extent: torch.Tensor       # (n,) int32: 1 + last live column, 0 if none
    lanes: int                 # lanes a row takes at B = 1, a power of two
    width: int                 # K of the table


def dense_plan(mask: torch.Tensor) -> DensePlan:
    """The row plan of a dense (n, K) table from its mask, on the mask's
    device. ``extent[i]`` is 1 + the last live column of row i, 0 for a row
    with no live cell; the kernels read no cell at or past it. A row's
    units are its cells below the extent in runs of ``DENSE_VEC`` (one
    16-byte load) when K is a multiple of it, else one by one, and
    ``lanes`` is the least power of two at or above the mean units of the
    rows that have any (1 when none has), at most 32: the lanes that share
    a row, so that most rows are read in one pass of their lanes and few
    lanes load nothing. One read back to the host, once a table."""
    if mask.dim() != 2 or mask.dtype != torch.bool or mask.shape[1] < 1:
        raise ValueError(f"mask must be (n, K >= 1) bool, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    width = int(mask.shape[1])
    col = torch.arange(1, width + 1, dtype=torch.int32, device=mask.device)
    extent = torch.where(mask, col, 0).amax(dim=1).to(torch.int32)
    vec = DENSE_VEC if width % DENSE_VEC == 0 else 1
    units = (extent + vec - 1) // vec
    held = units[units > 0]
    mean = float(held.double().mean()) if held.numel() else 1.0
    lanes = 1
    while lanes < min(mean, 32):
        lanes *= 2
    return DensePlan(extent=extent.contiguous(), lanes=lanes, width=width)


class SlicedFold(NamedTuple):
    """The fold structure of one sliced table, a constant of the table:
    built once by :func:`sliced_fold` (``DeviceGraph`` carries it as
    ``in_fold``) and passed to every K2 call on that table."""

    row_ptr: torch.Tensor      # (n + 1,) int32: first virtual row of each row
    items: torch.Tensor        # (I,) int32: first virtual row of each item
    hubs: torch.Tensor         # (H,) int32: rows of more than chunk_slices
    hub_chunks: torch.Tensor   # (H + 1,) int32: hub h's items, as offsets
    hub_items: int             # the first hub_items items are hub chunks
    short_slices: int          # slices a short row holds at most
    chunk_slices: int          # slices one warp item holds at most
    rows: int                  # virtual rows of the table
    width: int                 # W of the table


def sliced_fold(row_map: torch.Tensor, n: int, width: int) -> SlicedFold:
    """The fold structure of a sliced table from its ascending ``row_map``
    (n_virtual,) int32, on ``row_map``'s device. ``row_ptr[r]`` is the
    first virtual row whose real row is >= r, so padding rows (``row_map``
    n) lie past ``row_ptr[n]`` and are never read. A row of more than
    ``chunk_slices = max(1, WARP_CELLS // width)`` slices is a hub, cut into
    warp items of ``chunk_slices`` slices, hub h owning items
    ``hub_chunks[h]:hub_chunks[h + 1]``; then each row of more than
    ``short_slices = max(1, SHORT_CELLS // width)`` slices and no more than
    ``chunk_slices`` is one warp item. ``items[k]`` is the first virtual
    row of item k."""
    if row_map.dim() != 1 or row_map.dtype != torch.int32:
        raise ValueError(f"row_map must be (n_virtual,) int32, got "
                         f"{row_map.dtype} {tuple(row_map.shape)}")
    if n < 0 or width < 1:
        raise ValueError(f"need n >= 0 and width >= 1, got {n}, {width}")
    dev = row_map.device
    cs = max(1, WARP_CELLS // width)
    ss = max(1, SHORT_CELLS // width)
    row_ptr = torch.searchsorted(
        row_map.contiguous(),
        torch.arange(n + 1, dtype=torch.int32, device=dev), out_int32=True)
    slices = row_ptr[1:] - row_ptr[:-1]
    hubs = torch.nonzero(slices > cs).reshape(-1).to(torch.int32)
    per_hub = (slices[hubs.long()] + cs - 1) // cs
    hub_chunks = torch.zeros(hubs.numel() + 1, dtype=torch.int32, device=dev)
    hub_chunks[1:] = torch.cumsum(per_hub, 0)
    owner = torch.repeat_interleave(
        torch.arange(hubs.numel(), device=dev), per_hub.long())
    rank = torch.arange(owner.numel(), device=dev) - hub_chunks[owner]
    chunks = row_ptr[hubs.long()][owner] + rank * cs
    longer = row_ptr[:-1][(slices > ss) & (slices <= cs)]
    return SlicedFold(row_ptr=row_ptr,
                      items=torch.cat([chunks, longer]).to(torch.int32),
                      hubs=hubs, hub_chunks=hub_chunks,
                      hub_items=int(owner.numel()), short_slices=ss,
                      chunk_slices=cs, rows=int(row_map.shape[0]),
                      width=width)


def bitmap_group(n: int) -> int:
    """Nodes a bit of a frontier bitmap over n nodes: the least power of
    two g <= FRONTIER_GROUP whose ceil(n / g) bits fit FRONTIER_BYTES, or 0
    where none fits."""
    g = 1
    while -(-n // g) > FRONTIER_BYTES * 8:
        g *= 2
        if g > FRONTIER_GROUP:
            return 0
    return g


def frontier_group(n: int, B: int) -> int:
    """Nodes a bit of K1's frontier bitmap for an (n, B) sweep, or 0 for the
    plain route: :func:`bitmap_group` at B = 1 and n >= FRONTIER_MIN_N. A
    push at B = 1 (a FORA query) then gathers only the sources whose group
    holds a node above the threshold; a wider batch gathers the union of
    its columns' frontiers, and a smaller table, whose gathers cost less
    than the bitmap's pass, takes the plain route."""
    if B != 1 or n < FRONTIER_MIN_N:
        return 0
    return bitmap_group(n)


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


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


def _check_x(x: torch.Tensor, threshold: torch.Tensor | None):
    """(B, n, the threshold contiguous or None) after checking x (B, n)
    float32 on a CUDA device and the threshold (n,) float32 beside it."""
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"x must be (B, n) float32, got {x.dtype} "
                         f"{tuple(x.shape)}")
    B, n = x.shape
    if not (1 <= B <= _INT32_MAX and 1 <= n < _INT32_MAX):
        raise ValueError(f"x shape {(B, n)} out of range")
    if threshold is None:
        return B, n, None
    if threshold.device != x.device or threshold.dtype != torch.float32 \
            or threshold.shape != (n,):
        raise ValueError(f"threshold must be ({n},) float32 on {x.device}, "
                         f"got {threshold.dtype} {tuple(threshold.shape)} on "
                         f"{threshold.device}")
    return B, n, threshold.contiguous()


def _lib() -> ctypes.CDLL:
    return _build.load("ell_spmm", _SIGNATURES)


def _sliced_lib() -> ctypes.CDLL:
    return _build.load("ell_spmm_sliced", _SLICED_SIGNATURES)


def _raise_on(err: int, message, what: str) -> None:
    if err != 0:
        msg = message(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def _spmv_lib() -> ctypes.CDLL:
    return _build.load("ell_spmv", _SPMV_SIGNATURES)


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _check_plan(plan: DensePlan | None, mask: torch.Tensor) -> DensePlan:
    """The table's plan, derived from the mask when not given, after
    checking that it fits the table."""
    if plan is None:
        return dense_plan(mask)
    rows, width = mask.shape
    ext = plan.extent
    if plan.width != width or ext.shape != (rows,) \
            or ext.dtype != torch.int32 or ext.device != mask.device \
            or not ext.is_contiguous():
        raise ValueError(f"plan is for width {plan.width} with extent "
                         f"{ext.dtype} {tuple(ext.shape)} on {ext.device}; "
                         f"the table is {rows} x {width} on {mask.device}")
    if not (plan.lanes >= 1 and plan.lanes & (plan.lanes - 1) == 0
            and plan.lanes <= 32):
        raise ValueError(f"plan.lanes must be a power of two <= 32, got "
                         f"{plan.lanes}")
    return plan


def ell_spmm_cuda(neighbors: torch.Tensor, mask: torch.Tensor,
                  weights: torch.Tensor, x: torch.Tensor,
                  threshold: torch.Tensor | None = None,
                  plan: DensePlan | None = None) -> torch.Tensor:
    """K1: dense pull-form SpMM on the card. neighbors/mask/weights are the
    (rows, K) table (int32/bool/float32): all n rows, or a block of them
    (a shard of a node-sharded residency) whose cells hold global node
    ids. x is (B, n) float32, ``threshold`` (n,) fuses FORA's push
    condition. ``plan`` is the table's :func:`dense_plan`; without it the
    call derives it first (one reduction over the mask and a read back),
    so a sweep loop passes it. The route follows (n, B) alone
    (:func:`frontier_group`): the frontier route's bitmap covers x's n
    nodes, its rows loop the table's rows. Returns (B, rows), a transposed
    view of the kernel's (rows, B) output."""
    B, n, thr = _check_x(x, threshold)
    rows, width = _check_table(neighbors, mask, weights, x.device)
    plan = _check_plan(plan, mask)
    # x masked by the threshold and laid out (n, B) by the kernel's first
    # pass, unless x lies (n, B) already (an (n, B) tensor's transpose, as
    # the push passes it) and there is no threshold; the frontier route's
    # first pass always writes xm and the bitmap
    group = frontier_group(n, B)
    laid_out = x.stride(1) == B and (x.stride(0) == 1 or B == 1)
    xm = None if thr is None and laid_out and not group else \
        torch.empty((n, B), dtype=torch.float32, device=x.device)
    bits = torch.empty(-(-n // (32 * group)), dtype=torch.int32,
                       device=x.device) if group else None
    yT = torch.empty((rows, B), dtype=torch.float32, device=x.device)
    lib = _lib()
    with _build.on_card(x.device) as stream:
        err = lib.ell_spmm_dense_launch(
            _ptr(neighbors), _ptr(mask), _ptr(weights), _ptr(plan.extent),
            _ptr(x), _ptr(thr), _ptr(xm), _ptr(bits), _ptr(yT), x.stride(0),
            x.stride(1), rows, n, width, B, plan.lanes.bit_length() - 1,
            group.bit_length() - 1, stream)
    _raise_on(err, lib.ell_spmm_error_string, "ell_spmm")
    LAUNCHES["ell_spmm"] += 1
    ROUTES["ell_spmm_frontier"] += bool(group)
    return yT.t()


def ell_spmm_sliced_cuda(neighbors: torch.Tensor, mask: torch.Tensor,
                         weights: torch.Tensor, row_map: torch.Tensor,
                         x: torch.Tensor,
                         threshold: torch.Tensor | None = None,
                         fold: SlicedFold | None = None) -> torch.Tensor:
    """K2: sliced pull-form SpMM with the row fold on the card.
    neighbors/mask/weights are the (n_virtual, W) table, ``row_map``
    (n_virtual,) int32 ascending maps each virtual row to its real row
    (the value n marks padding, which is dropped). x is (B, n) float32.
    ``fold`` is the table's :func:`sliced_fold`; without it the call
    derives it first (a ``searchsorted`` and a few small ops), so a sweep
    loop passes it. Returns (B, n), a transposed view of the kernel's
    (n, B) output."""
    B, n, thr = _check_x(x, threshold)
    nv, width = _check_table(neighbors, mask, weights, x.device)
    if row_map.device != x.device or row_map.dtype != torch.int32 \
            or row_map.shape != (nv,) or not row_map.is_contiguous():
        raise ValueError(f"row_map must be contiguous ({nv},) int32 on "
                         f"{x.device}, got {row_map.dtype} "
                         f"{tuple(row_map.shape)} on {row_map.device}")
    if fold is None:
        fold = sliced_fold(row_map, n, width)
    if (fold.rows, fold.width) != (nv, width) \
            or fold.row_ptr.shape != (n + 1,):
        raise ValueError(f"fold is for {fold.rows} x {fold.width} rows and "
                         f"{fold.row_ptr.shape[0] - 1} nodes, the table is "
                         f"{nv} x {width} for n={n}")
    for name in ("row_ptr", "items", "hubs", "hub_chunks"):
        t = getattr(fold, name)
        if t.device != x.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"fold.{name} must be contiguous int32 on "
                             f"{x.device}")
    # x masked by the threshold and laid out (n, B) by the kernel's first
    # pass, unless x lies (n, B) already (an (n, B) tensor's transpose, as
    # the push passes it) and there is no threshold
    laid_out = x.stride(1) == B and (x.stride(0) == 1 or B == 1)
    xm = None if thr is None and laid_out else \
        torch.empty((n, B), dtype=torch.float32, device=x.device)
    partials = torch.empty((fold.hub_items, B), dtype=torch.float32,
                           device=x.device) if fold.hub_items else None
    yT = torch.empty((n, B), dtype=torch.float32, device=x.device)
    lib = _sliced_lib()
    with _build.on_card(x.device) as stream:
        err = lib.ell_spmm_sliced_launch(
            _ptr(neighbors), _ptr(mask), _ptr(weights), _ptr(row_map),
            _ptr(fold.row_ptr), _ptr(fold.items), _ptr(fold.hubs),
            _ptr(fold.hub_chunks), _ptr(x), _ptr(thr), _ptr(xm),
            _ptr(partials), _ptr(yT), x.stride(0), x.stride(1), n, width, B,
            fold.items.shape[0], fold.hub_items, fold.hubs.shape[0],
            fold.short_slices, fold.chunk_slices, stream)
    _raise_on(err, lib.ell_spmm_sliced_error_string, "ell_spmm_sliced")
    LAUNCHES["ell_spmm_sliced"] += 1
    return yT.t()


def ell_spmv_cuda(neighbors: torch.Tensor, mask: torch.Tensor,
                  weights: torch.Tensor, x: torch.Tensor,
                  plan: DensePlan | None = None) -> torch.Tensor:
    """K4: ``y[i] = sum_j mask[i,j] * w[i,j] * x[neighbors[i,j]]`` on the
    card. neighbors (n, K) int32 and mask (n, K) bool, contiguous; weights
    (n, K) and x (n,) are cast to float32 as the JAX package casts them (a
    copy only when they are not float32 already). ``plan`` is the table's
    :func:`dense_plan`, derived first when not given. Returns (n,)
    float32."""
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
    plan = _check_plan(plan, mask)
    y = torch.empty((rows,), dtype=torch.float32, device=x.device)
    lib = _spmv_lib()
    with _build.on_card(x.device) as stream:
        err = lib.ell_spmv_launch(_ptr(neighbors), _ptr(mask), _ptr(weights),
                                  _ptr(plan.extent), _ptr(x), _ptr(y), rows,
                                  width, plan.lanes.bit_length() - 1, stream)
    _raise_on(err, lib.ell_spmv_error_string, "ell_spmv")
    LAUNCHES["ell_spmv"] += 1
    return y
