"""CUDA wrapper for the walk-endpoint gather of the index-backed FORA walk.

``walk_endpoint_gather_cuda`` (K3) replaces
``repro/kernels/walk_gather.py::walk_endpoint_gather_pallas`` (line 57, body
``_gather_kernel``) and launches ``csrc/walk_gather.cu``.

What bounds it on the H100: bytes. A call writes the (B, n) output once,
reads B * L starts and weights, and makes two random 4-byte reads per lane
(the start's budget and the stored endpoint, one 32-byte sector each); it
adds one float per lane. The Pallas kernel kept both (B, L) operands
resident in VMEM and compared every lane with every node of an output
block, O(B * L * n) work shaped for the TPU's vector unit. On the card
that compare would cost n / 32 warp instructions a lane; instead:

* one thread a lane, a warp a 32-lane chunk, gathers each lane's cell
  (-1 for a dropped lane) and adds each cell's lanes of the chunk in lane
  order, over the whole card at once, into a (B, L) scratch of cells and
  chunk sums;
* a grid of blocks, one an SM, each owning a range of output cells of one
  row (:func:`fold_plan` sizes the ranges so that the grid fills the card
  once at any B), adds the chunk sums of its cells in lane order, group by
  group of 1,024 lanes, and writes its range once, zeros included;
* no float atomics: every output cell has one summation order, fixed by
  its own lanes (lanes within a chunk, chunks within a group, groups within
  a segment of 32,768 lanes, segments), so a second launch gives the same
  bits, and a hub cell that collects thousands of lanes rounds a few dozen
  times at most instead of once per lane, and costs no more time than
  lanes spread over many cells.

The wrapper checks device, dtype, shape and contiguity, allocates the
output and scratch with ``torch.empty``, launches on PyTorch's current
stream, raises on a non-zero ``cudaGetLastError()``, and counts its
launches in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches since the last reset_launches(); one call counts once although it
# runs two CUDA kernels (the gather, then the fold)
LAUNCHES: dict[str, int] = {"walk_endpoint_gather": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "walk_gather_launch": ([_P] * 7 + [_I] * 5 + [_P], _I),
    "walk_gather_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = 2**31 - 1
_MAX_ROWS = 65535          # the grid's y dimension carries the row
FOLD_BLOCKS_PER_SM = 1     # fold blocks the plan aims for, per SM
FOLD_MAX_CELLS = 4096      # cells a fold block owns at most (kMaxCells)
_SMS: dict[int, int] = {}


def fold_plan(n: int, B: int, sms: int) -> tuple[int, int]:
    """(cells each fold block owns, fold blocks a row) for a (B, n) output
    on a card of ``sms`` SMs: about FOLD_BLOCKS_PER_SM blocks per SM over
    the whole grid, each owning a multiple of 32 cells, at least 32 and at
    most FOLD_MAX_CELLS. The last block of a row owns the rest."""
    if n < 1 or B < 1 or sms < 1:
        raise ValueError(f"need n, B, sms >= 1, got {n}, {B}, {sms}")
    per_row = max(1, -(-FOLD_BLOCKS_PER_SM * sms // B))
    cells = min(FOLD_MAX_CELLS, 32 * -(-n // (32 * per_row)))
    return cells, -(-n // cells)


def _sm_count(dev: torch.device) -> int:
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("walk_gather", _SIGNATURES)


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: tuple[int, ...], device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape} {dtype} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device} (contiguous: {t.is_contiguous()})")


def walk_endpoint_gather_cuda(endpoints: torch.Tensor, budget: torch.Tensor,
                              starts: torch.Tensor,
                              weights: torch.Tensor) -> torch.Tensor:
    """K3: fold the stored endpoints of B query rows on the card.

    endpoints (n, W) int32, budget (n,) int32, starts (B, L) int32 with
    L <= W (lane i reads table column i), weights (B, L) float32, all
    contiguous on one CUDA device. Returns (B, n) float32; lanes with
    ``i >= budget[start]`` contribute nothing. Values are not checked: a
    lane whose start or stored endpoint lies outside [0, n) is dropped on
    the card, where the plain version raises. ``WalkIndex`` builds and
    ``WalkIndex.from_arrays`` admit no such table, and the fused query
    samples starts in [0, n)."""
    dev = starts.device
    if dev.type != "cuda":
        raise ValueError(f"starts must be a CUDA tensor, got {dev}")
    if endpoints.dim() != 2 or starts.dim() != 2:
        raise ValueError(f"need endpoints (n, W) and starts (B, L), got "
                         f"{tuple(endpoints.shape)} and {tuple(starts.shape)}")
    n, W = endpoints.shape
    B, L = starts.shape
    if not (1 <= n <= _INT32_MAX and 1 <= W <= _INT32_MAX
            and 1 <= B <= _MAX_ROWS and 1 <= L <= W):
        raise ValueError(f"shapes out of range: endpoints {(n, W)}, starts "
                         f"{(B, L)} (need 1 <= B <= {_MAX_ROWS}, "
                         f"1 <= L <= W)")
    _check(endpoints, "endpoints", torch.int32, (n, W), dev)
    _check(budget, "budget", torch.int32, (n,), dev)
    _check(starts, "starts", torch.int32, (B, L), dev)
    _check(weights, "weights", torch.float32, (B, L), dev)
    lib = _lib()
    cells_per_block, _ = fold_plan(n, B, _sm_count(dev))
    cells = torch.empty((B, L), dtype=torch.int32, device=dev)
    values = torch.empty((B, L), dtype=torch.float32, device=dev)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    with _build.on_card(dev) as stream:
        err = lib.walk_gather_launch(
            endpoints.data_ptr(), budget.data_ptr(), starts.data_ptr(),
            weights.data_ptr(), cells.data_ptr(), values.data_ptr(),
            out.data_ptr(), n, W, B, L, cells_per_block, stream)
    if err != 0:
        msg = lib.walk_gather_error_string(err).decode()
        raise RuntimeError(f"walk_endpoint_gather launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["walk_endpoint_gather"] += 1
    return out
