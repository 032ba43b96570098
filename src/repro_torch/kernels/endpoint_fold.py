"""CUDA wrapper for the live walk-endpoint fold.

``endpoint_fold_cuda`` launches ``csrc/endpoint_fold.cu``. It computes what
``repro/ppr/random_walk.py`` leaves to XLA's ``segment_sum`` at the end of
``residual_walks`` (line 213) and ``source_walks`` (line 256): no Pallas
kernel, so no TPU kernel is replaced. The port's plain version,
``ref.endpoint_fold_ref``, is ``index_add_``, which on a card sums with
float atomics in an order that changes from run to run; this kernel gives
every output cell one summation order, fixed by its own lanes, so a
query's row has the same bits on every run.

What bounds it on the H100: bytes. A call reads the (B, W) endpoints and
weights once and writes the (B, n) output once; it adds one float a lane.
A fold that reads every lane once per block of output cells (K3's
``fold_cells``) would read (n / range) * W lanes a row: about 72 M at the
paper path's n = 281,903 and W = 2^20. Instead:

* one block a tile of :data:`TILE` lanes of one row combines each 32-lane
  chunk's lanes of one cell in lane order, sorts the tile's entries by
  (cell, lane) (a bitonic sort held in registers, a warp's keys its own
  eight chunks: warp shuffles and register swaps, shared memory only
  between warps; 32-bit keys below n = 2^19), adds each cell's run in
  lane order, and writes the tile's sorted sums and where each bucket of
  :data:`RANGE` cells begins among them;
* one block a bucket of one row reads only its own cells' runs, tile by
  tile, four steps of a run at once, and adds each cell's tile sums in
  tile order;
* no float atomics: each output cell has one summation order (lanes within
  a chunk, chunks within a group of 32, groups within a tile, tiles within
  a group of 32, groups), so a second launch gives the same bits, and a
  hub that every lane reaches rounds a few dozen times a level at most;
* a lane of weight 0 (past its row's active walks) or with an endpoint
  outside [0, n) takes no part, and a tile of such lanes only writes that
  it has none.

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
# runs two CUDA kernels (the tiles' sort, then the buckets' fold)
LAUNCHES: dict[str, int] = {"endpoint_fold": 0}

TILE = 8192            # lanes a sort block takes (kTile in the source)
RANGE = 512            # output cells a fold block owns (kRange)
_MAX_ROWS = 65535      # the grid's y dimension carries the row
_INT32_MAX = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "endpoint_fold_launch": ([_P] * 6 + [_I] * 5 + [_P], _I),
    "endpoint_fold_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def fold_shape(n: int, W: int) -> tuple[int, int]:
    """(tiles a row, buckets a row) of a fold of W lanes onto n cells."""
    if n < 1 or W < 1:
        raise ValueError(f"need n, W >= 1, got {n}, {W}")
    return -(-W // TILE), -(-n // RANGE)


def _lib() -> ctypes.CDLL:
    return _build.load("endpoint_fold", _SIGNATURES)


def endpoint_fold_cuda(pos: torch.Tensor, weights: torch.Tensor,
                       n: int) -> torch.Tensor:
    """The live endpoint fold on the card: ``out[b, t] = sum_i w[b,i] *
    [pos[b,i] == t]``. pos (B, W) int32 and weights (B, W) float32,
    contiguous on one CUDA device; returns (B, n) float32. Values are not
    checked: a lane whose pos lies outside [0, n) is dropped on the card,
    where the plain version raises; the walks only reach nodes of the
    graph."""
    dev = pos.device
    if dev.type != "cuda":
        raise ValueError(f"pos must be a CUDA tensor, got {dev}")
    if pos.dim() != 2 or pos.dtype != torch.int32 or not pos.is_contiguous():
        raise ValueError(f"pos must be contiguous (B, W) int32, got "
                         f"{pos.dtype} {tuple(pos.shape)} (contiguous: "
                         f"{pos.is_contiguous()})")
    if weights.device != dev or weights.dtype != torch.float32 \
            or weights.shape != pos.shape or not weights.is_contiguous():
        raise ValueError(f"weights must be contiguous {tuple(pos.shape)} "
                         f"float32 on {dev}, got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")
    B, W = pos.shape
    if not (1 <= B <= _MAX_ROWS and 1 <= W <= _INT32_MAX
            and 1 <= n <= _INT32_MAX):
        raise ValueError(f"shapes out of range: pos {(B, W)}, n={n} (need "
                         f"1 <= B <= {_MAX_ROWS}, W >= 1, n >= 1)")
    tiles, nb = fold_shape(n, W)
    lib = _lib()
    cells = torch.empty((B, tiles * TILE), dtype=torch.int32, device=dev)
    sums = torch.empty((B, tiles * TILE), dtype=torch.float32, device=dev)
    starts = torch.empty((B, nb + 1, tiles), dtype=torch.int32, device=dev)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    err = lib.endpoint_fold_launch(
        pos.data_ptr(), weights.data_ptr(), cells.data_ptr(),
        sums.data_ptr(), starts.data_ptr(), out.data_ptr(), n, W, B, tiles,
        nb, stream)
    if err != 0:
        msg = lib.endpoint_fold_error_string(err).decode()
        raise RuntimeError(f"endpoint_fold launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["endpoint_fold"] += 1
    return out
