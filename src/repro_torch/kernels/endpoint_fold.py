"""CUDA wrapper for the live walk-endpoint fold.

``endpoint_fold_cuda`` launches ``csrc/endpoint_fold.cu``. It computes what
``repro/ppr/random_walk.py`` leaves to XLA's ``segment_sum`` at the end of
``residual_walks`` (line 213) and ``source_walks`` (line 256): no Pallas
kernel, so no TPU kernel is replaced. The port's plain version,
``ref.endpoint_fold_ref``, is ``index_add_``, which on a card sums with
float atomics in an order that changes from run to run. This kernel sums
in fixed point instead: each lane's weight becomes an int64 on a scale set
by its row's largest weight and the lane count, and the integers are added
with integer atomics, whose sum has the same bits in any order. So a
query's row has the same bits on every run, at any batch width and under
any permutation of its lanes; ``ref.endpoint_fold_fixed_ref`` repeats the
arithmetic in torch and gives those bits exactly. The source's header
derives the error bound and the inputs it holds for.

What bounds it on the H100: bytes. A call reads the (B, W) endpoints and
weights once and writes the (B, n) output once. Three kernels a call:

* ``scale_rows`` (:func:`fold_scratch`'s ``parts`` blocks a row): each
  block's largest participating weight, and zeros of its slice of the
  (B, n) int64 sums;
* ``add_lanes`` (a block 4,096 lanes of a row): the row's scale, each
  lane's integer, the lanes of one cell within a warp added together, then
  one add to the block's table in shared memory (a cell that two lanes of
  a warp share, or a lone lane one time in two, claims a slot there; the
  others only look for their cell's), or one 64-bit integer atomic where
  the cell has no slot, and one such atomic a slot at the block's end;
* ``write_out``: each sum back to float32, every cell written once.

A lane of weight 0 (past its row's active walks) or with an endpoint
outside [0, n) takes no part. The wrapper checks device, dtype, shape and
contiguity, allocates the output and scratch with ``torch.empty`` (the
kernels initialise what they read), launches on PyTorch's current stream,
raises on a non-zero ``cudaGetLastError()``, and counts its launches in
:data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches since the last reset_launches(); one call counts once although it
# runs three CUDA kernels
LAUNCHES: dict[str, int] = {"endpoint_fold": 0}

SPAN = 4096            # lanes a block of add_lanes takes (kSpan)
MAX_PARTS = 256        # scale_rows blocks a row, at most (kMaxParts)
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


def fold_scratch(n: int, W: int) -> tuple[int, int]:
    """(parts, log_w) of a fold of W lanes onto n cells: the ``scale_rows``
    blocks a row (one row maximum each, in the (B, parts) scratch), about
    one a :data:`SPAN` of lanes or cells, and ceil(log2 W), the lane
    count's headroom in the row's scale."""
    if n < 1 or W < 1:
        raise ValueError(f"need n, W >= 1, got {n}, {W}")
    return min(MAX_PARTS, -(-max(n, W) // SPAN)), (W - 1).bit_length()


def _lib() -> ctypes.CDLL:
    return _build.load("endpoint_fold", _SIGNATURES)


def endpoint_fold_cuda(pos: torch.Tensor, weights: torch.Tensor,
                       n: int) -> torch.Tensor:
    """The live endpoint fold on the card: ``out[b, t] = sum_i w[b,i] *
    [pos[b,i] == t]``. pos (B, W) int32 and weights (B, W) float32,
    contiguous on one CUDA device, the weights finite and nonnegative;
    returns (B, n) float32, the bits of ``ref.endpoint_fold_fixed_ref``.
    Values are not checked: a lane whose pos lies outside [0, n) is dropped
    on the card, where the plain version raises; the walks only reach nodes
    of the graph."""
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
    parts, log_w = fold_scratch(n, W)
    lib = _lib()
    sums = torch.empty((B, n), dtype=torch.int64, device=dev)
    maxima = torch.empty((B, parts), dtype=torch.int32, device=dev)
    shift = torch.empty((B,), dtype=torch.int32, device=dev)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    with _build.on_card(dev) as stream:
        err = lib.endpoint_fold_launch(
            pos.data_ptr(), weights.data_ptr(), sums.data_ptr(),
            maxima.data_ptr(), shift.data_ptr(), out.data_ptr(), n, W, B,
            parts, log_w, stream)
    if err != 0:
        msg = lib.endpoint_fold_error_string(err).decode()
        raise RuntimeError(f"endpoint_fold launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["endpoint_fold"] += 1
    return out
