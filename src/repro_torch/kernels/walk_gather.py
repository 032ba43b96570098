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

* each lane is one gather, and the fold is a sort: a block sorts a tile of
  lanes by (endpoint, lane) in shared memory, sums each run of equal
  endpoints as a pairwise tree in lane order, and the run's head writes
  its cell;
* no float atomics: every output cell has one summation order, so a second
  launch gives the same bits, and a hub cell that collects thousands of
  lanes rounds log2(tile) times instead of once per lane;
* rows with more lanes than one tile write one scratch row per tile, added
  in tile order by a second pass.

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
# runs a memset and one or two CUDA kernels
LAUNCHES: dict[str, int] = {"walk_endpoint_gather": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "walk_gather_launch": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "walk_gather_tile_lanes": ([], _I),
    "walk_gather_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = 2**31 - 1
_MAX_ROWS = 65535          # the grid's y dimension carries the row


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
    tiles = -(-L // lib.walk_gather_tile_lanes())
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    scratch = None if tiles == 1 else torch.empty(
        (B, tiles, n), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    err = lib.walk_gather_launch(
        endpoints.data_ptr(), budget.data_ptr(), starts.data_ptr(),
        weights.data_ptr(), None if scratch is None else scratch.data_ptr(),
        out.data_ptr(), n, W, B, L, stream)
    if err != 0:
        msg = lib.walk_gather_error_string(err).decode()
        raise RuntimeError(f"walk_endpoint_gather launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["walk_endpoint_gather"] += 1
    return out
