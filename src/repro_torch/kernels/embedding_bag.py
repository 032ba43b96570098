"""CUDA wrapper for DIN's weighted history pooling.

``embedding_bag_cuda`` (K5) replaces
``repro/kernels/embedding_bag.py::embedding_bag_pallas`` (line 40, body
``_bag_kernel``) and launches ``csrc/embedding_bag.cu``. The JAX DIN pools
with ``jnp.einsum`` over gathered rows and names the Pallas kernel as the
same op for the TPU (``repro/models/recsys/din.py``); the port's DIN calls
this kernel there, in ``score`` and ``score_candidates``.

What bounds it on the H100: bytes. Each (bag, item) reads its id, its
weight and one random table row (three 32-byte sectors at d = 18); the
(B, d) output is written once. The Pallas kernel holds the whole table in
VMEM; DIN's 720 MB item table fits in no on-chip memory, so each row is
read where it lies, one warp per bag summing its items in order (see the
source's header).

The wrapper checks device, dtype, shape and strides, allocates the output
with ``torch.empty``, launches on PyTorch's current stream, raises on a
non-zero ``cudaGetLastError()``, and counts its launches in
:data:`LAUNCHES`. ``ids`` and ``weights`` may have any row stride,
including 0 (one history broadcast over a block of candidates): nothing is
copied, the table least of all.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"embedding_bag": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "embedding_bag_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _P],
                             _I),
    "embedding_bag_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = 2**31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("embedding_bag", _SIGNATURES)


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """K5: ``out[b] = sum_l weights[b,l] * table[ids[b,l]]`` on the card.

    table (V, d) float32 contiguous, ids (B, L) int32 and weights (B, L)
    float32 with contiguous rows (any row stride, 0 included), all on one
    CUDA device. Returns (B, d) float32. Ids are read as the JAX
    package's ``embedding_bag_ref`` reads them, on the card as in the plain
    version: an id in [-V, 0) is row id + V, and a bag holding an id
    outside [-V, V) comes out NaN in every column. They are not checked on
    the host, which would cost a synchronisation a call."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"table must be a CUDA tensor, got {dev}")
    if table.dim() != 2 or ids.dim() != 2 or weights.dim() != 2:
        raise ValueError(f"need table (V, d), ids and weights (B, L); got "
                         f"{tuple(table.shape)}, {tuple(ids.shape)}, "
                         f"{tuple(weights.shape)}")
    V, d = table.shape
    B, L = ids.shape
    if tuple(weights.shape) != (B, L):
        raise ValueError(f"weights must be {(B, L)}, got "
                         f"{tuple(weights.shape)}")
    if not (1 <= V <= _INT32_MAX and 1 <= d <= _INT32_MAX
            and 1 <= B <= _INT32_MAX and 1 <= L <= _INT32_MAX):
        raise ValueError(f"shapes out of range: table {(V, d)}, bags "
                         f"{(B, L)} (ids are int32, so V < 2^31)")
    for t, name, dtype in ((table, "table", torch.float32),
                           (ids, "ids", torch.int32),
                           (weights, "weights", torch.float32)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if not table.is_contiguous():
        raise ValueError("table must be contiguous")
    for t, name in ((ids, "ids"), (weights, "weights")):
        if t.stride(1) != 1 and L > 1:
            raise ValueError(f"{name}'s rows must be contiguous, strides "
                             f"{t.stride()}")
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    lib = _lib()
    stream = torch.cuda.current_stream(dev.index).cuda_stream
    err = lib.embedding_bag_launch(
        table.data_ptr(), ids.data_ptr(), weights.data_ptr(), out.data_ptr(),
        B, L, V, d, ids.stride(0), weights.stride(0), stream)
    if err != 0:
        msg = lib.embedding_bag_error_string(err).decode()
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["embedding_bag"] += 1
    return out
