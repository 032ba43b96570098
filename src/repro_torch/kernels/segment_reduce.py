"""CUDA wrappers for the GNNs' segment reduction and its backward.

``segment_reduce_cuda`` launches ``csrc/segment_reduce.cu``. It computes
what the JAX package leaves to XLA's ``jax.ops.segment_sum``,
``segment_max`` and ``segment_min`` (``repro/models/gnn/common.py:44-61``,
the GNNs' message aggregation): no Pallas kernel, so no TPU kernel is
replaced. A plain PyTorch version on the card would be ``index_add_`` or
``scatter_reduce``, which sum with float atomics in an order that changes
from run to run; this kernel gives every output cell one summation order,
fixed by the segment plan (``ops.SegmentPlan``), so a second launch gives
the same bits.

What bounds it on the H100: bytes. A call reads each of the E rows of d
floats once (gathered through the plan's order), the order and offsets,
and writes the (S, d) output once. The design (see the source's header):

* a group of lanes a segment (a warp over the columns, or 32 / group
  segments a warp where d is narrow), 128-bit loads where d is a multiple
  of 4 and the rows are 16-byte aligned, a grid-stride loop over the
  segments, each segment's rows folded left to right in edge order;
* a segment longer than :data:`PIECE` edges (the models' trash segment of
  masked edges, a single graph's node sum) is cut by the plan into pieces
  of :data:`PIECE` edges, each folded by its own lane group into a partials
  scratch first (a second kernel, launched only when the plan has pieces),
  and the pieces' partials are then folded in piece order;
* no float atomics: a second launch gives the same bits, and max and min
  are exact.

The wrapper checks device, dtype, shape and contiguity, allocates the
output and scratch with ``torch.empty``, launches on PyTorch's current
stream, raises on a non-zero ``cudaGetLastError()``, and counts its calls
in :data:`LAUNCHES` (one a call, although a call with pieces runs two CUDA
kernels).

``segment_reduce_grad_cuda`` launches ``csrc/segment_grad.cu``, the
gradient of the reduction with respect to its values, over the forward's
plan: a sum's gradient is the output gradient's row written to each edge
of the segment, a max's or min's is split equally among the edges tied
at the output, column by column, as ``jax.grad`` of
``jax.ops.segment_max/min`` splits it, and an edge in no segment gets 0.
It replaces no TPU kernel either: the reference differentiates XLA's
segment ops, and has no Pallas backward. Every gradient row is written by
one lane group, tie counts are integers, so a second launch gives the
same bits; it is bound by bytes (the E gradient rows written once, and
for max and min the E value rows read). One call counts once under
``segment_reduce_grad``, although a plan with pieces runs two or three
CUDA kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"segment_reduce": 0, "segment_reduce_grad": 0}

PIECE = 128              # edges a piece of a long segment (the plan's cut)
OPS = {"sum": 0, "max": 1, "min": 2}
_INT32_MAX = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "segment_reduce_launch": ([_P] * 7 + [_I] * 6 + [_P], _I),
    "segment_reduce_error_string": ([_I], ctypes.c_char_p),
}
_GRAD_SIGNATURES = {
    "segment_reduce_grad_launch": ([_P] * 9 + [ctypes.c_int64] + [_I] * 6
                                   + [_P], _I),
    "segment_reduce_grad_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def unit_width(*rows: torch.Tensor) -> int:
    """Floats an access of the kernels: 4 where d (every tensor's row
    length, the same) is a multiple of 4 and all the tensors are 16-byte
    aligned, else 2 where d is even and they are 8-byte aligned, else 1."""
    d = rows[0].shape[1]
    for vec in (4, 2):
        if d % vec == 0 and all(t.data_ptr() % (4 * vec) == 0
                                for t in rows):
            return vec
    return 1


def _lib() -> ctypes.CDLL:
    return _build.load("segment_reduce", _SIGNATURES)


def _grad_lib() -> ctypes.CDLL:
    return _build.load("segment_grad", _GRAD_SIGNATURES)


def _check_int32(name: str, t: torch.Tensor, dev: torch.device,
                 shape: tuple[int, ...]) -> None:
    if t.device != dev or t.dtype != torch.int32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape} int32 on {dev},"
                         f" got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous: {t.is_contiguous()})")


def segment_reduce_cuda(values: torch.Tensor, order: torch.Tensor,
                        offsets: torch.Tensor, piece_offsets: torch.Tensor,
                        piece_bounds: torch.Tensor, op: str) -> torch.Tensor:
    """The segment reduction on the card: ``out[s] = op over e in
    order[offsets[s]:offsets[s+1]] of values[e]``, in that order. values
    (E, d) float32, order (E,), offsets and piece_offsets (S + 1,) and
    piece_bounds (2, P) int32, all contiguous on one CUDA device (a
    :class:`~repro_torch.kernels.ops.SegmentPlan`'s tensors). Returns (S, d)
    float32; an empty segment gives 0 (sum), -inf (max) or +inf (min).
    The plan's values are not checked: an order entry outside [0, E) reads
    outside ``values``."""
    dev = values.device
    if dev.type != "cuda":
        raise ValueError(f"values must be a CUDA tensor, got {dev}")
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if values.dim() != 2 or values.dtype != torch.float32 or \
            not values.is_contiguous():
        raise ValueError(f"values must be contiguous (E, d) float32, got "
                         f"{values.dtype} {tuple(values.shape)} (contiguous:"
                         f" {values.is_contiguous()})")
    E, d = values.shape
    S = offsets.shape[0] - 1 if offsets.dim() == 1 else -1
    P = piece_bounds.shape[1] if piece_bounds.dim() == 2 else -1
    if S < 1 or P < 0 or d < 1 or E * d > 2**62 or \
            max(E, S, P, d) > _INT32_MAX:
        raise ValueError(f"shapes out of range: values {(E, d)}, offsets "
                         f"{tuple(offsets.shape)}, piece_bounds "
                         f"{tuple(piece_bounds.shape)} (need S >= 1, d >= 1,"
                         f" each below 2^31)")
    _check_int32("order", order, dev, (E,))
    _check_int32("offsets", offsets, dev, (S + 1,))
    _check_int32("piece_offsets", piece_offsets, dev, (S + 1,))
    _check_int32("piece_bounds", piece_bounds, dev, (2, P))
    lib = _lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty((S, d), dtype=torch.float32, device=dev)
    partials = torch.empty((P, d), dtype=torch.float32, device=dev)
    with _build.on_card(dev) as stream:
        err = lib.segment_reduce_launch(
            values.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            piece_offsets.data_ptr(), piece_bounds.data_ptr(),
            partials.data_ptr(), out.data_ptr(), S, P, d, OPS[op],
            unit_width(values), sms, stream)
    if err != 0:
        msg = lib.segment_reduce_error_string(err).decode()
        raise RuntimeError(f"segment_reduce launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["segment_reduce"] += 1
    return out


def _check_rows(name: str, t: torch.Tensor, dev: torch.device,
                shape: tuple[int, ...]) -> None:
    if t.device != dev or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape} float32 on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous: {t.is_contiguous()})")


def segment_reduce_grad_cuda(g_out: torch.Tensor, values: torch.Tensor | None,
                             out: torch.Tensor | None, order: torch.Tensor,
                             offsets: torch.Tensor,
                             piece_offsets: torch.Tensor,
                             piece_bounds: torch.Tensor,
                             op: str) -> torch.Tensor:
    """The backward of :func:`segment_reduce_cuda` on the card: the (E, d)
    float32 gradient of its values, given g_out (S, d), over the forward's
    plan (order (E,), offsets and piece_offsets (S + 1,), piece_bounds
    (2, P) int32). ``sum``: ``grad[e] = g_out[s]``; ``max``/``min``:
    ``g_out[s] * (1 / ties)`` on the edges equal to the forward's output
    ``out`` (S, d), column by column, with ``values`` (E, d) the forward's
    input (both ignored for a sum); an edge in no segment gets 0 (see
    ``ref.segment_reduce_grad_ref``). All contiguous on one CUDA device."""
    dev = g_out.device
    if dev.type != "cuda":
        raise ValueError(f"g_out must be a CUDA tensor, got {dev}")
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if g_out.dim() != 2:
        raise ValueError(f"g_out must be (S, d), got {tuple(g_out.shape)}")
    S, d = g_out.shape
    E = order.shape[0] if order.dim() == 1 else -1
    P = piece_bounds.shape[1] if piece_bounds.dim() == 2 else -1
    if S < 1 or E < 0 or P < 0 or d < 1 or E * d > 2**62 or \
            max(S, P, d) > _INT32_MAX or E > _INT32_MAX:
        raise ValueError(f"shapes out of range: g_out {(S, d)}, order "
                         f"{tuple(order.shape)}, piece_bounds "
                         f"{tuple(piece_bounds.shape)} (need S >= 1, d >= 1,"
                         f" each below 2^31)")
    _check_rows("g_out", g_out, dev, (S, d))
    _check_int32("order", order, dev, (E,))
    _check_int32("offsets", offsets, dev, (S + 1,))
    _check_int32("piece_offsets", piece_offsets, dev, (S + 1,))
    _check_int32("piece_bounds", piece_bounds, dev, (2, P))
    grad = torch.empty((E, d), dtype=torch.float32, device=dev)
    rows = [g_out, grad]
    if op == "sum":
        values = out = ties = None
    else:
        if values is None or out is None:
            raise ValueError(f"{op}'s backward needs the forward's values "
                             f"and output")
        _check_rows("values", values, dev, (E, d))
        _check_rows("out", out, dev, (S, d))
        rows += [values, out]
        ties = torch.empty((P, d), dtype=torch.int32, device=dev)
    lib = _grad_lib()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    with _build.on_card(dev) as stream:
        err = lib.segment_reduce_grad_launch(
            g_out.data_ptr(), ptr(values), ptr(out), order.data_ptr(),
            offsets.data_ptr(), piece_offsets.data_ptr(),
            piece_bounds.data_ptr(), ptr(ties), grad.data_ptr(), E, S, P, d,
            OPS[op], unit_width(*rows), sms, stream)
    if err != 0:
        msg = lib.segment_reduce_grad_error_string(err).decode()
        raise RuntimeError(f"segment_reduce_grad launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["segment_reduce_grad"] += 1
    return grad
