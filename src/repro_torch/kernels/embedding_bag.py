"""CUDA wrapper for DIN's weighted history pooling.

``embedding_bag_cuda`` (K5) replaces
``repro/kernels/embedding_bag.py::embedding_bag_pallas`` (line 40, body
``_bag_kernel``) and launches ``csrc/embedding_bag.cu``. The JAX DIN pools
with ``jnp.einsum`` over gathered rows and names the Pallas kernel as the
same op for the TPU (``repro/models/recsys/din.py``); the port's DIN calls
this kernel there, in ``score`` and ``score_candidates``.

What bounds it on the H100: latency. A call at DIN's shapes moves a few
MB, but every row is a random read that costs a whole memory latency, so
a bag whose items are read one after another costs L latencies. Neither
route chains reads over a bag's items (see the source's header):

* route G (``"gather"``, ids with a row stride other than 0, a history a
  bag): the items of a bag are spread over the lanes of up to 8 warps,
  each lane loads its item's whole row at once, and the lanes' scaled rows
  are folded in a fixed tree;
* route S (``"shared"``, ids with row stride 0, one history for every bag:
  retrieval): each block stages the history's rows in shared memory once,
  then each group of 8 lanes sums a bag over them, its lanes over
  consecutive items.

:func:`route` picks the route from the ids' row stride alone, and
:func:`plan` the launch geometry from the shapes and the card's SM count,
both plain Python that the CPU tests cover (:func:`items_of` and
:func:`columns_of` say which (bag, item) a thread multiplies in and which
(bag, column) it writes, as the kernels compute them).

The wrapper checks device, dtype, shape and strides, allocates the output
with ``torch.empty``, launches on PyTorch's current stream, raises on a
non-zero ``cudaGetLastError()``, and counts its launches in
:data:`LAUNCHES`: every call under ``embedding_bag`` and each under
``embedding_bag_gather`` or ``embedding_bag_shared``. ``ids`` and
``weights`` may have any row stride, including 0 (one history broadcast
over a block of candidates): nothing is copied, the table least of all.

``embedding_bag_grad_cuda`` is K5's backward, ``csrc/embedding_bag_grad.cu``
(DIN's training): the weights' gradient ``dw[b,l] = <T[ids[b,l]], g[b]>``
(``bag_grad_weights``, a group of lanes an item) and the table's dense
gradient ``dT[v] = sum_{ids[b,l]=v} w[b,l] g[b]`` (``bag_grad_table``, the
segment reduction's fold over the plan of the ids, each term formed as it
is loaded). It replaces no TPU kernel (the reference differentiates DIN's
``jnp.take`` and ``einsum`` with XLA); bytes bound it, the table's dense
gradient most (see the source's header). No atomics: the same bits on
every call. Its launches count in :data:`LAUNCHES` too, under
``embedding_bag_grad_weights`` and ``embedding_bag_grad_table``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from . import _build
from .segment_reduce import (aligned, check_int32, check_rows, geometry,
                             scratch_buffers)

# launches since the last reset_launches(): K5's, and its backward's
LAUNCHES: dict[str, int] = {"embedding_bag": 0, "embedding_bag_gather": 0,
                            "embedding_bag_shared": 0,
                            "embedding_bag_grad_weights": 0,
                            "embedding_bag_grad_table": 0}

THREADS = 256                  # a block's threads at most (route S: always)
COLUMNS = 32                   # columns a pass, both routes
SHARED_ITEMS = 256             # route S: history items staged a pass
SHARED_GROUP = 8               # route S: lanes a bag
_ROUTE_CODE = {"gather": 0, "shared": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "embedding_bag_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _L, _L, _I, _I,
                              _I, _I, _I, _P], _I),
    "embedding_bag_error_string": ([_I], ctypes.c_char_p),
}
_GRAD_SIGNATURES = {
    "bag_grad_weights_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I,
                                 _P], _I),
    "bag_grad_table_launch": ([_P] * 10 + [_L] + [_I] * 8 + [_P], _I),
    "embedding_bag_grad_error_string": ([_I], ctypes.c_char_p),
}
_INT32_MAX = 2**31 - 1
GRAD_UNITS_A_LANE = 4          # bag_grad_weights: units a lane, at most


@dataclass(frozen=True)
class BagPlan:
    """A launch's geometry: ``blocks`` blocks of ``threads`` threads, each
    block owning ``bags_per_block`` consecutive bags. On route G a bag
    takes ``bag_warps`` warps; on route S a group of 8 lanes takes a
    bag."""
    route: str
    blocks: int
    threads: int
    bag_warps: int
    bags_per_block: int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("embedding_bag", _SIGNATURES)


def _grad_lib() -> ctypes.CDLL:
    return _build.load("embedding_bag_grad", _GRAD_SIGNATURES)


def route(ids_row_stride: int) -> str:
    """``"shared"`` (route S) for ids whose rows are one history (row
    stride 0), else ``"gather"`` (route G)."""
    return "shared" if ids_row_stride == 0 else "gather"


def plan(B: int, L: int, ids_row_stride: int, sm_count: int) -> BagPlan:
    """The geometry of a call over B bags of L items on a card with
    ``sm_count`` SMs. Route S gives a block 256 threads, 32 groups of 8
    lanes, a bag each. Route G gives a bag ``ceil(L / 32)`` warps (at most
    8) and a block as many bags as fit in 256 threads, then halves the bags
    a block while that leaves fewer than 2 blocks an SM."""
    if route(ids_row_stride) == "shared":
        per_block = THREADS // SHARED_GROUP
        return BagPlan("shared", -(-B // per_block), THREADS, 1, per_block)
    bag_warps = min(THREADS // 32, -(-L // 32))
    per_block = THREADS // 32 // bag_warps
    while per_block > 1 and -(-B // per_block) < 2 * sm_count:
        per_block //= 2
    return BagPlan("gather", -(-B // per_block), per_block * bag_warps * 32,
                   bag_warps, per_block)


def items_of(p: BagPlan, block: int, thread: int, B: int,
             L: int) -> list[tuple[int, int]]:
    """The (bag, item) pairs that thread ``thread`` of block ``block``
    scales and adds in, in its order, as the kernel of ``p.route`` takes
    them."""
    if p.route == "gather":
        bag_threads = p.bag_warps * 32
        b = block * p.bags_per_block + thread // bag_threads
        if b >= B:
            return []
        return [(b, l) for l in range(thread % bag_threads, L, bag_threads)]
    b = block * p.bags_per_block + thread // SHARED_GROUP
    if b >= B:
        return []
    return [(b, l) for l0 in range(0, L, SHARED_ITEMS)
            for l in range(l0 + thread % SHARED_GROUP,
                           min(l0 + SHARED_ITEMS, L), SHARED_GROUP)]


def columns_of(p: BagPlan, block: int, thread: int, B: int,
               d: int) -> list[tuple[int, int]]:
    """The (bag, column) outputs that thread ``thread`` of block ``block``
    writes. Route G: lane c of a bag's first warp, column c0 + c of each
    32-column pass c0. Route S: a pass's dc columns padded to C, a multiple
    of 8; lane g of a group, columns c0 + g * C / 8 + j for j < C / 8."""
    warp, lane = divmod(thread, 32)
    if p.route == "gather":
        if warp % p.bag_warps:
            return []
        b = block * p.bags_per_block + warp // p.bag_warps
        return [(b, c0 + lane) for c0 in range(0, d, COLUMNS)
                if b < B and c0 + lane < d]
    b = block * p.bags_per_block + thread // SHARED_GROUP
    g = thread % SHARED_GROUP
    out = []
    for c0 in range(0, d, COLUMNS):
        dc = min(COLUMNS, d - c0)
        per = -(-dc // SHARED_GROUP)
        out += [(b, c0 + g * per + j) for j in range(per)
                if b < B and g * per + j < dc]
    return out


def unit_width(table: torch.Tensor) -> int:
    """Floats a route-G row load moves: 2 where d is even and the table
    8-byte aligned, else 1."""
    return 2 if table.shape[1] % 2 == 0 and table.data_ptr() % 8 == 0 else 1


def embedding_bag_cuda(table: torch.Tensor, ids: torch.Tensor,
                       weights: torch.Tensor) -> torch.Tensor:
    """K5: ``out[b] = sum_l weights[b,l] * table[ids[b,l]]`` on the card.

    table (V, d) float32 contiguous, ids (B, L) int32 and weights (B, L)
    float32 with contiguous rows (any row stride, 0 included), all on one
    CUDA device. Returns (B, d) float32. Ids are read as the JAX
    package's ``embedding_bag_ref`` reads them, on the card as in the plain
    version: an id in [-V, 0) is row id + V, and a bag holding an id
    outside [-V, V) comes out NaN in every column. They are not checked on
    the host, which would cost a synchronisation a call. The route follows
    :func:`route`, the geometry :func:`plan` with the card's SM count."""
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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    p = plan(B, L, ids.stride(0), sms)
    if p.blocks > _INT32_MAX:
        raise ValueError(f"shapes out of range: {p.blocks} blocks")
    out = torch.empty((B, d), dtype=torch.float32, device=dev)
    lib = _lib()
    with _build.on_card(dev) as stream:
        err = lib.embedding_bag_launch(
            table.data_ptr(), ids.data_ptr(), weights.data_ptr(),
            out.data_ptr(), B, L, V, d, ids.stride(0), weights.stride(0),
            _ROUTE_CODE[p.route], unit_width(table), p.blocks, p.bag_warps,
            p.bags_per_block, stream)
    if err != 0:
        msg = lib.embedding_bag_error_string(err).decode()
        raise RuntimeError(f"embedding_bag launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["embedding_bag"] += 1
    LAUNCHES[f"embedding_bag_{p.route}"] += 1
    return out


def grad_group(d: int, width: int) -> int:
    """Lanes ``bag_grad_weights`` gives an item: the least power of two
    (up to 32) whose lanes hold the row's d / width units at most
    :data:`GRAD_UNITS_A_LANE` a lane (4 at DIN's d = 18 in float2 units)."""
    units = d // width
    group = 1
    while group < 32 and group * GRAD_UNITS_A_LANE < units:
        group *= 2
    if group * GRAD_UNITS_A_LANE < units:
        raise ValueError(f"rows of {d} floats are too wide for "
                         f"bag_grad_weights (at most "
                         f"{32 * GRAD_UNITS_A_LANE * width})")
    return group


def embedding_bag_grad_cuda(table: torch.Tensor, ids: torch.Tensor,
                            weights: torch.Tensor, g: torch.Tensor,
                            order: torch.Tensor | None = None,
                            keys: torch.Tensor | None = None,
                            offsets: torch.Tensor | None = None, *,
                            table_grad: bool = True,
                            weights_grad: bool = True
                            ) -> tuple[torch.Tensor | None,
                                       torch.Tensor | None]:
    """K5's backward on the card: (dT (V, d), dw (B, L)) float32, each None
    where not asked for, given the output's gradient g (B, d).

    ``dw[b,l] = <table[ids[b,l]], g[b]>`` (ids read as the forward reads
    them; a bag's id outside [-V, V) gives NaN); ``dT[v] = sum over
    ids[b,l] = v of weights[b,l] * g[b]``, dense, 0 on the rows no id
    names, over the plan of the flat ids (order, keys (B * L,) and offsets
    (V + 1,) int32: ``ops.bag_plan(ids, V)``'s tensors, which the table's
    gradient needs). table (V, d) float32 contiguous, ids (B, L) int32 with
    contiguous rows, weights (B, L) and g (B, d) float32 contiguous, all on
    one CUDA device. The plan's values are not checked: an order entry
    outside [0, B * L) reads outside ``weights``."""
    dev = table.device
    if dev.type != "cuda":
        raise ValueError(f"table must be a CUDA tensor, got {dev}")
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(f"need table (V, d) and ids (B, L); got "
                         f"{tuple(table.shape)}, {tuple(ids.shape)}")
    V, d = table.shape
    B, L = ids.shape
    E = B * L
    if not (1 <= V <= _INT32_MAX and 1 <= d <= _INT32_MAX and 1 <= B
            and 1 <= L and E <= _INT32_MAX):
        raise ValueError(f"shapes out of range: table {(V, d)}, bags "
                         f"{(B, L)} (the plan is int32, so B * L < 2^31)")
    check_rows("table", table, dev, (V, d))
    check_rows("weights", weights, dev, (B, L))
    check_rows("g", g, dev, (B, d))
    if ids.device != dev or ids.dtype != torch.int32 or \
            (ids.stride(1) != 1 and L > 1):
        raise ValueError(f"ids must be int32 on {dev} with contiguous rows, "
                         f"got {ids.dtype} on {ids.device}, strides "
                         f"{ids.stride()}")
    d_table = d_w = None
    lib = _grad_lib() if table_grad or weights_grad else None
    if weights_grad:
        width = 2 if d % 2 == 0 and table.data_ptr() % 8 == 0 and \
            g.data_ptr() % 8 == 0 else 1
        d_w = torch.empty((B, L), dtype=torch.float32, device=dev)
        with _build.on_card(dev) as stream:
            err = lib.bag_grad_weights_launch(
                table.data_ptr(), ids.data_ptr(), g.data_ptr(),
                d_w.data_ptr(), B, L, V, d, ids.stride(0), width,
                grad_group(d, width), stream)
        _raise_on(lib, err, "bag_grad_weights")
        LAUNCHES["embedding_bag_grad_weights"] += 1
    if table_grad:
        check_int32("order", order, dev, (E,))
        check_int32("keys", keys, dev, (E,))
        check_int32("offsets", offsets, dev, (V + 1,))
        vec, group, per, R1, RL, _, _ = geometry(E, d)
        g_rows, order, keys = aligned(g), aligned(order), aligned(keys)
        d_table = torch.empty((V, d), dtype=torch.float32, device=dev)
        scratch, slots = scratch_buffers(E, d, dev)
        with _build.on_card(dev) as stream:
            err = lib.bag_grad_table_launch(
                g_rows.data_ptr(), weights.data_ptr(), order.data_ptr(),
                keys.data_ptr(), offsets.data_ptr(), *slots,
                d_table.data_ptr(), E, V, d, L, vec, per, group, R1, RL,
                stream)
        del scratch
        _raise_on(lib, err, "bag_grad_table")
        LAUNCHES["embedding_bag_grad_table"] += 1
    return d_table, d_w


def _raise_on(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    if err != 0:
        msg = lib.embedding_bag_grad_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} "
                           f"({msg})")
