"""CUDA wrappers for the GNNs' segment reduction and its backward.

``segment_reduce_cuda`` launches ``csrc/segment_reduce.cu``. It computes
what the JAX package leaves to XLA's ``jax.ops.segment_sum``,
``segment_max`` and ``segment_min`` (``repro/models/gnn/common.py:44-61``,
the GNNs' message aggregation): no Pallas kernel, so no TPU kernel is
replaced. A plain PyTorch version on the card would be ``index_add_`` or
``scatter_reduce``, which sum with float atomics in an order that changes
from run to run; this kernel gives every output cell one summation order,
fixed by the segment plan (``ops.SegmentPlan``) and the run lengths of
:func:`run_lengths` (which depend on E and d alone), so a second launch
gives the same bits.

What bounds it on the H100: bytes. A call reads each row inside a segment
once, the plan's keys (and order, on the gathered route) and offsets, and
writes the (S, d) output once. The design (see ``csrc/segment_units.cuh``):

* the work is cut by positions, not by segments: runs of ``R1`` positions
  of the plan, one a group of lanes, each folded left to right; the parts
  of a segment that crosses runs are folded a block in shared memory, and
  a block's two open parts go to two slots of the next level, which folds
  them in runs of ``RL``, until one block holds every slot
  (:func:`levels`): a segment of any length, the models' trash segment of
  masked edges too, is folded in parallel by a fixed tree, never by one
  group of lanes;
* a lane holds only the column units its row needs (:func:`layout`) and
  keeps ``K`` rows in flight (:func:`batch`), within 64 to 128 registers
  by variant and without spills, so that the random rows of the gathered
  route have the warps to hide their latency;
* on the contiguous route (a plan without ``order``: the caller laid its
  rows out in plan order, as GCN does) the rows are read as one stream;
* 16-byte units where d is a multiple of 4 (:func:`unit_width`), else
  4-byte words that a warp reads 128 contiguous bytes at a time;
* no atomics: a second launch gives the same bits, and max and min are
  exact.

The wrapper checks device, dtype, shape, contiguity and alignment,
allocates the output and one scratch buffer with ``torch.empty``, launches
on PyTorch's current stream, raises on a non-zero ``cudaGetLastError()``,
and counts its calls in :data:`LAUNCHES` (one a call, although a call runs
one CUDA kernel a level).

``segment_reduce_grad_cuda`` launches ``csrc/segment_grad.cu``, the
gradient of the reduction with respect to its values, over the forward's
plan: a sum's gradient is the output gradient's row written to each edge
of the segment, a max's or min's is split equally among the edges tied
at the output, column by column, as ``jax.grad`` of
``jax.ops.segment_max/min`` splits it, and an edge in no segment gets 0.
It replaces no TPU kernel either: the reference differentiates XLA's
segment ops (``repro/models/gnn/common.py:44-61``), and has no Pallas
backward. Max and min count their ties with the forward's fold over runs
(integers), then one kernel writes every gradient word once, as whole
aligned 16-byte units of the flat gradient, rows in order: by the keys on
the contiguous route, by the plan's index (each edge's segment) on the
gathered route. It is bound by bytes (the E gradient rows written once,
and for max and min the E value rows read). One call counts once under
``segment_reduce_grad``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

# launches since the last reset_launches()
LAUNCHES: dict[str, int] = {"segment_reduce": 0, "segment_reduce_grad": 0}

OPS = {"sum": 0, "max": 1, "min": 2}
THREADS = 256              # a block (csrc/segment_units.cuh, kThreads)
FILL_BLOCKS = 1 << 14      # level 1's runs aim at this many blocks
R1_RANGE = (32, 256)       # level 1's run length, a power of two in this range
_INT32_MAX = 2**31 - 1

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "segment_reduce_launch": ([_P] * 9 + [_L] + [_I] * 8 + [_P], _I),
    "segment_reduce_error_string": ([_I], ctypes.c_char_p),
}
_GRAD_SIGNATURES = {
    "segment_reduce_grad_launch": ([_P] * 12 + [_L] + [_I] * 8 + [_P], _I),
    "segment_reduce_grad_error_string": ([_I], ctypes.c_char_p),
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def unit_width(d: int) -> int:
    """Words an access of the kernels: 4 where d is a multiple of 4, else
    1 (the wrappers hand the kernels 16-byte aligned tensors only)."""
    return 4 if d % 4 == 0 else 1


def layout(d: int, vec: int) -> tuple[int, int]:
    """(group, per): lanes a run and column units a lane. A row of d / vec
    units takes a power of two of lanes, one unit each, up to 32 units;
    a warp with 2 units a lane up to 64; a warp with 4 units a lane beyond,
    in chunks of 128 units."""
    units = d // vec
    if units <= 32:
        group = 1
        while group < units:
            group *= 2
        return group, 1
    return 32, 2 if units <= 64 else 4


def batch(per: int, vec: int) -> int:
    """K: positions whose rows a lane loads together (K * per * vec <= 16
    words, 1 to 8; ``segment::batch`` in the source). It sets no summation
    order."""
    return min(8, max(1, 16 // (per * vec)))


def run_lengths(E: int, d: int, vec: int) -> tuple[int, int]:
    """(R1, RL): the positions a group of lanes folds at level 1 and at
    every later level. R1 is the power of two in :data:`R1_RANGE` nearest
    below E over :data:`FILL_BLOCKS` blocks: short runs where E is small
    (the sampled batches, 32), long ones where it is large (GCN on
    ogb_products, 32 at d 16 and 256 at d 47, where a warp holds one
    row); RL is 2 batches, at least 8. Both depend on E and d alone, so
    the summation order does not depend on the card."""
    group, per = layout(d, vec)
    want = E // (FILL_BLOCKS * (THREADS // group))
    R1 = R1_RANGE[0]
    while R1 * 2 <= min(want, R1_RANGE[1]):
        R1 *= 2
    return R1, max(2 * batch(per, vec), 8)


def levels(E: int, d: int) -> list[tuple[int, int]]:
    """(positions, run length) of each level of one reduction of E rows of
    d words: E positions in runs of R1, then two slots a block of the level
    before in runs of RL, until one block holds every run."""
    vec = unit_width(d)
    group, _ = layout(d, vec)
    G = THREADS // group
    R, RL = run_lengths(E, d, vec)
    out = [(E, R)]
    while True:
        n, R = out[-1]
        blocks = -(-(-(-n // R)) // G)
        if blocks <= 1:
            return out
        out.append((2 * blocks, RL))


@functools.lru_cache(maxsize=256)
def geometry(E: int, d: int) -> tuple[int, int, int, int, int, int, int]:
    """(vec, group, per, R1, RL, s0, s1) of a reduction of E rows of d
    words, s0 and s1 the slots of the two scratch buffers (level i, from
    0, writes buffer i % 2, 2 slots a block, except the last level); s0 is
    rounded up to a multiple of 4 so that the second buffer starts 16-byte
    aligned in the one allocation that holds both."""
    vec = unit_width(d)
    group, per = layout(d, vec)
    R1, RL = run_lengths(E, d, vec)
    sizes = [0, 0]
    for i, (n, _) in enumerate(levels(E, d)[1:]):
        sizes[i % 2] = max(sizes[i % 2], n)
    return vec, group, per, R1, RL, -(-sizes[0] // 4) * 4, sizes[1]


def scratch_buffers(E: int, d: int,
                    dev: torch.device) -> tuple[torch.Tensor, list]:
    """One int32 allocation for both scratch buffers' rows and keys (the
    rows' words are float32 or int32, as the kernel reads them), and the
    four pointers into it (None for an empty buffer)."""
    *_, s0, s1 = geometry(E, d)
    words = -(-(s0 + s1) * d // 4) * 4         # the keys start 16-byte aligned
    buf = torch.empty((words + s0 + s1,), dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    rows1 = base + 4 * s0 * d
    keys0 = base + 4 * words
    keys1 = keys0 + 4 * s0
    return buf, [base if s0 else None, rows1 if s1 else None,
                 keys0 if s0 else None, keys1 if s1 else None]


def _lib() -> ctypes.CDLL:
    return _build.load("segment_reduce", _SIGNATURES)


def _grad_lib() -> ctypes.CDLL:
    return _build.load("segment_grad", _GRAD_SIGNATURES)


def check_int32(name: str, t: torch.Tensor, dev: torch.device,
                shape: tuple[int, ...]) -> None:
    if t.device != dev or t.dtype != torch.int32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape} int32 on {dev},"
                         f" got {t.dtype} {tuple(t.shape)} on {t.device} "
                         f"(contiguous: {t.is_contiguous()})")


def check_rows(name: str, t: torch.Tensor, dev: torch.device,
               shape: tuple[int, ...]) -> None:
    if t.device != dev or t.dtype != torch.float32 or \
            tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {shape} float32 on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device} (contiguous: {t.is_contiguous()})")


def aligned(t: torch.Tensor | None) -> torch.Tensor | None:
    """t itself where it is 16-byte aligned (the kernels' 16-byte loads of
    keys, order and rows), else an aligned copy."""
    if t is None or t.numel() == 0 or t.data_ptr() % 16 == 0:
        return t
    return t.clone()


def _check_plan(order: torch.Tensor | None, keys: torch.Tensor,
                offsets: torch.Tensor, dev: torch.device, E: int) -> int:
    S = offsets.shape[0] - 1 if offsets.dim() == 1 else -1
    if S < 1 or E > _INT32_MAX or S > _INT32_MAX:
        raise ValueError(f"shapes out of range: E {E}, offsets "
                         f"{tuple(offsets.shape)} (need S >= 1, each below "
                         f"2^31)")
    if order is not None:
        check_int32("order", order, dev, (E,))
    check_int32("keys", keys, dev, (E,))
    check_int32("offsets", offsets, dev, (S + 1,))
    return S


def segment_reduce_cuda(values: torch.Tensor, order: torch.Tensor | None,
                        keys: torch.Tensor, offsets: torch.Tensor,
                        op: str) -> torch.Tensor:
    """The segment reduction on the card: ``out[s] = op over the positions
    p in offsets[s]:offsets[s+1] of values[order[p]]`` (``values[p]`` where
    order is None: the rows are in plan order). values (E, d) float32,
    order (E,) or None, keys (E,) (the sorted index clamped to [-1, S]) and
    offsets (S + 1,) int32, all contiguous on one CUDA device (a
    :class:`~repro_torch.kernels.ops.SegmentPlan`'s tensors). Returns
    (S, d) float32; an empty segment gives 0 (sum), -inf (max) or +inf
    (min). The plan's values are not checked: an order entry outside
    [0, E) reads outside ``values``."""
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
    if d < 1 or E * d > 2**62 or d > _INT32_MAX:
        raise ValueError(f"values {(E, d)} out of range (need d >= 1)")
    S = _check_plan(order, keys, offsets, dev, E)
    values, order, keys = aligned(values), aligned(order), aligned(keys)
    lib = _lib()
    out = torch.empty((S, d), dtype=torch.float32, device=dev)
    vec, group, per, R1, RL, _, _ = geometry(E, d)
    scratch, slots = scratch_buffers(E, d, dev)
    with _build.on_card(dev) as stream:
        err = lib.segment_reduce_launch(
            values.data_ptr(), None if order is None else order.data_ptr(),
            keys.data_ptr(), offsets.data_ptr(), *slots, out.data_ptr(), E,
            S, d, OPS[op], vec, per, group, R1, RL, stream)
    del scratch
    if err != 0:
        msg = lib.segment_reduce_error_string(err).decode()
        raise RuntimeError(f"segment_reduce launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["segment_reduce"] += 1
    return out


def segment_reduce_grad_cuda(g_out: torch.Tensor, values: torch.Tensor | None,
                             out: torch.Tensor | None,
                             order: torch.Tensor | None, keys: torch.Tensor,
                             index: torch.Tensor | None,
                             offsets: torch.Tensor,
                             op: str) -> torch.Tensor:
    """The backward of :func:`segment_reduce_cuda` on the card: the (E, d)
    float32 gradient of its values, given g_out (S, d), over the forward's
    plan (order (E,) or None, keys (E,), offsets (S + 1,) int32, and on
    the gathered route the index (E,) int32, each edge's segment).
    ``sum``: ``grad[e] = g_out[s]``; ``max``/``min``: ``g_out[s] * (1 /
    ties)`` on the edges equal to the forward's output ``out`` (S, d),
    column by column, with ``values`` (E, d) the forward's input (both
    ignored for a sum); an edge in no segment gets 0 (see
    ``ref.segment_reduce_grad_ref``). All contiguous on one CUDA device."""
    dev = g_out.device
    if dev.type != "cuda":
        raise ValueError(f"g_out must be a CUDA tensor, got {dev}")
    if op not in OPS:
        raise ValueError(f"op must be one of {sorted(OPS)}, got {op!r}")
    if g_out.dim() != 2:
        raise ValueError(f"g_out must be (S, d), got {tuple(g_out.shape)}")
    S, d = g_out.shape
    E = keys.shape[0] if keys.dim() == 1 else -1
    if E < 0 or d < 1 or E * d > 2**62 or d > _INT32_MAX:
        raise ValueError(f"shapes out of range: g_out {(S, d)}, keys "
                         f"{tuple(keys.shape)} (need d >= 1)")
    if _check_plan(order, keys, offsets, dev, E) != S:
        raise ValueError(f"g_out has {S} rows, the plan "
                         f"{offsets.shape[0] - 1} segments")
    check_rows("g_out", g_out, dev, (S, d))
    if order is not None:
        if index is None:
            raise ValueError("the gathered route's backward needs the plan's "
                             "index (segment_plan(..., keep_index=True))")
        check_int32("index", index, dev, (E,))
    grad = torch.empty((E, d), dtype=torch.float32, device=dev)
    g_out, order, keys = aligned(g_out), aligned(order), aligned(keys)
    index = aligned(index) if order is not None else None
    vec, group, per, R1, RL, _, _ = geometry(E, d)
    ties = scratch = None
    slots = [None] * 4
    if op == "sum":
        values = out = None
    else:
        if values is None or out is None:
            raise ValueError(f"{op}'s backward needs the forward's values "
                             f"and output")
        check_rows("values", values, dev, (E, d))
        check_rows("out", out, dev, (S, d))
        values, out = aligned(values), aligned(out)
        ties = torch.empty((S, d), dtype=torch.int32, device=dev)
        scratch, slots = scratch_buffers(E, d, dev)
    lib = _grad_lib()

    def ptr(t):
        return None if t is None or t.numel() == 0 else t.data_ptr()

    with _build.on_card(dev) as stream:
        err = lib.segment_reduce_grad_launch(
            g_out.data_ptr(), ptr(values), ptr(out), ptr(order),
            keys.data_ptr(), ptr(index), ptr(ties), *slots, grad.data_ptr(),
            E, S, d, OPS[op], vec, per, group, R1, RL, stream)
    del scratch
    if err != 0:
        msg = lib.segment_reduce_grad_error_string(err).decode()
        raise RuntimeError(f"segment_reduce_grad launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["segment_reduce_grad"] += 1
    return grad


_IDENTITY = {"sum": 0.0, "max": -math.inf, "min": math.inf}


def card_order_reduce(values: torch.Tensor, order: torch.Tensor | None,
                      keys: torch.Tensor, S: int, op: str) -> torch.Tensor:
    """The card's fold written in torch, for tests: the same levels,
    runs, blocks, slots and phantoms as ``csrc/segment_units.cuh``
    (fold_runs), each add in float32 in the card's order, so that on the
    same values it gives the kernel's bits. values (E, d) float32, order
    (E,) or None, keys (E,) the plan's. Slow: a Python loop over
    positions."""
    E, d = values.shape
    group, _ = layout(d, unit_width(d))
    G = THREADS // group
    rows = values if order is None else values[order.long()]
    out = torch.full((S, d), _IDENTITY[op], dtype=torch.float32)
    fold = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum}[op]

    def seg(k: int) -> int:
        if k >= 0:
            return k if k < S else -1
        return -1 if k == -1 else -k - 2

    def walk(items, left, right):
        """One run's left fold: the segments that start and end in it to
        out; returns its two slots (entered from the left, leaving to the
        right)."""
        slots = [(-1, None), (-1, None)]
        cur, head = (seg(items[0][0]) if items else -1), left
        acc = torch.full((d,), _IDENTITY[op], dtype=torch.float32)
        for k, row in items:
            s = seg(k)
            if s != cur:
                if cur >= 0:
                    if head:
                        slots[0] = (cur, acc)
                    else:
                        out[cur] = acc
                head, cur = False, s
                acc = torch.full((d,), _IDENTITY[op], dtype=torch.float32)
            if 0 <= k < S:
                acc = fold(acc, row)
        if cur >= 0:
            if right and head:
                slots = [(cur, acc), (-cur - 2, None)]
            elif right:
                slots[1] = (cur, acc)
            elif head:
                slots[0] = (cur, acc)
            else:
                out[cur] = acc
        return slots

    items = [(int(k), rows[p]) for p, k in enumerate(keys.tolist())]
    for n, R in levels(E, d):
        assert n == len(items)
        runs = -(-n // R)
        blocks = -(-runs // G)
        nxt: list = []
        for blk in range(blocks):
            shared, opens = [], []
            for r in range(blk * G, min(runs, blk * G + G)):
                a, b = r * R, min(r * R + R, n)
                first, last = seg(items[a][0]), seg(items[b - 1][0])
                left = a > 0 and first >= 0 and seg(items[a - 1][0]) == first
                right = b < n and last >= 0 and seg(items[b][0]) == last
                shared += walk(items[a:b], left, right)
                opens.append((left, right))
            nxt += walk(shared, opens[0][0], opens[-1][1]) if shared else []
        if blocks <= 1:
            return out
        items = nxt
    return out
