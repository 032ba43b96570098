"""CUDA wrapper for the attention forward of the decoder LM's serving steps.

``flash_attention_cuda`` (K6) replaces
``repro/kernels/flash_attention.py::flash_attention_pallas`` (line 83, body
``_flash_kernel``) and launches ``csrc/flash_attention.cu``. The JAX model
calls ``flash_attention_jnp`` where the Pallas kernel is meant to run
(``repro/models/common.py``); the port's transformer calls this kernel
there, at prefill and at decode against the KV cache.

The Pallas kernel carries its running max, sum and output across a
sequential grid of key blocks in VMEM scratch; on the card the key loop
runs inside one block and that state lives in registers, float32
throughout (see the source's header). Query heads of one KV head are
folded into the block's rows, so the group shares each K/V tile. The
wrapper picks one of two routes from the shapes and the dtype alone
(:func:`route`):

* ``"mma"`` (route A) for bfloat16 with Dh in :data:`MMA_HEAD_DIMS` and at
  least :data:`MMA_MIN_ROWS` folded rows a KV head (``Sq * Hq / Hkv``):
  prefill. Bound by operations; Q K^T and P V run on the tensor cores
  (``mma.sync`` on bf16 tiles brought in by ``cp.async``), p split into two
  bf16 terms so that it is not rounded once.
* ``"split"`` (route B) for everything else: decode, float32, Dh 8, fewer
  rows. Bound by bytes at decode; float32 products on the CUDA cores, the
  visible keys split over :func:`split_plan` blocks so that a decode step
  fills the card, the splits merged in a fixed order by a second kernel.

The wrapper checks device, dtype, shape and strides, allocates the output
(and route B's scratch of partial results) with ``torch.empty``, launches
on PyTorch's current stream, raises on a non-zero ``cudaGetLastError()``,
and counts its launches in :data:`LAUNCHES`: every call under
``"flash_attention"``, and each under its route's key. K and V may be
strided views (a layer's slice of the cache) as long as their last axis
is contiguous: nothing is copied.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# launches since the last reset_launches(): every call, and each route's
LAUNCHES: dict[str, int] = {"flash_attention": 0, "flash_attention_mma": 0,
                            "flash_attention_split": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_launch": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _L, _L, _L, _L, _L, _L, _L, _L, _L,
                                _I, _I, ctypes.c_float, _I, _I, _I, _P, _P,
                                _P],
                               _I),
    "flash_attention_error_string": ([_I], ctypes.c_char_p),
}
HEAD_DIMS = (8, 16, 32, 64, 128, 256)       # route B's template instances
MMA_HEAD_DIMS = (16, 32, 64, 128, 256)      # route A's (k-steps of 16)
MMA_MIN_ROWS = 64                           # route A's folded rows a block
SPLIT_ROW_TILE = 16                         # route B's folded rows a block
MIN_SPLIT_KEYS = 32                         # route B's least keys a split
_ROUTE_CODE = {"split": 0, "mma": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
_GRID_YZ_MAX = 65535


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention", _SIGNATURES)


def route(dtype: torch.dtype, Sq: int, Hq: int, Hkv: int, Dh: int) -> str:
    """The route of a call: ``"mma"`` (tensor cores) for bfloat16 with Dh in
    :data:`MMA_HEAD_DIMS` and ``Sq * Hq / Hkv >= MMA_MIN_ROWS``, else
    ``"split"`` (CUDA cores, float32). Float32 never goes to the tensor
    cores: TF32 keeps 10 bits."""
    if (dtype == torch.bfloat16 and Dh in MMA_HEAD_DIMS
            and Sq * (Hq // Hkv) >= MMA_MIN_ROWS):
        return "mma"
    return "split"


def visible_keys(Sq: int, Skv: int, causal: bool, q_offset: int) -> int:
    """Keys some query row of the call sees: ``[0, kv_end)``."""
    return min(Skv, q_offset + Sq) if causal else Skv


def split_plan(B: int, Hkv: int, rows: int, kv_end: int,
               sm_count: int) -> int:
    """Route B's split count over the visible keys ``[0, kv_end)`` for
    ``rows = Sq * Hq / Hkv`` folded rows a KV head: 1 where the grid of
    (row tiles, Hkv, B) blocks already has ``2 * sm_count``; else enough
    splits for that many blocks, but none under :data:`MIN_SPLIT_KEYS`
    keys (and so none empty, see :func:`split_bounds`)."""
    blocks = -(-rows // SPLIT_ROW_TILE) * Hkv * B
    if blocks >= 2 * sm_count:
        return 1
    return max(1, min(-(-2 * sm_count // blocks), kv_end // MIN_SPLIT_KEYS))


def split_bounds(kv_end: int, splits: int) -> list[tuple[int, int]]:
    """The key range ``[lo, hi)`` of each split, as the kernel cuts it:
    split s starts at ``s * kv_end // splits``."""
    cuts = [s * kv_end // splits for s in range(splits + 1)]
    return list(zip(cuts[:-1], cuts[1:]))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, q_offset: int = 0,
                         return_lse: bool = False
                         ) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """K6: attention of q (B, Sq, Hq, Dh) over k, v (B, Skv, Hkv, Dh) on
    the card, Hq a multiple of Hkv, Dh in :data:`HEAD_DIMS`, all three
    float32 or all bfloat16 with the last axis contiguous (and q, k, v rows
    16-byte aligned, as any view of a cache is). ``q_offset`` is
    the global position of query row 0 for the causal mask (the cache
    length at decode), a run-time value. The route follows :func:`route`;
    route B's split count :func:`split_plan` with the card's SM count.
    Returns (B, Sq, Hq, Dh) in q's dtype, contiguous; with ``return_lse``
    also each row's float32 logsumexp (B, Sq, Hq) of the scaled scores,
    which K6's backward reads (the output's bits are the same either
    way)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"q must be a CUDA tensor, got {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"need 4-D q, k, v; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Skv, Hkv, Dh) or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Skv, Hkv, Dh) = "
                         f"{(B, Skv, Hkv, Dh)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"head dim {Dh} not in {HEAD_DIMS}")
    if not (1 <= B <= _GRID_YZ_MAX and Hkv <= _GRID_YZ_MAX and Sq >= 1
            and 1 <= Skv <= _INT32_MAX and Sq * Hq <= _INT32_MAX):
        raise ValueError(f"shapes out of range: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    q_offset = int(q_offset)
    if not 0 <= q_offset <= _INT32_MAX - Sq:
        raise ValueError(f"q_offset {q_offset} out of range")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, "
                             f"strides {t.stride()}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):   # rows load 16 bytes
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must start on 16-byte "
                             f"boundaries (address {t.data_ptr()}, strides "
                             f"{t.stride()})")
    way = route(q.dtype, Sq, Hq, Hkv, Dh)
    rows = Sq * (Hq // Hkv)
    kv_end = visible_keys(Sq, Skv, causal, q_offset)
    splits, scratch = 1, None
    if way == "mma":
        blocks = -(-rows // MMA_MIN_ROWS) * Hkv * B
    else:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        splits = split_plan(B, Hkv, rows, kv_end, sms)
        blocks = -(-rows // SPLIT_ROW_TILE) * splits
        if splits > 1:
            # freed on return: the caching allocator hands it out again
            # only to work queued behind the merge on this stream
            scratch = torch.empty(splits * B * Hkv * rows * (Dh + 2),
                                  dtype=torch.float32, device=dev)
    if blocks > _INT32_MAX:
        raise ValueError(f"shapes out of range: {blocks} blocks")
    out = torch.empty((B, Sq, Hq, Dh), dtype=q.dtype, device=dev)
    lse = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev) \
        if return_lse else None
    lib = _lib()
    with _build.on_card(dev) as stream:
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Skv, Hq, Hkv, Dh, *q.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], int(bool(causal)), q_offset,
            1.0 / math.sqrt(Dh), _ROUTE_CODE[way], splits, kv_end,
            None if scratch is None else scratch.data_ptr(),
            None if lse is None else lse.data_ptr(), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({msg})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{way}"] += 1
    return (out, lse) if return_lse else out
