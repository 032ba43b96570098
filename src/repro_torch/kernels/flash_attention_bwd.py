"""CUDA wrapper for K6's backward, the gradients of the LMs' attention in
training.

``flash_attention_bwd_cuda`` launches ``csrc/flash_attention_bwd.cu``: the
gradients dQ, dK and dV of causal attention with a query offset and
grouped KV heads, given q, k, v, the forward's output o, its float32
logsumexp (``flash_attention_cuda(..., return_lse=True)``) and the
output's gradient dO. It replaces no Pallas kernel: the JAX package's
train step differentiates its plain ``flash_attention_jnp``
(``repro/models/common.py:87``) by autodiff, while the port's forward runs
through K6 on the card, so its backward on the card is a kernel too.

Three kernels a call (see the source's header): ``bwd_dot`` (D = rowsum(dO
o O)), ``bwd_dkdv`` (a block a key tile, looping over every folded row that
sees it in one fixed order, so a KV head's query heads add into its dK and
dV without atomics) and ``bwd_dq`` (a block a tile of folded rows, looping
over the key tiles it sees); each output is written once, so a second
call gives the same bits. Two routes, picked by :func:`route` from the
dtype and Dh alone:

* ``"mma"`` (route A) for bfloat16 with Dh in :data:`MMA_HEAD_DIMS`
  (training's dtype): the products on the tensor cores (``mma.sync`` on
  bf16 tiles brought in by ``cp.async``), P and dS split into two bf16
  terms each so that neither is rounded once. With grouped KV heads a key
  tile's rows are split by query head over as many blocks, their float32
  sums (a scratch of 2 B Skv Hq Dh floats) added in head order by a
  fourth kernel, ``bwd_fold``, counted with ``bwd_dkdv``.
* ``"simt"`` (route B) for everything else (float32; bfloat16 at Dh 8 to
  32): every product in float32 on the CUDA cores.

The wrapper checks device, dtype, shape and strides, allocates the
outputs and D with ``torch.empty``, launches on PyTorch's current stream,
raises on a non-zero ``cudaGetLastError()``, and counts its launches in
:data:`LAUNCHES`: every call under ``"flash_attention_bwd"`` and each
kernel under its own key and each route under ``"flash_attention_bwd_mma"``
or ``"flash_attention_bwd_simt"``. q, k and v may be strided views with a
contiguous last axis, as the forward takes them; o and dO are made
contiguous.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .flash_attention import HEAD_DIMS

# launches since the last reset_launches(): every call, and each kernel's
LAUNCHES: dict[str, int] = {"flash_attention_bwd": 0,
                            "flash_attention_bwd_dot": 0,
                            "flash_attention_bwd_dkdv": 0,
                            "flash_attention_bwd_dq": 0,
                            "flash_attention_bwd_mma": 0,
                            "flash_attention_bwd_simt": 0}
KERNELS = ("dot", "dkdv", "dq")        # in launch order; bit i of ``which``
MMA_HEAD_DIMS = (64, 128, 256)         # route A's template instances
KEY_TILE = {"mma": 32, "simt": 32}     # keys a bwd_dkdv block
ROW_TILE = {"mma": 64, "simt": 32}     # folded rows a bwd_dq block
_ROUTE_CODE = {"simt": 0, "mma": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_bwd_launch": ([_P] * 11 + [_I] * 7 + [_L] * 9
                                   + [_I, _I, ctypes.c_float, _I, _I, _P],
                                   _I),
    "flash_attention_bwd_error_string": ([_I], ctypes.c_char_p),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
_GRID_YZ_MAX = 65535


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention_bwd", _SIGNATURES)


def route(dtype: torch.dtype, Dh: int) -> str:
    """The route of a call: ``"mma"`` (tensor cores) for bfloat16 with Dh in
    :data:`MMA_HEAD_DIMS`, else ``"simt"`` (CUDA cores, float32). Float32
    never goes to the tensor cores: TF32 keeps 10 bits."""
    return "mma" if dtype == torch.bfloat16 and Dh in MMA_HEAD_DIMS \
        else "simt"


def grid_blocks(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                way: str) -> dict[str, int]:
    """Blocks of each kernel on route ``way``: ``bwd_dot`` 8 rows a block,
    ``bwd_dkdv`` a (key tile, KV head, batch row), on route A a (key tile,
    query head, batch row), ``bwd_dq`` a (folded row tile, KV head, batch
    row)."""
    rows = Sq * (Hq // Hkv)
    heads = Hq if way == "mma" else Hkv
    return {"dot": -(-B * Sq * Hq // 8),
            "dkdv": -(-Skv // KEY_TILE[way]) * heads * B,
            "dq": -(-rows // ROW_TILE[way]) * Hkv * B}


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, dout: torch.Tensor, *,
                             causal: bool = True, q_offset: int = 0,
                             kernels: tuple[str, ...] = KERNELS,
                             dsum: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """(dQ, dK, dV) of attention of q (B, Sq, Hq, Dh) over k, v (B, Skv,
    Hkv, Dh) on the card, given the forward's output o (B, Sq, Hq, Dh), its
    logsumexp ``lse`` (B, Sq, Hq) float32 and the output's gradient
    ``dout``; all of one dtype, float32 or bfloat16, Dh in ``HEAD_DIMS``.
    dQ in q's shape, dK and dV in k's, contiguous, in q's dtype.
    ``kernels`` and ``dsum`` serve a timing that launches the kernels one
    at a time: ``dsum`` (B, Sq, Hq) float32 holds D from an earlier
    ``("dot",)`` call; outputs a call does not write are left empty."""
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
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o and dout must be q's shape {tuple(q.shape)}, "
                         f"got {tuple(o.shape)} and {tuple(dout.shape)}")
    if tuple(lse.shape) != (B, Sq, Hq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be (B, Sq, Hq) = {(B, Sq, Hq)} float32, "
                         f"got {tuple(lse.shape)} {lse.dtype}")
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
    if q.dtype not in _DTYPES or any(t.dtype != q.dtype
                                     for t in (k, v, o, dout)):
        raise ValueError(f"q, k, v, o, dout must all be float32 or all "
                         f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{o.dtype}, {dout.dtype}")
    bad = set(kernels) - set(KERNELS)
    if bad or not kernels:
        raise ValueError(f"kernels must name some of {KERNELS}, got "
                         f"{kernels}")
    o, dout, lse = o.contiguous(), dout.contiguous(), lse.contiguous()
    for t, name in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (dout, "dout"),
                    (lse, "lse")):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):   # rows load 16 bytes
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous, "
                             f"strides {t.stride()}")
        if t.data_ptr() % 16 or any(st * t.element_size() % 16
                                    for st in t.stride()[:3]):
            raise ValueError(f"{name}'s rows must start on 16-byte "
                             f"boundaries (address {t.data_ptr()}, strides "
                             f"{t.stride()})")
    for t, name in ((o, "o"), (dout, "dout")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    way = route(q.dtype, Dh)
    if max(grid_blocks(B, Sq, Skv, Hq, Hkv, way).values()) > _INT32_MAX:
        raise ValueError("shapes out of range: too many blocks")
    if dsum is None:
        if "dot" not in kernels:
            raise ValueError("without bwd_dot, pass its D as dsum")
        dsum = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev)
    elif tuple(dsum.shape) != (B, Sq, Hq) or dsum.dtype != torch.float32 \
            or not dsum.is_contiguous() or dsum.device != dev:
        raise ValueError(f"dsum must be contiguous (B, Sq, Hq) float32 on "
                         f"{dev}")
    # route A splits the key tiles' rows by query head where heads are
    # grouped: their float32 sums, folded in head order
    scratch = None
    if way == "mma" and Hq > Hkv and "dkdv" in kernels:
        scratch = torch.empty(2 * B * Skv * Hq * Dh, dtype=torch.float32,
                              device=dev)
    dq = torch.empty((B, Sq, Hq, Dh), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Skv, Hkv, Dh), dtype=q.dtype, device=dev)
    dv = torch.empty_like(dk)
    which = sum(1 << KERNELS.index(name) for name in set(kernels))
    lib = _lib()
    with _build.on_card(dev) as stream:
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
            None if scratch is None else scratch.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, Sq, Skv, Hq,
            Hkv, Dh, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), q_offset, 1.0 / math.sqrt(Dh), which,
            _ROUTE_CODE[way], stream)
    if err != 0:
        msg = lib.flash_attention_bwd_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err} ({msg})")
    LAUNCHES["flash_attention_bwd"] += 1
    LAUNCHES[f"flash_attention_bwd_{way}"] += 1
    for name in KERNELS:
        if name in kernels:
            LAUNCHES[f"flash_attention_bwd_{name}"] += 1
    return dq, dk, dv
