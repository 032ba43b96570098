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

Three kernels a call (see the source's header): D = rowsum(dO o O), then
a dK/dV kernel (a block a key tile, looping over every row that sees it
in one fixed order, so a KV head's query heads add into its dK and dV
without atomics) and a dQ kernel (a block a tile of rows, looping over
the key tiles it sees); each output is written once, so a second call
gives the same bits. Two routes, picked by :func:`route` from the dtype
and Dh alone:

* ``"mma"`` (route A) for bfloat16 with Dh in :data:`MMA_HEAD_DIMS`
  (training's dtype), on Hopper's tensor cores: ``bwd_dot_vec``,
  ``bwd_dkdv_tma`` (a block a 64-key tile of one query head, the head's
  rows 64 at a time through a TMA ring, S^T, dP^T, dV and dK by
  ``wgmma`` in two warpgroups) and ``bwd_dq_tma`` (a block 128
  rows of one query head, key tiles through a TMA ring). P and dS enter
  their products as two bf16 terms each, so that neither is rounded
  once. With grouped KV heads each query head's dK and dV sums (a scratch
  of 2 B Skv Hq Dh floats) are added in head order by a fourth kernel,
  ``bwd_fold``, counted with the dK/dV kernel. :func:`tiles`,
  :func:`dkdv_walk` and :func:`dq_walk` give the tiles each block takes.
  The call is bound by operations (10 Dh flops a visible pair); route A
  executes twice that (S and dO V^T in both kernels, P and dS as two
  terms), so its floor is twice the bound.
* ``"simt"`` (route B) for everything else (float32; bfloat16 at Dh 8 to
  32): ``bwd_dot``, ``bwd_dkdv`` and ``bwd_dq``, every product in float32
  on the CUDA cores, rows folded (folded row rho of a KV head is query
  rho / group of its query head rho % group).

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
KEY_TILE = {"mma": 64, "simt": 32}     # keys a dK/dV block
ROW_TILE = {"mma": 128, "simt": 32}    # rows a dQ block (see ``tiles``)
_ROUTE_CODE = {"simt": 0, "mma": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "flash_attention_bwd_launch": ([_P] * 11 + [_I] * 7 + [_L] * 9
                                   + [_I, _I, ctypes.c_float, _I, _I, _P],
                                   _I),
    "flash_attention_bwd_error_string": ([_I], ctypes.c_char_p),
    "flash_attention_bwd_smem_bytes": ([_I, _I], _I),
}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1
_GRID_YZ_MAX = 65535


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention_bwd", _SIGNATURES)


def shared_bytes(Dh: int) -> dict[str, int]:
    """Route A's dynamic shared memory a block at head dim Dh, as the
    source sets it (builds the library)."""
    lib = _lib()
    return {"dkdv": lib.flash_attention_bwd_smem_bytes(Dh, 1),
            "dq": lib.flash_attention_bwd_smem_bytes(Dh, 2)}


def route(dtype: torch.dtype, Dh: int) -> str:
    """The route of a call: ``"mma"`` (tensor cores) for bfloat16 with Dh in
    :data:`MMA_HEAD_DIMS`, else ``"simt"`` (CUDA cores, float32). Float32
    never goes to the tensor cores: TF32 keeps 10 bits."""
    return "mma" if dtype == torch.bfloat16 and Dh in MMA_HEAD_DIMS \
        else "simt"


def tiles(way: str, Dh: int) -> dict[str, int]:
    """The tiles of route ``way`` at head dim Dh: the keys of a dK/dV
    block (``"dkdv_keys"``, :data:`KEY_TILE`) and the rows it takes at a
    time (``"dkdv_rows"``), the rows of a dQ block (``"dq_rows"``,
    :data:`ROW_TILE`) and the keys it takes at a time (``"dq_keys"``).
    Route A's rows are positions of one query head (``"folded"`` 0),
    route B's folded rows of a KV head (``"folded"`` 1)."""
    if way == "mma":
        return {"dkdv_keys": KEY_TILE[way], "dkdv_rows": 64,
                "dq_rows": ROW_TILE[way], "dq_keys": 32 if Dh >= 256 else 64,
                "folded": 0}
    return {"dkdv_keys": KEY_TILE[way], "dkdv_rows": 32,
            "dq_rows": ROW_TILE[way], "dq_keys": 32, "folded": 1}


def dkdv_walk(B: int, Sq: int, Skv: int, Hq: int, q_offset: int,
              causal: bool = True) -> list[tuple[int, int, int, list[int]]]:
    """Route A's dK/dV blocks in launch order (the first key tiles, for a
    causal call the heaviest, first), as ``bwd_dkdv_tma`` computes them:
    (k0, query head, batch row, the first rows of the 64-row tiles it
    takes in order: from the first row that sees key k0 to Sq)."""
    step = tiles("mma", MMA_HEAD_DIMS[0])["dkdv_rows"]
    out = []
    for blk in range(-(-Skv // KEY_TILE["mma"]) * Hq * B):
        hb = blk % (Hq * B)
        k0 = blk // (Hq * B) * KEY_TILE["mma"]
        first = min(max(0, k0 - q_offset), Sq) if causal else 0
        out.append((k0, hb % Hq, hb // Hq, list(range(first, Sq, step))))
    return out


def dq_walk(B: int, Sq: int, Skv: int, Hq: int, Dh: int, q_offset: int,
            causal: bool = True) -> list[tuple[int, int, int, int,
                                               list[int]]]:
    """Route A's dQ blocks in launch order (the last row tiles, for a
    causal call the heaviest, first), as ``bwd_dq_tma`` computes them:
    (r0, query head, batch row, the end of the keys its last row sees,
    the first keys of the key tiles it takes in order)."""
    rows, keys = ROW_TILE["mma"], tiles("mma", Dh)["dq_keys"]
    n_rt = -(-Sq // rows)
    out = []
    for blk in range(n_rt * Hq * B):
        hb = blk % (Hq * B)
        r0 = (n_rt - 1 - blk // (Hq * B)) * rows
        last = min(r0 + rows, Sq) - 1
        end = min(Skv, q_offset + last + 1) if causal else Skv
        out.append((r0, hb % Hq, hb // Hq, end, list(range(0, end, keys))))
    return out


def grid_blocks(B: int, Sq: int, Skv: int, Hq: int, Hkv: int,
                way: str) -> dict[str, int]:
    """Blocks of each kernel on route ``way``: D 8 rows a block on route
    B (up to 32 on route A; 8 counted), the dK/dV kernel a (key tile, KV
    head, batch row), on route A a (key tile, query head, batch row), the
    dQ kernel a (folded row tile, KV head, batch row), on route A a (row
    tile, query head, batch row)."""
    rows, heads = (Sq, Hq) if way == "mma" else (Sq * (Hq // Hkv), Hkv)
    return {"dot": -(-B * Sq * Hq // 8),
            "dkdv": -(-Skv // KEY_TILE[way]) * heads * B,
            "dq": -(-rows // ROW_TILE[way]) * heads * B}


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
    way = route(q.dtype, Dh)
    if way == "mma":
        # a tensor map takes no stride of 0 along an axis of several
        q, k, v = (t.contiguous() if any(st == 0 and n > 1 for st, n in
                                         zip(t.stride(), t.shape)) else t
                   for t in (q, k, v))
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
    # route A takes a query head a dK/dV block: where heads are grouped,
    # their float32 sums, folded in head order
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
