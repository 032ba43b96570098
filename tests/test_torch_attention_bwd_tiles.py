"""The tiles of K6's backward on route A, walked on the CPU.

``flash_attention_bwd.dkdv_walk`` and ``dq_walk`` give, in launch order,
the blocks of ``bwd_dkdv_tma`` and ``bwd_dq_tma`` and the tiles each takes
(the first and last tile at the causal edge with ``q_offset``, the head
split, the key tile past Skv), by the integer formulas the kernels use. A
float64 emulation walks exactly those tiles (a dK/dV block's rows 64 at a
time, its per-head sums added in head order as ``bwd_fold`` adds them; a
dQ block's key tiles in order) and is held against
``ref.flash_attention_bwd_ref`` in float64 (rtol 1e-10 of the largest
entry: the same sums in another order), every visible (row, key) pair of
every head taken exactly once by each walk. Seeded numpy inputs, a few
tiny shapes: groups 1, 2 and 8, q_offset 0 and 29, Skv not a multiple of
the key tile, Dh 256 (32-key dQ tiles) and below (64), one call not
causal.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ref

# (B, Sq, Hq, Hkv, Dh, q_offset, causal); Skv = Sq + q_offset
CASES = [(1, 70, 4, 4, 64, 0, True), (2, 45, 4, 2, 128, 29, True),
         (1, 100, 8, 1, 256, 29, True), (1, 130, 8, 1, 64, 0, True),
         (2, 33, 2, 1, 256, 0, True), (1, 40, 4, 2, 64, 7, False)]


def _inputs(B, Sq, Hq, Hkv, Dh, off, causal):
    rng = np.random.default_rng(Sq * 31 + Dh + off)
    q = torch.from_numpy(rng.standard_normal((B, Sq, Hq, Dh)))
    k = torch.from_numpy(rng.standard_normal((B, Sq + off, Hkv, Dh)))
    v = torch.from_numpy(rng.standard_normal((B, Sq + off, Hkv, Dh)))
    dout = torch.from_numpy(rng.standard_normal((B, Sq, Hq, Dh)))
    o = ref.flash_attention_ref(q, k, v, causal=causal, q_offset=off)
    return q, k, v, o, dout


def _visible(Sq, Skv, off, causal):
    rows = torch.arange(Sq)[:, None] + off
    keys = torch.arange(Skv)[None, :]
    return (rows >= keys) if causal else torch.ones((Sq, Skv), dtype=bool)


def _walk(q, k, v, o, dout, off, causal):
    """(dQ, dK, dV) by route A's tiles, and each walk's visits of every
    (batch row, head, row, key)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    tile = fab.tiles("mma", Dh)
    seen = _visible(Sq, Skv, off, causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q,
                     k.repeat_interleave(group, dim=2)) * scale
    lse = torch.logsumexp(s.masked_fill(~seen, -math.inf), -1)  # (B,Hq,Sq)
    dsum = (dout * o).sum(-1).transpose(1, 2)                    # (B,Hq,Sq)

    def pair(b, h, rows, keys, end):
        hkv = h // group
        ok = (keys[None, :] < end) & (rows[:, None] < Sq)
        if causal:
            ok &= off + rows[:, None] >= keys[None, :]
        r, c = rows.clamp(max=Sq - 1), keys.clamp(max=Skv - 1)
        st = q[b, r, h] @ k[b, c, hkv].T * scale
        p = torch.where(ok, torch.exp(st - lse[b, h, r][:, None]), 0.0)
        dp = dout[b, r, h] @ v[b, c, hkv].T
        return ok, p, p * (dp - dsum[b, h, r][:, None])

    part_k = torch.zeros((B, Skv, Hkv, group, Dh), dtype=q.dtype)
    part_v = torch.zeros_like(part_k)
    visits_kv = torch.zeros((B, Hq, Sq, Skv), dtype=torch.int64)
    blocks = fab.dkdv_walk(B, Sq, Skv, Hq, off, causal)
    assert len(blocks) == fab.grid_blocks(B, Sq, Skv, Hq, Hkv, "mma")["dkdv"]
    for k0, h, b, starts in blocks:
        keys = torch.arange(k0, k0 + tile["dkdv_keys"])
        dk = torch.zeros((len(keys), Dh), dtype=q.dtype)
        dv = torch.zeros_like(dk)
        for r0 in starts:
            rows = torch.arange(r0, r0 + tile["dkdv_rows"])
            ok, p, ds = pair(b, h, rows, keys, Skv)
            r = rows.clamp(max=Sq - 1)
            dv += p.T @ dout[b, r, h]
            dk += ds.T @ q[b, r, h]
            visits_kv[b, h, rows[rows < Sq, None], keys[None, keys < Skv]] += \
                ok[rows < Sq][:, keys < Skv]
        live = keys < Skv
        part_k[b, keys[live], h // group, h % group] = dk[live] * scale
        part_v[b, keys[live], h // group, h % group] = dv[live]
    dK = torch.zeros((B, Skv, Hkv, Dh), dtype=q.dtype)
    dV = torch.zeros_like(dK)
    for g in range(group):                  # bwd_fold's head order
        dK += part_k[:, :, :, g]
        dV += part_v[:, :, :, g]

    dQ = torch.zeros_like(q)
    visits_q = torch.zeros_like(visits_kv)
    blocks = fab.dq_walk(B, Sq, Skv, Hq, Dh, off, causal)
    assert len(blocks) == fab.grid_blocks(B, Sq, Skv, Hq, Hkv, "mma")["dq"]
    for r0, h, b, end, starts in blocks:
        rows = torch.arange(r0, r0 + tile["dq_rows"])
        acc = torch.zeros((len(rows), Dh), dtype=q.dtype)
        for c0 in starts:
            keys = torch.arange(c0, c0 + tile["dq_keys"])
            ok, _, ds = pair(b, h, rows, keys, end)
            acc += ds @ k[b, keys.clamp(max=Skv - 1), h // group]
            visits_q[b, h, rows[rows < Sq, None], keys[None, keys < Skv]] += \
                ok[rows < Sq][:, keys < Skv]
        dQ[b, rows[rows < Sq], h] = acc[rows < Sq] * scale
    return (dQ, dK, dV), visits_kv, visits_q, seen


@pytest.mark.parametrize("B,Sq,Hq,Hkv,Dh,off,causal", CASES)
def test_route_a_tiles_give_the_plain_gradients(B, Sq, Hq, Hkv, Dh, off,
                                                causal):
    q, k, v, o, dout = _inputs(B, Sq, Hq, Hkv, Dh, off, causal)
    got, _, _, _ = _walk(q, k, v, o, dout, off, causal)
    want = ref.flash_attention_bwd_ref(q, k, v, o, dout, causal=causal,
                                       q_offset=off)
    for name, x, y in zip(("dQ", "dK", "dV"), got, want):
        err = float((x - y).abs().max())
        assert err <= 1e-10 * float(y.abs().max()), (name, err)


@pytest.mark.parametrize("B,Sq,Hq,Hkv,Dh,off,causal", CASES)
def test_route_a_tiles_take_each_visible_pair_once(B, Sq, Hq, Hkv, Dh, off,
                                                   causal):
    q, k, v, o, dout = _inputs(B, Sq, Hq, Hkv, Dh, off, causal)
    _, visits_kv, visits_q, seen = _walk(q, k, v, o, dout, off, causal)
    want = seen.to(torch.int64).expand(B, Hq, Sq, Sq + off)
    assert torch.equal(visits_kv, want)
    assert torch.equal(visits_q, want)


@pytest.mark.parametrize("Dh", fab.MMA_HEAD_DIMS)
def test_route_a_tiles_fit_the_kernels(Dh):
    """The tiles the kernels' shapes assume: a dK/dV block's 64 keys and
    64-row stages (one wgmma M of keys, one N of rows), a dQ block's two
    warpgroups of 64 rows, its key tile a multiple of 16 (the k of its
    dQ product), the first key tiles first and the last row tiles
    first."""
    tile = fab.tiles("mma", Dh)
    assert (tile["dkdv_keys"], tile["dkdv_rows"], tile["dq_rows"]) == \
        (fab.KEY_TILE["mma"], 64, fab.ROW_TILE["mma"]) == (64, 64, 128)
    assert tile["dq_keys"] in (32, 64) and tile["folded"] == 0
    kv = fab.dkdv_walk(1, 300, 329, 2, 29)
    assert [blk[0] for blk in kv] == sorted(blk[0] for blk in kv)
    assert [len(blk[3]) for blk in kv] == sorted(
        (len(blk[3]) for blk in kv), reverse=True)
    dq = fab.dq_walk(1, 300, 329, 2, Dh, 29)
    assert [blk[0] for blk in dq] == sorted((blk[0] for blk in dq),
                                            reverse=True)
