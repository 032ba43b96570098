"""Port parity of the push SpMM kernels' plain versions against the JAX
package (K1 against ``ell_spmm_pallas`` in interpret mode and
``ref.ell_spmm_ref`` at rtol 1e-5; K2 against ``ref.ell_spmm_sliced_ref``
at rtol 1e-4, because the sliced Pallas kernel does not trace on this jax;
atol 1e-6 of the largest output in both), the
CPU/CUDA dispatch and the wrappers' argument checks. The CUDA kernels
themselves are held against these plain versions on a card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_sliced_ell import powerlaw_graph

from repro.kernels import ref as jref
from repro.kernels.ell_spmv import ell_spmm_pallas
from repro.ppr.datasets import small_test_graph
from repro_torch.kernels import _build, ell_spmv, ops, ref

GRAPHS = {"small": lambda: small_test_graph(n=120, avg_deg=6, seed=2),
          "powerlaw": lambda: powerlaw_graph(150, seed=3)}


def _inputs(graph, B: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, graph.n)) ** 3).astype(np.float32)
    x /= x.sum(axis=1, keepdims=True)
    thr = (np.quantile(x, 0.5)
           * np.maximum(graph.out_degree, 1) / 6).astype(np.float32)
    return x, thr


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("fused", [False, True])
def test_dense_plain_matches_pallas_and_ref(kind, B, fused):
    g = GRAPHS[kind]()
    nbr, mask, w = g.ell_in()
    x, thr = _inputs(g, B, seed=B)
    thr_j = jnp.asarray(thr) if fused else None
    want_pallas = np.asarray(ell_spmm_pallas(
        jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(w), jnp.asarray(x),
        thr_j, block_n=64, interpret=True))
    want_ref = np.asarray(jref.ell_spmm_ref(
        jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(x), jnp.asarray(w),
        thr_j))
    tn, tm, tw, tx, tthr = _t(nbr, mask, w, x, thr)
    got = ref.ell_spmm_ref(tn, tm, tx, tw, tthr if fused else None).numpy()
    atol = 1e-6 * float(np.abs(want_ref).max())     # tied to the scale
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=atol)
    dispatched = ops.ell_spmm(tn, tm, tw, tx,
                              threshold=tthr if fused else None)
    assert torch.equal(dispatched, torch.from_numpy(got))


def _padded(sl, n: int, pad: int, seed: int):
    """The sliced table with ``pad`` trailing padding rows (row_map == n,
    live mask) that every version must drop."""
    rng = np.random.default_rng(seed)
    W = sl.neighbors.shape[1]
    return (np.concatenate([sl.neighbors,
                            rng.integers(0, n, (pad, W)).astype(np.int32)]),
            np.concatenate([sl.mask, np.ones((pad, W), bool)]),
            np.concatenate([sl.weights, np.ones((pad, W), np.float32)]),
            np.concatenate([sl.row_map, np.full(pad, n, np.int32)]))


@pytest.mark.parametrize("kind", sorted(GRAPHS))
@pytest.mark.parametrize("width,pad", [(8, 0), (1, 0), (8, 5), (None, 3)])
@pytest.mark.parametrize("B", [1, 4])
def test_sliced_plain_matches_ref(kind, width, pad, B):
    g = GRAPHS[kind]()
    sl = g.ell_in_sliced(width=width, pad_multiple=1 if width == 1 else 8)
    nbr, mask, w, rm = _padded(sl, g.n, pad, seed=pad)
    x, thr = _inputs(g, B, seed=7)
    for fused in (False, True):
        thr_j = jnp.asarray(thr) if fused else None
        want = np.asarray(jref.ell_spmm_sliced_ref(
            jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(x),
            jnp.asarray(w), thr_j, jnp.asarray(rm)))
        tn, tm, tw, trm, tx, tthr = _t(nbr, mask, w, rm, x, thr)
        got = ops.ell_spmm_sliced(tn, tm, tw, trm, tx,
                                  threshold=tthr if fused else None).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * float(np.abs(want).max()))
    # the fold equals the dense table's answer
    dn, dm, dw = _t(*g.ell_in())
    tx = torch.from_numpy(x)
    dense = ref.ell_spmm_ref(dn, dm, tx, dw)
    sliced = ref.ell_spmm_sliced_ref(*_t(nbr, mask), tx, torch.from_numpy(w),
                                     None, torch.from_numpy(rm))
    torch.testing.assert_close(sliced, dense, rtol=1e-4, atol=1e-6)


def test_dispatch_routes_by_device():
    g = GRAPHS["small"]()
    nbr, mask, w = _t(*g.ell_in())
    x = torch.rand((2, g.n))
    with pytest.raises(ValueError, match="no kernel for device"):
        ops.ell_spmm(nbr, mask, w, x.to("meta"))
    # the CUDA wrappers refuse CPU tensors before touching the compiler
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell_spmv.ell_spmm_cuda(nbr, mask, w, x)
    sl = g.ell_in_sliced(width=8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell_spmv.ell_spmm_sliced_cuda(*_t(sl.neighbors, sl.mask, sl.weights,
                                          sl.row_map), x)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ell_spmv.ell_spmv_cuda(nbr, mask, w, x[0])
    ell_spmv.reset_launches()
    ops.ell_spmm(nbr, mask, w, x)
    ops.ell_spmv(nbr, mask, w, x[0])
    assert ell_spmv.LAUNCHES == {"ell_spmm": 0, "ell_spmm_sliced": 0,
                                 "ell_spmv": 0}


def test_build_names_follow_source_and_flags(monkeypatch, tmp_path):
    path = _build.library_path("ell_spmm")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path("ell_spmm")
    # an edited header renames every library whose source includes it
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path("ell_spmm") == path
    names = {k: _build.library_path(k) for k in _build.SOURCES}
    header = tmp_path / "ell_rows.cuh"
    header.write_text(header.read_text() + "// edited\n")
    for k in _build.SOURCES:
        includes = '#include "ell_rows.cuh"' in \
            (tmp_path / _build.SOURCES[k]).read_text()
        assert (_build.library_path(k) != names[k]) == includes, k
    assert {"ell_spmm", "ell_spmv"} <= {
        k for k in _build.SOURCES if _build.library_path(k) != names[k]}
    edited = _build.library_path("ell_spmm")
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build.library_path("ell_spmm") != edited
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_failed_build_raises_and_leaves_no_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc failed for ell_spmm.cu"):
        _build.load("ell_spmm", {})
    assert not _build.library_path("ell_spmm").exists()
    assert _build.log_path("ell_spmm").exists()
    assert "ell_spmm" not in _build._loaded


def _fold_by_plan(fold, partials: torch.Tensor, row_map: np.ndarray,
                  n: int) -> torch.Tensor:
    """K2's fold as its plan lays it out, in the partials' dtype: each short
    row adds its virtual rows, each warp item its run of them, into its row
    or, for a hub's chunk, into the hub's sum."""
    rp = fold.row_ptr.tolist()
    out = torch.zeros((partials.shape[0], n), dtype=partials.dtype)
    for r in range(n):
        if rp[r + 1] - rp[r] <= fold.short_slices:
            out[:, r] = partials[:, rp[r]:rp[r + 1]].sum(dim=1)
    for first in fold.items.tolist():
        r = int(row_map[first])
        end = min(first + fold.chunk_slices, rp[r + 1])
        out[:, r] += partials[:, first:end].sum(dim=1)
    return out


@pytest.mark.parametrize("n,width,pad", [(150, 8, 0), (300, 8, 5),
                                         (300, 1, 3), (700, 24, 0)])
def test_sliced_fold_plan_covers_each_slice_once(n, width, pad):
    g = powerlaw_graph(n, hubs=2, seed=n)
    sl = g.ell_in_sliced(width=width, pad_multiple=1 if width == 1 else 8)
    nbr, mask, w, rm = _padded(sl, g.n, pad, seed=pad)
    fold = ell_spmv.sliced_fold(torch.from_numpy(rm), g.n, sl.width)
    assert fold.row_ptr.dtype == fold.items.dtype == torch.int32
    np.testing.assert_array_equal(fold.row_ptr.numpy(),
                                  np.searchsorted(rm, np.arange(g.n + 1)))
    assert fold.chunk_slices == max(1, ell_spmv.WARP_CELLS // sl.width)
    assert fold.short_slices == max(1, ell_spmv.SHORT_CELLS // sl.width)
    assert (fold.rows, fold.width) == (rm.shape[0], sl.width)
    rp = fold.row_ptr.numpy()
    slices = np.diff(rp)
    hubs = np.flatnonzero(slices > fold.chunk_slices)
    np.testing.assert_array_equal(fold.hubs.numpy(), hubs)
    if width == 8 and n >= 300:
        assert hubs.size >= 1          # the graph's hubs take 38+ slices
    # the hub chunks first, hub by hub, then each longer row's first slice
    hc = fold.hub_chunks.numpy()
    assert hc[0] == 0 and hc[-1] == fold.hub_items
    items = fold.items.numpy()
    for h, r in enumerate(hubs):
        np.testing.assert_array_equal(
            items[hc[h]:hc[h + 1]],
            np.arange(rp[r], rp[r + 1], fold.chunk_slices))
    longer = (slices > fold.short_slices) & (slices <= fold.chunk_slices)
    np.testing.assert_array_equal(items[fold.hub_items:], rp[:-1][longer])
    # every virtual row of a real row is read once, padding never
    reads = np.zeros(rm.shape[0], int)
    for r in np.flatnonzero(slices <= fold.short_slices):
        reads[rp[r]:rp[r + 1]] += 1
    for first in items:
        reads[first:min(first + fold.chunk_slices, rp[rm[first] + 1])] += 1
    np.testing.assert_array_equal(reads, rm < g.n)
    # the plan's fold equals the plain version's
    x, thr = _inputs(g, 3, seed=n)
    tn, tm, tw, tx, tthr = _t(nbr, mask, w, x, thr)
    partials = ref.ell_spmm_ref(tn, tm, tx.double(), tw.double(),
                                tthr.double())
    want = ref.ell_spmm_sliced_ref(tn, tm, tx.double(), tw.double(),
                                   tthr.double(), torch.from_numpy(rm))
    torch.testing.assert_close(_fold_by_plan(fold, partials, rm, g.n), want,
                               rtol=1e-12, atol=1e-15)


def test_sliced_fold_plan_of_an_edgeless_table():
    fold = ell_spmv.sliced_fold(torch.zeros(1, dtype=torch.int32), 4, 8)
    np.testing.assert_array_equal(fold.row_ptr.numpy(), [0, 1, 1, 1, 1])
    assert fold.items.numel() == fold.hubs.numel() == fold.hub_items == 0
    assert fold.hub_chunks.tolist() == [0]
    with pytest.raises(ValueError, match="int32"):
        ell_spmv.sliced_fold(torch.zeros(3, dtype=torch.int64), 4, 8)
