"""Port parity: the host graph builders, the datasets and the device
residency of ``repro_torch`` against ``repro`` (array-equal), and the
port's package rules (no JAX, no ``repro``; no silent CPU fallback)."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_sliced_ell import powerlaw_graph

import repro.ppr.datasets as jdatasets
import repro.ppr.graph as jgraph
import repro_torch.ppr.datasets as tdatasets
import repro_torch.ppr.graph as tgraph

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _pair(kind: str):
    """The same graph built by both packages."""
    if kind == "small":
        return (jdatasets.small_test_graph(n=200, avg_deg=8, seed=1),
                tdatasets.small_test_graph(n=200, avg_deg=8, seed=1))
    if kind == "undirected":
        return (jdatasets.small_test_graph(n=150, seed=4, directed=False),
                tdatasets.small_test_graph(n=150, seed=4, directed=False))
    jg = powerlaw_graph(400, seed=1)
    tg = tgraph.Graph.from_edges(jg.n, jg.edge_src, jg.edge_dst,
                                 name=jg.name)
    return jg, tg


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("kind", ["small", "undirected", "powerlaw"])
def test_host_tables_array_equal(kind):
    jg, tg = _pair(kind)
    for field in ("edge_src", "edge_dst", "out_degree", "out_offsets",
                  "in_degree"):
        np.testing.assert_array_equal(getattr(tg, field), getattr(jg, field))
    assert tg.summary() == jg.summary()
    for a, b in zip(tg.ell_in(), jg.ell_in()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert tg._sliced_width_cells() == jg._sliced_width_cells(8)
    assert tg.sliced_ell_width() == jg.sliced_ell_width()
    for width in (None, 1, 8, 24):
        ts, js = tg.ell_in_sliced(width=width), jg.ell_in_sliced(width=width)
        for field in ("neighbors", "mask", "weights", "row_map"):
            np.testing.assert_array_equal(getattr(ts, field),
                                          getattr(js, field))
        assert (ts.width, ts.n, ts.nbytes) == (js.width, js.n, js.nbytes)


@pytest.mark.parametrize("kind", ["small", "powerlaw"])
@pytest.mark.parametrize("layout", ["auto", "dense", "sliced"])
def test_device_graph_and_from_arrays_equal_jax(kind, layout):
    jg, tg = _pair(kind)
    jdg = jgraph.DeviceGraph.from_graph(jg, layout=layout)
    tdg = tgraph.DeviceGraph.from_graph(tg, layout=layout, device="cpu")
    arrays = {f: np.asarray(getattr(jdg, f))
              for f in tgraph.DeviceGraph.ARRAY_FIELDS
              if getattr(jdg, f) is not None}
    carried = tgraph.DeviceGraph.from_arrays(arrays, device="cpu")
    for dg in (tdg, carried):
        assert dg.layout == jdg.layout
        assert (dg.n, dg.m, dg.ell_width) == (jdg.n, jdg.m, jdg.ell_width)
        assert dg.ell_nbytes == jdg.ell_nbytes
        for f, a in arrays.items():
            t = getattr(dg, f)
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)
            assert t.numpy().dtype == a.dtype
    if layout == "auto":
        assert tdg.layout == ("dense" if kind == "small" else "sliced")


@pytest.mark.parametrize("kind", ["small", "powerlaw"])
@pytest.mark.parametrize("layout", ["dense", "sliced"])
def test_from_arrays_builds_the_fold_from_the_row_map(kind, layout):
    """The sliced table's fold structure (K2's offsets and hub list) comes
    from the row_map alone: the JAX package's arrays carried across give
    the same fold as the port's own residency."""
    jg, tg = _pair(kind)
    jdg = jgraph.DeviceGraph.from_graph(jg, layout=layout)
    arrays = {f: np.asarray(getattr(jdg, f))
              for f in tgraph.DeviceGraph.ARRAY_FIELDS
              if getattr(jdg, f) is not None}
    carried = tgraph.DeviceGraph.from_arrays(arrays, device="cpu")
    own = tgraph.DeviceGraph.from_graph(tg, layout=layout, device="cpu")
    if layout == "dense":
        assert carried.in_fold is None and own.in_fold is None
        return
    rm = arrays["in_row_map"]
    np.testing.assert_array_equal(carried.in_fold.row_ptr.numpy(),
                                  np.searchsorted(rm, np.arange(jg.n + 1)))
    for field, value in carried.in_fold._asdict().items():
        other = getattr(own.in_fold, field)
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, other), field
        else:
            assert value == other, field
    assert carried.in_fold.rows == rm.shape[0]
    assert carried.in_fold.width == carried.ell_width


@pytest.mark.parametrize("name,scale", [("web-stanford", 512), ("dblp", 1024),
                                        ("pokec", 2048),
                                        ("livejournal", 4096)])
def test_datasets_byte_equal(name, scale):
    jg, tg = jdatasets.load(name, scale=scale), tdatasets.load(name, scale=scale)
    assert tg.n == jg.n <= 2000 and tg.name == jg.name
    assert tg.edge_src.tobytes() == jg.edge_src.tobytes()
    assert tg.edge_dst.tobytes() == jg.edge_dst.tobytes()
    assert {k: vars(v) for k, v in tdatasets.TABLE1.items()} == \
        {k: vars(v) for k, v in jdatasets.TABLE1.items()}


def test_upload_once_per_device():
    g = tdatasets.small_test_graph(n=64)
    before = tgraph.DeviceGraph.uploads
    dg = g.device("cpu")
    assert g.device("cpu") is dg and g.device(torch.device("cpu")) is dg
    assert tgraph.DeviceGraph.uploads == before + 1


def test_edgeless_and_bad_arrays():
    g = tgraph.Graph.from_edges(4, np.array([], np.int64),
                                np.array([], np.int64),
                                add_dangling_self_loops=False)
    sl = g.ell_in_sliced()
    assert sl.n_virtual == 1 and not sl.mask.any()
    dg = tdatasets.small_test_graph(n=32).device("cpu")
    arrays = {f: getattr(dg, f).numpy() for f in dg.ARRAY_FIELDS
              if getattr(dg, f) is not None}
    with pytest.raises(ValueError, match="unknown"):
        tgraph.DeviceGraph.from_arrays({**arrays, "block_n": np.zeros(1)},
                                       device="cpu")
    with pytest.raises(ValueError, match="missing"):
        tgraph.DeviceGraph.from_arrays(
            {k: v for k, v in arrays.items() if k != "edge_dst"},
            device="cpu")


def test_default_device_raises_without_cuda(no_cuda):
    g = tdatasets.small_test_graph(n=32)
    with pytest.raises(RuntimeError, match="CUDA"):
        g.device()
    with pytest.raises(RuntimeError, match="CUDA"):
        tgraph.DeviceGraph.from_graph(g)


def _imports(path: Path) -> list[str]:
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append(node.module or "")
    return out


def test_port_sources_import_no_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [PORT.parents[1] / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imports(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_import_without_jax_loads_no_repro():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import repro_torch, repro_torch.quickstart\n"
            "import repro_torch.kernels._build, repro_torch.kernels.ell_spmv\n"
            "import repro_torch.index, repro_torch.kernels.walk_gather\n"
            "import repro_torch.models, repro_torch.configs\n"
            "import repro_torch.models.moe\n"
            "import repro_torch.kernels.flash_attention\n"
            "import repro_torch.kernels.embedding_bag\n"
            "import repro_torch.core.allocator, repro_torch.ft.elastic\n"
            "import repro_torch.deadline_serving\n"
            "import repro_torch.serving, repro_torch.dyn\n"
            "import repro_torch.serving.engine, repro_torch.serving.lanes\n"
            "import repro_torch.dyn.dynamic_graph\n"
            "import repro_torch.dyn.mutation_log\n"
            "import repro_torch.kernels.endpoint_fold\n"
            "import repro_torch.ppr.montecarlo\n"
            "import repro_torch.launch.serve, repro_torch.serving.runtime\n"
            "import repro_torch.serving.job, repro_torch.serving.pool\n"
            "import repro_torch.serving.metrics, repro_torch.serving.wal\n"
            "import repro_torch.kernels.autotune, repro_torch.ft.chaos\n"
            "import repro_torch.checkpoint.store\n"
            "import repro_torch.index.result_cache\n"
            "import repro_torch.data, repro_torch.data.neighbor_sampler\n"
            "import repro_torch.models.gnn, repro_torch.models.gnn.common\n"
            "import repro_torch.models.gnn.gcn, repro_torch.models.gnn.pna\n"
            "import repro_torch.models.gnn.graphcast\n"
            "import repro_torch.models.gnn.dimenet\n"
            "import repro_torch.kernels.segment_reduce\n"
            "import repro_torch.optim, repro_torch.optim.adamw\n"
            "import repro_torch.optim.compress, repro_torch.data.pipeline\n"
            "import repro_torch.launch.train\n"
            "from repro_torch.kernels.embedding_bag import "
            "embedding_bag_grad_cuda\n"
            "from repro_torch.models.recsys.din import loss_fn, "
            "batch_plans\n"
            "from repro_torch.kernels.ops import gather_rows, "
            "segment_reduce_grad\n"
            "from repro_torch.configs import gcn_cora, pna_arch, "
            "graphcast_arch, dimenet_arch\n"
            "from repro_torch.kernels.ops import segment_plan, "
            "segment_reduce\n"
            "from repro_torch.kernels.ell_spmv import ell_spmv_cuda\n"
            "from repro_torch.ppr import ppr_single_pair\n"
            "from repro_torch.ppr.graph import ShardedDeviceGraph, "
            "DeviceMesh\n"
            "from repro_torch.ppr import forward_push_sharded, window_walks\n"
            "from repro_torch.kernels.ops import ell_spmm_shard, "
            "ell_spmm_sliced_shard\n"
            "bad = [m for m, v in sys.modules.items() if v is not None "
            "and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=PORT.parents[1],
                          env={**os.environ, "PYTHONPATH": str(PORT.parent)})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
