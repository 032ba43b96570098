"""Benchmark datasets (paper Table I) as scaled synthetic stand-ins.

A copy of ``repro.ppr.datasets``: the edge arrays are byte-equal to the JAX
package's for the same name, scale and seed.

The paper evaluates on SNAP graphs that are not downloadable in this offline
container, so we generate power-law graphs whose direction, order/size ratio
(average degree) and degree skew match Table I at 1/SCALE of the node count.
Both target and generated figures are reported by ``benchmarks/table1``.

Generator: vectorised preferential-attachment approximation — out-degrees
drawn from a clipped lognormal matched to the average degree; edge targets
drawn from a Zipf-like popularity distribution over node ids. O(m) numpy,
deterministic per seed.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass

import numpy as np

from .graph import Graph

SCALE_DEFAULT = 64  # 1/64 of the paper's node counts — CPU-benchmark friendly


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    n: int               # paper's order
    m: int               # paper's size
    directed: bool
    # paper §IV-A parameters for this dataset:
    scaling_factor_d: float
    degree_sigma: float = 1.0   # lognormal sigma for out-degree skew

    def scaled(self, scale: int = SCALE_DEFAULT) -> tuple[int, int]:
        n = max(64, self.n // scale)
        m = max(4 * n, self.m // scale)
        return n, m


# Paper Table I + §IV-A scaling factors (d) per dataset.
TABLE1: dict[str, DatasetSpec] = {
    "web-stanford": DatasetSpec("web-stanford", 281_903, 2_312_497, True, 1.00),
    "dblp":         DatasetSpec("dblp",         613_586, 3_980_318, False, 0.85),
    "pokec":        DatasetSpec("pokec",      1_632_803, 30_622_564, True, 0.85),
    "livejournal":  DatasetSpec("livejournal", 4_847_571, 68_993_773, True, 0.80),
}


def synthesize(spec: DatasetSpec, scale: int = SCALE_DEFAULT,
               seed: int = 0, max_degree_cap: int | None = None) -> Graph:
    """Power-law stand-in graph at 1/scale of the paper's size."""
    n, m_target = spec.scaled(scale)
    # crc32, not hash(): str hashes are PYTHONHASHSEED-randomized, and the
    # graph must be byte-identical across restarts for WAL replay
    rng = np.random.default_rng(seed ^ zlib.crc32(spec.name.encode()))
    avg_deg = m_target / n
    # Out-degrees: lognormal with mean matched to avg_deg, clipped to [1, cap].
    sigma = spec.degree_sigma
    mu = np.log(avg_deg) - sigma * sigma / 2.0
    deg = np.maximum(1, rng.lognormal(mu, sigma, size=n)).astype(np.int64)
    cap = max_degree_cap if max_degree_cap is not None else max(64, int(16 * avg_deg))
    deg = np.minimum(deg, cap)
    src = np.repeat(np.arange(n, dtype=np.int64), deg)
    m = src.size
    # Targets: Zipf-ish popularity over ids (preferential-attachment proxy).
    u = rng.random(m)
    zipf_a = 0.9
    dst = (n * (u ** (1.0 / (1.0 - zipf_a)))).astype(np.int64) % n \
        if zipf_a != 1.0 else (n * np.exp(u * np.log(n))).astype(np.int64) % n
    # mix with uniform tail so low-popularity nodes still get in-edges
    uniform = rng.integers(0, n, size=m)
    take_uniform = rng.random(m) < 0.15
    dst = np.where(take_uniform, uniform, dst)
    return Graph.from_edges(n, src, dst, directed=spec.directed,
                            name=f"{spec.name}@1/{scale}")


def load(name: str, scale: int = SCALE_DEFAULT, seed: int = 0) -> Graph:
    key = name.lower()
    if key not in TABLE1:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(TABLE1)}")
    return synthesize(TABLE1[key], scale=scale, seed=seed)


def small_test_graph(n: int = 64, avg_deg: float = 6.0, seed: int = 0,
                     directed: bool = True) -> Graph:
    """Tiny deterministic graph for unit tests and smoke configs."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return Graph.from_edges(n, src, dst, directed=directed, name=f"test{n}")
