"""Per-backend kernel tuning cache and its device-time sweep harness.

``sweep_sliced`` / ``sweep_walk`` time the port's kernels per (backend,
layout, shape bucket) and persist the winning configuration in a JSON
``TuningCache``; ``DeviceGraph``/``Graph.sliced_ell_width`` consult the
active cache when a residency is built (on the host, before upload), and
``CacheAwareCostModel.seeded_from_tuning`` prices the walk-vs-push share
of a query from the same measurements.

A cold cache keeps today's defaults and bit-identical residencies. A warm
one only re-parameterises what the caller did not pin: the sliced table's
``pad_multiple`` and ``width``. Those change the fold's association, so a
tuned answer equals the default one within the sliced tolerance, not bit
for bit. K2 (``csrc/ell_spmm_sliced.cu``) fixes its warps per block at
compile time and has no row tile like the JAX package's ``block_n``: the
sweep varies ``pad_multiple`` (the table, its width, and so K2's work)
and records ``block_n`` at the schema default, so one cache file reads
the same in both packages.

The cache file is schema 1 of the JAX package's, keyed
``backend|layout|bucket`` with backend ``cuda`` or ``cpu``, and is written
atomically (a tmp file, then ``os.replace``). The sweeps are an offline
harness: timing syncs the device and never runs inside a query.

    python -m repro_torch.kernels.autotune --cache tune.json [--smoke]
        [--expect-hit] [--device cuda]
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

SCHEMA_VERSION = 1

_ENV_CACHE = "REPRO_AUTOTUNE_CACHE"


# ---------------------------------------------------------------------------
# cache


@dataclass(frozen=True)
class TunedConfig:
    """One winning kernel configuration for a (backend, layout, bucket) key.

    ``device_us`` is the measured steady-state device time per call at this
    configuration; ``compile_us`` the first call's time (the kernel build at
    first use and the first allocations), kept apart so that cost-model
    seeding never prices a build into per-query grants. ``block_n`` is the
    JAX package's Pallas row tile; the port records its default."""
    block_n: int = 256
    pad_multiple: int | None = None
    width: int | None = None
    device_us: float = 0.0
    compile_us: float = 0.0


def shape_bucket(n: int, m: int) -> str:
    """Coarse shape key: pow2-ceil of node count and of mean degree.

    Coarse enough that a serving runtime's graphs hit configurations tuned
    on similar (not identical) shapes, fine enough that a 1k-node smoke
    sweep never decides the layout of a 10M-node graph."""
    nb = 1
    while nb < max(1, n):
        nb *= 2
    d = max(1, round(m / max(1, n)))
    db = 1
    while db < d:
        db *= 2
    return f"n{nb}_d{db}"


def current_backend(device: str | torch.device | None = None) -> str:
    """``"cuda"`` or ``"cpu"``: the backend of ``device``, or with none
    given, the process default (``"cuda"`` where torch sees a card)."""
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return kind


def _key(backend: str, layout: str, bucket: str) -> str:
    return f"{backend}|{layout}|{bucket}"


@dataclass
class TuningCache:
    """JSON-persisted map {backend|layout|bucket: TunedConfig}."""
    path: Path | None = None
    entries: dict[str, TunedConfig] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str | Path) -> "TuningCache":
        path = Path(path)
        data = json.loads(path.read_text())
        if data.get("schema") != SCHEMA_VERSION:
            raise ValueError(
                f"tuning cache {path}: schema {data.get('schema')!r} != "
                f"{SCHEMA_VERSION} — delete and re-sweep")
        entries = {k: TunedConfig(**v) for k, v in data["entries"].items()}
        return cls(path=path, entries=entries)

    def save(self, path: str | Path | None = None) -> Path:
        path = path or self.path
        if path is None:
            raise ValueError("TuningCache.save: no path")
        path = Path(path)
        payload = {"schema": SCHEMA_VERSION,
                   "entries": {k: dataclasses.asdict(v)
                               for k, v in sorted(self.entries.items())}}
        path.parent.mkdir(parents=True, exist_ok=True)
        # readers only ever see a complete file
        tmp = path.with_name(f".tmp_{path.name}.{os.getpid()}")
        tmp.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        os.replace(tmp, path)
        return path

    def lookup(self, backend: str, layout: str,
               bucket: str) -> TunedConfig | None:
        return self.entries.get(_key(backend, layout, bucket))

    def record(self, backend: str, layout: str, bucket: str,
               cfg: TunedConfig) -> None:
        self.entries[_key(backend, layout, bucket)] = cfg


# Active cache: process-global, set explicitly (serve.py --autotune-cache) or
# lazily from $REPRO_AUTOTUNE_CACHE. None = cold = the built-in defaults.
_ACTIVE: TuningCache | None = None
_ENV_CHECKED = False


def set_cache(cache: TuningCache | None) -> None:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = cache
    _ENV_CHECKED = True


def clear_cache() -> None:
    global _ACTIVE, _ENV_CHECKED
    _ACTIVE = None
    _ENV_CHECKED = False


def get_cache() -> TuningCache | None:
    global _ACTIVE, _ENV_CHECKED
    if not _ENV_CHECKED:
        _ENV_CHECKED = True
        env = os.environ.get(_ENV_CACHE)
        if env and Path(env).exists():
            _ACTIVE = TuningCache.load(env)
    return _ACTIVE


# ---------------------------------------------------------------------------
# device-time measurement


def _device_of(args) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def measure_compiled(fn, *args, repeats: int = 5):
    """Time steady-state calls of ``fn(*args)`` on the arguments' device.

    Returns ``(out, device_us, compile_us)``. One untimed first call covers
    the kernel's ``nvcc`` build at first use and the first allocations; its
    host time up to a device synchronisation is ``compile_us``. Then
    ``repeats`` calls are timed, on a card each between two CUDA events on
    the current stream, and ``device_us`` is the least of them. On the CPU
    the host clock times each call.

    ``fn`` takes its tensors positionally, already on the device, so that
    no host-to-device copy is timed."""
    if repeats < 1:
        raise ValueError("repeats must be >= 1")
    dev = _device_of(args)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    if cuda:
        torch.cuda.synchronize(dev)
    compile_us = (time.perf_counter() - t0) * 1e6
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            stream = torch.cuda.current_stream(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            out = fn(*args)
            end.record(stream)
            end.synchronize()
            us = start.elapsed_time(end) * 1e3
        else:
            t0 = time.perf_counter()
            out = fn(*args)
            us = (time.perf_counter() - t0) * 1e6
        best = min(best, us)
    return out, best, compile_us


# ---------------------------------------------------------------------------
# sweeps


def _sweep_record(cache: TuningCache | None, backend: str, layout: str,
                  bucket: str, best: TunedConfig) -> TunedConfig:
    if cache is not None:
        cache.record(backend, layout, bucket, best)
    return best


def sweep_sliced(graph, *, B: int = 8, pad_multiples=(8, 16, 32),
                 repeats: int = 3, device: str | torch.device = "cuda",
                 backend: str | None = None,
                 cache: TuningCache | None = None,
                 trials: list | None = None) -> TunedConfig:
    """Time the sliced push SpMM (K2 on a card) on ``graph`` at each pad
    multiple and record the fastest under layout ``sliced``. Each table
    and its fold structure are built once, outside the timed calls, on
    ``B`` seeded (B, n) float32 rows. ``trials`` (a list) receives every
    candidate's configuration in sweep order."""
    import numpy as np

    from .._device import resolve_device
    from .ell_spmv import sliced_fold
    from . import ops

    dev = resolve_device(device)
    backend = backend or current_backend(dev)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((B, graph.n), dtype=np.float32)).to(dev)

    best: TunedConfig | None = None
    for pm in pad_multiples:
        se = graph.ell_in_sliced(pad_multiple=pm)
        nbr = torch.from_numpy(se.neighbors).to(dev)
        msk = torch.from_numpy(se.mask).to(dev)
        wts = torch.from_numpy(se.weights).to(dev)
        rmap = torch.from_numpy(se.row_map).to(dev)
        fold = sliced_fold(rmap, graph.n, se.width)

        def push(a, b, c, d, e, fold=fold):
            return ops.ell_spmm_sliced(a, b, c, d, e, fold=fold)

        _, dev_us, comp_us = measure_compiled(push, nbr, msk, wts, rmap, x,
                                              repeats=repeats)
        cand = TunedConfig(pad_multiple=pm, width=se.width,
                           device_us=dev_us, compile_us=comp_us)
        if trials is not None:
            trials.append(cand)
        if best is None or cand.device_us < best.device_us:
            best = cand
    if best is None:
        raise ValueError("sweep_sliced needs at least one pad multiple")
    bucket = shape_bucket(graph.n, graph.m)
    return _sweep_record(cache, backend, "sliced", bucket, best)


def sweep_walk(graph, *, num_walks: int = 1 << 12, num_steps: int = 8,
               alpha: float = 0.2, repeats: int = 3,
               device: str | torch.device = "cuda",
               backend: str | None = None,
               cache: TuningCache | None = None) -> TunedConfig:
    """Time the live walk (``num_walks`` alpha-terminated lanes stepped
    ``num_steps`` times over the out-CSR on ``LaneStreams``) and record it
    under layout ``walk``: the numerator of the cost model's walk share."""
    import numpy as np

    from .._device import resolve_device
    from ..ppr.random_walk import LaneStreams, walk_endpoints

    dev = resolve_device(device)
    backend = backend or current_backend(dev)
    edge_dst = torch.from_numpy(graph.edge_dst).to(dev)
    offsets = torch.from_numpy(graph.out_offsets).to(dev)
    degree = torch.from_numpy(graph.out_degree).to(dev)
    rng = np.random.default_rng(0)
    starts = torch.from_numpy(rng.integers(0, graph.n, size=num_walks,
                                           dtype=np.int32)).to(dev)
    lanes = torch.arange(num_walks, dtype=torch.int32, device=dev)
    streams = LaneStreams(0)

    def walks(e, o, d, s, ln):
        return walk_endpoints(e, o, d, s, streams.steps(ln, num_steps),
                              alpha=alpha)

    _, dev_us, comp_us = measure_compiled(walks, edge_dst, offsets, degree,
                                          starts, lanes, repeats=repeats)
    cand = TunedConfig(device_us=dev_us, compile_us=comp_us)
    bucket = shape_bucket(graph.n, graph.m)
    return _sweep_record(cache, backend, "walk", bucket, cand)


# ---------------------------------------------------------------------------
# CLI — `python -m repro_torch.kernels.autotune --smoke --cache PATH`


def smoke_graph(n: int, seed: int):
    """The CLI's seeded power-law graph: each node but 0 draws a zipf(1.8)
    in-degree of distinct sources (the JAX package's CLI graph)."""
    import numpy as np

    from ..ppr.graph import Graph

    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for d in range(1, n):
        deg = int(min(n - 1, rng.zipf(1.8)))
        srcs.extend(rng.choice(n, size=deg, replace=False))
        dsts.extend([d] * deg)
    return Graph.from_edges(n, np.asarray(srcs), np.asarray(dsts))


def main(argv=None) -> int:
    import argparse

    from .._device import resolve_device

    parser = argparse.ArgumentParser(description="kernel autotune sweep")
    parser.add_argument("--cache", required=True,
                        help="tuning-cache JSON path (read-modify-write)")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny sweep: 512-node power-law graph, "
                             "2 pad multiples, 2 repeats")
    parser.add_argument("--expect-hit", action="store_true",
                        help="fail unless the cache already has an entry "
                             "for this sweep's key (the warm-read leg)")
    parser.add_argument("--n", type=int, default=4096)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    graph = smoke_graph(512 if args.smoke else args.n, args.seed)
    path = Path(args.cache)
    cache = TuningCache.load(path) if path.exists() else TuningCache(path=path)
    backend = current_backend(dev)
    bucket = shape_bucket(graph.n, graph.m)

    if args.expect_hit:
        hit = cache.lookup(backend, "sliced", bucket)
        if hit is None:
            print(f"autotune: MISS for {backend}|sliced|{bucket} in {path}")
            return 1
        print(f"autotune: HIT {backend}|sliced|{bucket} -> "
              f"block_n={hit.block_n} pad_multiple={hit.pad_multiple} "
              f"width={hit.width} device_us={hit.device_us:.1f}")
        return 0

    pad_multiples = (8, 16) if args.smoke else (8, 16, 32)
    repeats = 2 if args.smoke else 5
    best = sweep_sliced(graph, pad_multiples=pad_multiples, repeats=repeats,
                        device=dev, cache=cache)
    walk = sweep_walk(graph, repeats=repeats, device=dev, cache=cache)
    cache.save(path)
    print(f"autotune: {backend}|sliced|{bucket} -> block_n={best.block_n} "
          f"pad_multiple={best.pad_multiple} width={best.width} "
          f"device_us={best.device_us:.1f} compile_us={best.compile_us:.0f}")
    print(f"autotune: {backend}|walk|{bucket} -> "
          f"device_us={walk.device_us:.1f}")
    print(f"autotune: wrote {len(cache.entries)} entries to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
