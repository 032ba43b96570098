#!/usr/bin/env python3
"""The FORA paths end to end on one NVIDIA card, for comparing two trees
of the port on the same card:

    python3 tools/ppr_paths_ab.py OLD NEW NEW OLD            # paper paths
    python3 tools/ppr_paths_ab.py --pokec OLD NEW NEW OLD    # phase 8's

Each argument is the root of a checkout (``.`` for this one); each runs in
its own process, in the order given, and prints one JSON line for each of
two paths. The paper paths, on the full-size web-stanford stand-in at eps
= 0.5, one query a block: the live path (push through K2, live walks) and
the index path (a walk index of width 2^12 built once, seed 0: push
through K2, walks through K3); the shapes of phases 3 and 4 of
``chip_smoke.py``. With ``--pokec``, phase 8's dense graph at Pokec's
order: exact PPR (power iteration through K4, 94 steps a source) and
FORA at phase 8's push threshold (push through K1, live walks). For each
path, 64 FORA queries through ``ForaExecutor`` (or 4 sources of exact
PPR) give the mean and max time a query or source (host clock to a device
synchronisation), and then 8 queries (1 source) under ``torch.profiler``
give the wall time, the device time, the card's idle share, and the device
time and launches of each kernel of the port's own libraries, by name.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

QUERIES, PROFILED = 64, 8
INDEX_WIDTH = 1 << 12
# phase 8 of chip_smoke.py: Pokec's order and size (paper Table I), its
# push threshold, and the sources of exact PPR
POKEC_N, POKEC_M = 1_632_803, 30_622_564
POKEC_RMAX_SCALE = 1 / 32
EXACT_SOURCES = 4


def profiled(tree: str, path: str, run, count: int, mean_s: float,
             max_s: float) -> dict:
    """One JSON row: the mean and max seconds a query or source, measured
    before, then ``run()`` under ``torch.profiler``: wall and device time,
    the idle share, and each of the port's own kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
    own: dict[str, list[float]] = {}
    for e in events:
        if "anonymous namespace" in e.name:
            name = e.name.split("::")[1].split("(")[0].split("<")[0]
            own.setdefault(name, []).append(e.time_range.elapsed_us())
    return {"tree": tree, "path": path, "card": torch.cuda.get_device_name(0),
            "query_ms_mean": mean_s * 1e3, "query_ms_max": max_s * 1e3,
            "profiled_queries": count, "wall_ms": wall_ms,
            "device_ms": busy_ms, "idle": 1 - busy_ms / wall_ms,
            "kernels": {k: {"launches": len(v), "us_each": sum(v) / len(v)}
                        for k, v in sorted(own.items())}}


def leg(tree: str) -> list[dict]:
    sys.path.insert(0, f"{tree}/src")
    from repro_torch.index import WalkIndex
    from repro_torch.kernels import _build
    from repro_torch.ppr import ForaExecutor, ForaParams, PprWorkload, load

    _build.build([k for k in ("ell_spmm", "ell_spmm_sliced", "walk_gather")
                  if k in _build.SOURCES])
    graph = load("web-stanford", scale=1)
    params = ForaParams(epsilon=0.5)
    rp = params.resolve(graph)
    dg = graph.device("cuda")
    index = WalkIndex.build(dg, width=INDEX_WIDTH, alpha=rp.alpha,
                            walk_tail=rp.walk_tail, seed=0)
    rows = []
    for path, walk_index in (("live", None), ("index", index)):
        ex = ForaExecutor(workload=PprWorkload(graph, QUERIES, seed=1),
                          params=params, walk_index=walk_index,
                          device="cuda")
        ex.warmup()
        stats = ex(list(range(QUERIES)))
        rows.append(profiled(tree, path, lambda: ex(list(range(PROFILED))),
                             PROFILED, stats.t_avg, stats.t_max))
    return rows


def pokec_leg(tree: str) -> list[dict]:
    sys.path.insert(0, f"{tree}/src")
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.ppr import (ForaExecutor, ForaParams, PprWorkload,
                                 ppr_power_iteration, small_test_graph)

    _build.build([k for k in ("ell_spmm", "ell_spmv") if k in _build.SOURCES])
    graph = small_test_graph(n=POKEC_N, avg_deg=POKEC_M / POKEC_N, seed=0)
    graph.device("cuda")
    workload = PprWorkload(graph, QUERIES, seed=1)
    srcs = np.asarray(workload.sources[:EXACT_SOURCES])
    ppr_power_iteration(graph, srcs[:1], device="cuda")        # warm
    times = []
    for s in srcs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppr_power_iteration(graph, np.array([s]), device="cuda")
        times.append(time.perf_counter() - t0)
    rows = [profiled(tree, "exact", lambda: ppr_power_iteration(
        graph, srcs[:1], device="cuda"), 1, sum(times) / len(times),
        max(times))]
    ex = ForaExecutor(workload=workload,
                      params=ForaParams(epsilon=0.5,
                                        rmax_scale=POKEC_RMAX_SCALE),
                      device="cuda")
    ex.warmup()
    stats = ex(list(range(QUERIES)))
    rows.append(profiled(tree, "fora", lambda: ex(list(range(PROFILED))),
                         PROFILED, stats.t_avg, stats.t_max))
    return rows


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--leg":
        run = pokec_leg if argv[1] == "pokec" else leg
        for row in run(argv[2]):
            print(json.dumps(row), flush=True)
        return 0
    paths = "paper"
    if argv and argv[0] == "--pokec":
        paths, argv = "pokec", argv[1:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        rc = subprocess.run([sys.executable, __file__, "--leg", paths,
                             tree]).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
