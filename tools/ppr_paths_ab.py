#!/usr/bin/env python3
"""The FORA paper paths end to end on one NVIDIA card, for comparing two
trees of the port on the same card:

    python3 tools/ppr_paths_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (``.`` for this one); each runs in
its own process, in the order given, and prints one JSON line for each of
two paths on the full-size web-stanford stand-in at eps = 0.5, one query a
block: the live path (push through K2, live walks) and the index path (a
walk index of width 2^12 built once, seed 0: push through K2, walks
through K3). For each, 64 queries through ``ForaExecutor`` give the mean
and max time a query (host clock to a device synchronisation), and then 8
queries under ``torch.profiler`` give the wall time, the device time, the
card's idle share, and the device time and launches of each kernel of the
port's own libraries, by name. The shapes are phases 3 and 4 of
``chip_smoke.py``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

QUERIES, PROFILED = 64, 8
INDEX_WIDTH = 1 << 12


def leg(tree: str) -> list[dict]:
    sys.path.insert(0, f"{tree}/src")
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ex(list(range(PROFILED)))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.time_range.elapsed_us() for e in events) / 1e3
        own: dict[str, list[float]] = {}
        for e in events:
            if "anonymous namespace" in e.name:
                name = e.name.split("::")[1].split("(")[0].split("<")[0]
                own.setdefault(name, []).append(e.time_range.elapsed_us())
        rows.append({
            "tree": tree, "path": path, "card": torch.cuda.get_device_name(0),
            "query_ms_mean": stats.t_avg * 1e3,
            "query_ms_max": stats.t_max * 1e3,
            "profiled_queries": PROFILED, "wall_ms": wall_ms,
            "device_ms": busy_ms, "idle": 1 - busy_ms / wall_ms,
            "kernels": {k: {"launches": len(v), "us_each": sum(v) / len(v)}
                        for k, v in sorted(own.items())}})
    return rows


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--leg":
        for row in leg(argv[1]):
            print(json.dumps(row), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for tree in argv:
        rc = subprocess.run([sys.executable, __file__, "--leg", tree]
                            ).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
