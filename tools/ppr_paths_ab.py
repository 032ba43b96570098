#!/usr/bin/env python3
"""The FORA paths end to end on one NVIDIA card, for comparing two trees
of the port on the same card:

    python3 tools/ppr_paths_ab.py OLD NEW NEW OLD            # paper paths
    python3 tools/ppr_paths_ab.py --serving OLD NEW NEW OLD  # the last three
    python3 tools/ppr_paths_ab.py --pokec OLD NEW NEW OLD    # phase 8's

Each argument is the root of a checkout (``.`` for this one); each runs in
its own process, in the order given, and prints one JSON line for each of
two paths. The paper paths, on the full-size web-stanford stand-in at eps
= 0.5, one query a block: the live path (push through K2, live walks) and
the index path (a walk index of width 2^12 built once, seed 0: push
through K2, walks through K3); the shapes of phases 3 and 4 of
``chip_smoke.py``. Then three more rows on the same graph: the live
endpoint fold at the paper path's 2^20 lanes on the walk endpoints of its
first 8 queries, B = 1 and 8 (device µs a call by kernel under
``torch.profiler``, beside ``index_add_``); 256 queries through an 8-lane
``QueryEngine`` (phase 9's engine: ms a query, twice) and phase 11's PPR
daemon (``serve --daemon``: 8 Poisson jobs of 64 queries, 16 cores, a
cache of 256, no WAL) at a fixed deadline, for its core-seconds. With
``--serving``, only those three rows. With ``--pokec``, phase 8's dense
graph at Pokec's order: exact PPR (power iteration through K4, 94 steps a
source) and FORA at phase 8's push threshold (push through K1, live
walks). For each
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
FOLD_BS, FOLD_REPS = (1, 8), 20
ENGINE_QUERIES, ENGINE_LANES, ENGINE_SWEEPS = 256, 8, 4
# phase 11's daemon; its deadline fixed so that both trees serve the same
# jobs (phase 11 sets it from a measured t_avg, ~0.25 s on an H100)
DAEMON = ["--daemon", "--workload", "ppr", "--dataset", "web-stanford",
          "--scale", "1", "--num-jobs", "8", "--queries", "64",
          "--deadline", "0.25", "--arrival-rate", "8.0", "--max-cores", "16",
          "--cache-size", "256", "--device", "cuda"]
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


def leg(tree: str, serving_only: bool = False) -> list[dict]:
    sys.path.insert(0, f"{tree}/src")
    from repro_torch.index import WalkIndex
    from repro_torch.kernels import _build
    from repro_torch.ppr import ForaExecutor, ForaParams, PprWorkload, load

    _build.build([k for k in ("ell_spmm", "ell_spmm_sliced", "walk_gather")
                  if k in _build.SOURCES])
    graph = load("web-stanford", scale=1)
    params = ForaParams(epsilon=0.5)
    if serving_only:
        return serving_rows(tree, graph, params)
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
    return rows + serving_rows(tree, graph, params)


def kernel_us(fn, reps: int) -> dict[str, float]:
    """Device µs a call of ``fn`` by kernel name, under ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name
            if name.startswith("(anonymous namespace)::"):
                name = name[len("(anonymous namespace)::"):]
            name = name.split("(")[0].split("<")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return out


def serving_rows(tree: str, graph, params) -> list[dict]:
    """The fold at the paper path's shape, the engine and the daemon."""
    import torch

    from repro_torch.kernels import endpoint_fold
    from repro_torch.launch import serve
    from repro_torch.ppr import (ForaExecutor, PprWorkload, QueryDraws,
                                 forward_push, sample_walk_starts,
                                 walk_endpoints, walk_length_for_tail)
    from repro_torch.ppr.forward_push import one_hot_seeds
    from repro_torch.ppr.random_walk import lane_weights
    from repro_torch.serving import QueryEngine

    card = torch.cuda.get_device_name(0)
    ex = ForaExecutor(workload=PprWorkload(graph, ENGINE_QUERIES, seed=0),
                      params=params, device="cuda")
    ex.warmup()
    W, dg = ex.current_walk_budget(), ex.device_graph
    rp = params.resolve(dg)
    B = max(FOLD_BS)
    push = forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                        dg.out_degree,
                        one_hot_seeds(ex.workload.sources[:B], graph.n,
                                      dg.in_mask.device),
                        alpha=rp.alpha, rmax=rp.rmax, row_map=dg.in_row_map,
                        fold=dg.in_fold)
    draws = QueryDraws(0, range(B), W, dg.in_mask.device)
    starts, r_sum = sample_walk_starts(push.r.contiguous(),
                                       draws.start_uniforms())
    L = walk_length_for_tail(rp.alpha, rp.walk_tail)
    pos = walk_endpoints(dg.edge_dst, dg.out_offsets, dg.out_degree, starts,
                         (draws.step(t) for t in range(L)),
                         alpha=rp.alpha).contiguous()
    need = torch.clamp(torch.ceil(r_sum * rp.omega), min=1.0)
    w_eff = torch.clamp(torch.exp2(torch.ceil(torch.log2(need))), 1.0,
                        float(W)).to(torch.int32)
    weights = lane_weights(r_sum, W, w_eff).contiguous()
    fold = {}
    for b in FOLD_BS:
        p, w = pos[:b].contiguous(), weights[:b].contiguous()
        flat = (p.long() + torch.arange(b, device=p.device)[:, None]
                * graph.n).reshape(-1)
        split = kernel_us(lambda: endpoint_fold.endpoint_fold_cuda(
            p, w, graph.n), FOLD_REPS)
        lib = kernel_us(lambda: torch.zeros(
            b * graph.n, device=p.device).index_add_(0, flat, w.reshape(-1)),
            FOLD_REPS)
        fold[f"B={b}"] = {"us": sum(split.values()), "by_kernel": split,
                          "index_add_us": sum(lib.values())}
    rows = [{"tree": tree, "path": "fold", "card": card, "W": W,
             "n": graph.n, **fold}]

    runs = []
    for _ in range(2):
        eng = QueryEngine(ex, ENGINE_LANES, sweeps=ENGINE_SWEEPS)
        pending, done = list(range(ENGINE_QUERIES)), 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while pending or eng.busy:
            while pending and eng.free:
                eng.insert(pending.pop(0))
            eng.step()
            done += len(eng.harvest())
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / done * 1e3)
    rows.append({"tree": tree, "path": "engine", "card": card,
                 "queries": done, "steps": eng.steps, "query_ms": runs})

    args = serve.build_parser().parse_args(DAEMON)
    serve.prepare(args)
    rt, _, _ = serve._build_daemon_runtime(args)
    rt.submit_poisson(args.num_jobs, args.arrival_rate, queries=args.queries,
                      deadline=args.deadline, seed=args.seed)
    report = rt.run()
    measured = sum(j.effective_queries - j.late_hits for j in rt.jobs)
    rows.append({"tree": tree, "path": "daemon", "card": card,
                 "core_seconds": report.core_seconds,
                 "lemma2_core_seconds": sum(r.lemma2_core_seconds
                                            for r in report.records),
                 "measured_queries": measured,
                 "ms_a_measured_query": report.core_seconds / measured * 1e3,
                 "jobs_done": sum(r.state == "done" for r in report.records)})
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
        run = {"pokec": pokec_leg, "paper": leg,
               "serving": lambda tree: leg(tree, serving_only=True)}[argv[1]]
        for row in run(argv[2]):
            print(json.dumps(row), flush=True)
        return 0
    paths = "paper"
    if argv and argv[0] in ("--pokec", "--serving"):
        paths, argv = argv[0][2:], argv[1:]
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
