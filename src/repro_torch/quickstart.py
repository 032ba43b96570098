"""Quickstart: the paper's loop on the port.

Builds a (scaled) Web-Stanford stand-in, checks FORA against exact PPR,
measures real FORA queries with :class:`ForaExecutor`, and lets D&A_REAL
(paper Alg. 2) decide how many cores the workload needs, beside the
Lemma-2 Hoeffding baseline. The deadline is doubled while it is
infeasible, as in paper §III-A. With ``--index-budget W`` the executor
pre-draws a walk index of W lanes per node and serves the covered walk
lanes from it (FORA+); the accuracy check then runs through that index.
``run(walk_index=...)`` serves from an index already built on the same
graph instead.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu] [--scale N]
        [--index-budget W]
"""

from __future__ import annotations

import argparse
from collections.abc import Callable

import numpy as np
import torch

from ._device import resolve_device
from .core import (DnaResult, InfeasibleDeadline, dna_real,
                   fraction_sample_size)
from .index import WalkIndex
from .ppr import (ForaExecutor, ForaParams, PprWorkload, fora, fora_fused,
                  load, ppr_power_iteration)

EPSILON = 0.5


def allocate(executor: ForaExecutor, num_queries: int, *,
             max_cores: int = 64) -> tuple[float, DnaResult]:
    """D&A_REAL over ``executor``'s first ``num_queries`` queries, one per
    call, with the quickstart's deadline rule: after a steady-state warmup
    over a probe of s = 25% of X queries, T = max(X t_avg / 4, 6 t_max,
    8 t_pre) of that probe, doubled while infeasible (paper §III-A), at
    most three tries. Returns (T, the D&A_REAL result)."""
    s = fraction_sample_size(num_queries, 0.25)
    executor(list(range(s)))                     # steady-state warmup
    probe = executor(list(range(s)))
    T = max(num_queries * probe.t_avg / 4, probe.t_max * 6, probe.t_pre * 8)
    for _ in range(3):
        try:
            return T, dna_real(num_queries, T, executor, max_cores=max_cores,
                               sample_size=s, scaling_factor=1.0)
        except InfeasibleDeadline:
            T *= 2.0
    raise RuntimeError("D&A_REAL found no feasible deadline in 3 tries")


def run(*, scale: int = 512, num_queries: int = 64, check_sources: int = 1,
        index_budget: int = 0, walk_index: WalkIndex | None = None,
        device: str | torch.device = "cuda",
        log: Callable[[str], None] = print) -> dict:
    """Run the quickstart loop, one query per call (the paper's mode), and
    return what it decided and measured."""
    dev = resolve_device(device)
    graph = load("web-stanford", scale=scale)
    workload = PprWorkload(graph=graph, num_queries=num_queries, seed=0)
    log(f"graph: {graph.summary()}")
    params = ForaParams(epsilon=EPSILON)
    executor = ForaExecutor(workload=workload, params=params,
                            index_budget=index_budget,
                            walk_index=walk_index, device=dev)

    # FORA vs exact PPR on the first sources
    srcs = workload.sources[:check_sources]
    exact = ppr_power_iteration(graph, srcs, alpha=params.alpha, device=dev)
    if executor.index_budget:
        executor.warmup()                # builds the walk index if none
        pi = fora_fused(executor.device_graph, srcs, params,
                        num_walks=executor.current_walk_budget(),
                        index=executor.walk_index, device=dev).pi
        pi = pi.cpu().numpy()
    else:
        pi = fora(graph, srcs, params, device=dev).pi
    mask = exact >= 1.0 / graph.n
    rel = float((np.abs(pi - exact)[mask] / exact[mask]).max())
    log(f"FORA max rel err: {rel:.3f} over {check_sources} sources "
        f"(guarantee eps={EPSILON})")

    # D&A_REAL: minimum cores to finish X queries in T seconds
    T, result = allocate(executor, num_queries)
    times = np.concatenate([result.sample_stats.times,
                            list(result.execution.per_query_times.values())])
    out = {
        "graph": graph.summary(), "device": str(dev),
        "layout": executor.device_graph.layout,
        "walk_lanes": executor.current_walk_budget(),
        "index_width": executor.index_budget,
        "index_coverage": executor.index_coverage,
        "fora_max_rel_err": rel, "deadline_s": T,
        "num_queries": num_queries, "cores": result.cores,
        "lemma2_cores": result.bounds.lemma2_cores,
        "reduction_vs_lemma2_pct": result.reduction_vs_lemma2_pct,
        "completion_time_s": result.completion_time,
        "accepted": result.accepted,
        "per_query_ms_mean": float(times.mean() * 1e3),
        "per_query_ms_max": float(times.max() * 1e3),
    }
    log(f"deadline T={T:.3f}s  queries X={num_queries}  "
        f"layout={out['layout']}  walk lanes={out['walk_lanes']}")
    log(f"D&A_REAL cores      : {result.cores}")
    log(f"Lemma-2 bound cores : {result.bounds.lemma2_cores}")
    log(f"reduction           : {result.reduction_vs_lemma2_pct:.1f}%")
    log(f"per-query ms        : mean {out['per_query_ms_mean']:.3f} "
        f"max {out['per_query_ms_max']:.3f}")
    log(f"completed in        : {result.completion_time:.3f}s "
        f"(accepted={result.accepted})")
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=512,
                    help="1/scale of the paper's node count")
    ap.add_argument("--index-budget", type=int, default=0,
                    help="walk index lanes per node (0: no index)")
    args = ap.parse_args(argv)
    run(scale=args.scale, index_budget=args.index_budget, device=args.device)


if __name__ == "__main__":
    main()
