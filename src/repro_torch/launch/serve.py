"""Deadline-driven serving on the card: the D&A allocator over PPR queries
or a modelled serve step, one-shot or as a continuous daemon.

Given X independent requests and a deadline T, D&A_REAL decides how many
"cores" the job needs, slots the requests, executes them (PPR: FORA
queries through ``ForaExecutor`` on ``--device``, timed on the card), and
reports the Lemma-2 comparison. The core count is then mapped onto the
cards present (``plan_core_mesh``: cores = devices x lanes); ``--devices
k`` additionally runs every slot as a node-sharded mesh of k devices
(``ForaExecutor(devices=k)``).

    python -m repro_torch.launch.serve --workload ppr \\
        --dataset web-stanford --scale 1 --queries 512 --deadline 30 \\
        --max-cores 64 [--device cuda] [--ell-layout auto]

``--daemon`` switches to the continuous serving runtime: a seeded Poisson
arrival process (``--arrival-rate``, ``--num-jobs``) or a replayed JSON
trace (``--trace``) of deadline-tagged jobs shares one core pool, with
mid-flight replanning, degradation and deadline extension, a result cache
(``--cache-size``), a write-ahead log with snapshots (``--wal-dir``,
``--snapshot-every``, ``--recover``), seeded chaos (``--chaos``) and
streaming edge updates applied to a ``DynamicGraph`` on the card
(``--mutation-rate``):

    python -m repro_torch.launch.serve --daemon --workload ppr --scale 1 \\
        --num-jobs 8 --queries 64 --deadline 0.3 --cache-size 256 \\
        --wal-dir wal/ --snapshot-every 20 --autotune-cache tune.json

The daemon defaults to the continuous-batching lane engine (per-lane
occupancy accounting instead of slot grants); ``--no-engine`` restores the
slot-granted chunked path. Entry points run on ``--device cuda`` and raise
without a card unless ``--device cpu`` is given. ``--devices k`` makes
each slot's mesh the first k cards, refused above the cards present; on
``--device cpu`` it is k shards of the CPU. The JAX
package's ``--compilation-cache`` (XLA's persistent cache) has no
counterpart: the port's cold start is the ``nvcc`` build of its kernels,
and ``--warm-start`` defaults to whether those are already built.

A copy of ``repro.launch.serve`` over the port's modules.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from .._device import resolve_device


def _device_count(device: torch.device, devices: int = 1) -> int:
    """Devices present for the mesh mapping: the cards on CUDA; on the CPU
    the ``devices`` shards a slot's CPU mesh holds (the CPU repeats)."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return max(1, devices)


def _refuse_devices(args) -> None:
    if not args.fused:
        raise SystemExit("REJECTED: --no-fused: the port has only the "
                         "fused hot path (drop --no-fused)")
    present = _device_count(args.device, args.devices)
    if args.device.type == "cuda":
        present -= args.device.index      # a slot's cards start at --device
    if args.devices > present:
        raise SystemExit(f"REJECTED: --devices {args.devices} but only "
                         f"{present} device(s) present")


def _print_mesh_plan(cores: int, max_lanes: int, device: torch.device,
                     devices: int = 1) -> None:
    """cores -> devices x lanes on the hardware actually present (the paper
    stops at an integer; lanes time-multiplex a device when the demand
    exceeds the card count)."""
    from ..core import InfeasibleDeadline, plan_core_mesh

    try:
        plan = plan_core_mesh(cores, _device_count(device, devices),
                              max_lanes_per_device=max_lanes or None)
    except InfeasibleDeadline as e:
        raise SystemExit(f"REJECTED at mesh mapping: {e}") from e
    print(f"  cores->mesh        : {plan} on {device.type}")


def _fora_executor(args, workload):
    from ..ppr import ForaExecutor, ForaParams

    return ForaExecutor(workload=workload,
                        params=ForaParams(alpha=0.2, epsilon=args.epsilon),
                        block_size=args.block_size,
                        device=args.device,
                        ell_layout=args.ell_layout,
                        walk_safety=args.walk_safety,
                        devices=args.devices,
                        index_budget=args.index_budget)


def serve_ppr(args) -> None:
    from ..core import InfeasibleDeadline, dna_real, fraction_sample_size
    from ..ppr import PprWorkload, load
    from ..ppr.datasets import TABLE1

    _refuse_devices(args)
    graph = load(args.dataset, scale=args.scale)
    spec = TABLE1[args.dataset.lower()]
    workload = PprWorkload(graph=graph, num_queries=args.queries,
                           seed=args.seed)
    executor = _fora_executor(args, workload)
    s = fraction_sample_size(args.queries, args.sample_frac)
    # fold the mesh capacity into Alg. 2's C_max so an over-cap demand is
    # rejected by the up-front Lemma-1 admission, not after the workload ran
    max_cores = args.max_cores
    if args.max_lanes:
        max_cores = min(max_cores, _device_count(args.device, args.devices)
                        * args.max_lanes)
    try:
        res = dna_real(args.queries, args.deadline, executor,
                       max_cores=max_cores, sample_size=s,
                       scaling_factor=spec.scaling_factor_d)
    except InfeasibleDeadline as e:
        raise SystemExit(f"REJECTED: {e}") from e
    print(f"dataset={graph.name} X={args.queries} T={args.deadline}s "
          f"d={spec.scaling_factor_d}")
    print(f"  D&A_REAL cores     : {res.cores}")
    print(f"  Lemma-2 bound cores: {res.bounds.lemma2_cores}")
    print(f"  reduction          : {res.reduction_vs_lemma2_pct:.2f}%")
    print(f"  completion         : {res.completion_time:.3f}s "
          f"(accepted={res.accepted})")
    _print_mesh_plan(res.cores, args.max_lanes, args.device, args.devices)
    mesh = f"{args.devices}-chip shard" if args.devices > 1 else "single chip"
    print(f"  slot mesh          : {mesh}")


def serve_sim(args) -> None:
    """Generic serve-step workload with modelled times (LM decode / DIN)."""
    from ..core import (InfeasibleDeadline, SimulatedTimeSource, dna_real,
                        fraction_sample_size)

    src = SimulatedTimeSource(mean=args.step_time, cv=args.cv, seed=args.seed)
    try:
        res = dna_real(args.queries, args.deadline, lambda ids: src.measure(ids),
                       max_cores=args.max_cores,
                       sample_size=max(4, fraction_sample_size(
                           args.queries, args.sample_frac)),
                       scaling_factor=args.d)
    except InfeasibleDeadline as e:
        raise SystemExit(f"REJECTED: {e}") from e
    print(f"workload={args.workload} X={args.queries} T={args.deadline}s")
    print(f"  D&A_REAL cores     : {res.cores}")
    print(f"  Lemma-2 bound cores: {res.bounds.lemma2_cores}")
    print(f"  reduction          : {res.reduction_vs_lemma2_pct:.2f}%")
    # the grant becomes a mesh shape for the sim workloads too (was PPR-only)
    _print_mesh_plan(res.cores, args.max_lanes, args.device, args.devices)


def _daemon_factory(args):
    """Per-job executor factory for the daemon (PPR or simulated)."""
    from ..serving import SimJobExecutor

    if args.workload == "ppr":
        from ..ppr import PprWorkload, load

        _refuse_devices(args)
        graph = load(args.dataset, scale=args.scale)

        def factory(job_id: int, num_queries: int, seed: int):
            return _fora_executor(args, PprWorkload(
                graph=graph, num_queries=num_queries, seed=seed))
    else:
        def factory(job_id: int, num_queries: int, seed: int):
            return SimJobExecutor(mean=args.step_time, cv=args.cv, seed=seed)
    return factory


def _daemon_heartbeat(args, num_devices: int):
    """A WALL-clock HeartbeatMonitor when --heartbeat-timeout > 0 (the
    daemon's liveness path; the virtual-time simulation never needs one —
    tests inject their own clock)."""
    if args.heartbeat_timeout <= 0:
        return None
    import time

    from ..ft.elastic import HeartbeatMonitor
    return HeartbeatMonitor(num_devices, args.heartbeat_timeout,
                            clock=time.monotonic)


def _build_daemon_runtime(args):
    """Assemble pool/config/cache/controller (+ optional WAL) into a
    ServingRuntime; returns (runtime, factory, heartbeat)."""
    from ..ft.elastic import ElasticController
    from ..serving import (CorePool, ServingConfig, ServingRuntime,
                           WriteAheadLog)

    # --daemon defaults to the continuous-batching engine (DESIGN.md §14);
    # --no-engine restores the slot-granted chunked path
    engine = args.engine if args.engine is not None else True
    cfg = ServingConfig(scaling_factor=args.d, sample_frac=args.sample_frac,
                        graph_version=args.graph_version,
                        stragglers=args.stragglers,
                        engine=engine, lane_pool=args.lane_pool,
                        cold_compile_s=getattr(args, "cold_compile", 0.0),
                        warm_start=bool(getattr(args, "warm_start", False)))
    pool = CorePool.of(args.max_cores,
                       lanes_per_device=max(1, args.max_lanes or 1),
                       spares_fraction=args.spares_fraction)
    cache = None
    if args.cache_size > 0:
        from ..index import ResultCache

        cache = ResultCache(capacity=args.cache_size,
                            ttl=args.cache_ttl or None,
                            ttl_update_factor=args.cache_ttl_factor or None)
    factory = _daemon_factory(args)
    heartbeat = _daemon_heartbeat(args, args.max_cores)
    from ..serving.metrics import open_sink
    controller = ElasticController(allocator=pool.allocator,
                                   heartbeat=heartbeat,
                                   metrics=open_sink(args.metrics))
    # an active tuning cache seeds the cost model's walk share from measured
    # kernel device times on this device's backend; cold cache -> the
    # default model
    from ..core.estimator import CacheAwareCostModel
    from ..kernels import autotune

    model = CacheAwareCostModel.seeded_from_tuning(
        autotune.get_cache(), backend=autotune.current_backend(args.device),
        index_coverage=cfg.index_coverage)
    rt = ServingRuntime(pool, factory, cfg, controller=controller,
                        cache=cache, cost_model=model)
    if args.wal_dir:
        rt.attach_wal(WriteAheadLog(args.wal_dir),
                      snapshot_every=args.snapshot_every,
                      compact_keep=args.wal_compact_keep)
    if args.mutation_rate > 0:
        _wire_mutations(args, rt)
    return rt, factory, heartbeat


def _wire_mutations(args, rt) -> None:
    """Attach the streaming-update arm (DESIGN.md §16): seeded mutation
    arrivals as heap events, WAL-logged and replay-deterministic. For the
    PPR workload the events apply REAL delta batches to a
    :class:`repro_torch.dyn.DynamicGraph` on ``--device`` over the serving
    dataset — at the
    event-loop boundary, which IS the engine's safe step boundary (no
    device step is ever in flight between heap events) — and the affected
    sets flow from the actual residency diff; the sim workloads model the
    affected-set sizes instead. ``rt.graph_version`` then advances from the
    mutation log, not from the static ``--graph-version`` flag."""
    graph_n = 0
    on_mutate = None
    if args.workload == "ppr":
        from ..dyn import DynamicGraph, MutationLog
        from ..ppr import load

        graph = load(args.dataset, scale=args.scale)
        dyn = DynamicGraph(graph, base_version=args.graph_version,
                           device=args.device)
        mlog = MutationLog.seeded(graph, args.mutations,
                                  seed=args.seed + 1,
                                  batch_edges=args.mutation_edges,
                                  base_version=args.graph_version)
        graph_n = graph.n

        def on_mutate(ordinal: int, t: float):
            return dyn.apply(mlog[ordinal])

        rt.dynamic_graph = dyn        # operator/debug handle
    else:
        graph_n = args.queries        # sim: model the structure size
    rt.schedule_mutations(args.mutations, args.mutation_rate,
                          seed=args.seed + 1, graph_n=graph_n,
                          affected_frac=args.affected_frac,
                          refresh_budget=args.refresh_budget,
                          node_cost=args.step_time,
                          on_mutate=on_mutate)


def _lint_self(rules: tuple[str, ...] = ("replay-determinism",)):
    """Run dnalint (tools/analysis) over the WAL-logged modules of this
    package (``serving``, ``ft``, ``checkpoint``, ``dyn``); returns the
    findings list. Used by ``--lint-self`` to refuse attaching a WAL to a
    binary whose replay determinism is statically broken. Returns None
    when the tools package is not there (installed without the repo
    checkout)."""
    pkg_root = Path(__file__).resolve().parents[1]   # .../src/repro_torch
    repo_root = pkg_root.parent.parent
    if not (repo_root / "tools" / "analysis").is_dir():
        return None
    if str(repo_root) not in sys.path:
        sys.path.insert(0, str(repo_root))
    from tools.analysis import run_analysis

    paths = [str(pkg_root / d) for d in ("serving", "ft", "checkpoint",
                                         "dyn")
             if (pkg_root / d).is_dir()]
    report = run_analysis(paths, rules=list(rules), root=repo_root)
    return report.findings


def _print_occupancy(rt, width: int = 8) -> None:
    """Lane-occupancy time-series from the controller's engine samples,
    downsampled to ~``width`` evenly spaced rows (DESIGN.md §14 — the
    operator's view of continuous-lane utilisation)."""
    occ = getattr(rt.controller, "occupancy_events", None)
    if not occ:
        return
    print(f"  lane occupancy     : {len(occ)} samples")
    step = max(1, len(occ) // width)
    picks = list(occ[::step])
    if picks[-1] is not occ[-1]:
        picks.append(occ[-1])
    for s in picks:
        bar = "#" * round(24 * s["busy"] / max(1, s["lanes"]))
        print(f"    t={s['t']:8.3f}s busy={s['busy']:>4}/{s['lanes']} "
              f"pending={s['pending']:>5} |{bar:<24}|")


def serve_daemon(args) -> None:
    """Continuous serving runtime: Poisson or trace-replayed arrivals over a
    shared core pool with mid-flight replanning (DESIGN.md §10), optionally
    cache-aware (DESIGN.md §11): ``--cache-size`` attaches a ResultCache
    consulted before admission, ``--index-budget`` pre-draws a WalkIndex per
    PPR executor, ``--record-trace`` captures the completed jobs in the
    format ``--trace`` replays. Durability (DESIGN.md §12): ``--wal-dir``
    logs every input and event (``--snapshot-every`` full-state
    checkpoints), ``--recover`` resumes a crashed daemon from that log, and
    ``--chaos SPEC`` torments the run with seeded failures/slowdowns/
    crashes."""
    from ..serving import ServingRuntime

    if args.lint_self:
        findings = _lint_self()
        if findings is None:
            print("lint-self: tools/analysis not available "
                  "(installed without the repo checkout)")
        elif findings:
            for f in findings:
                print(f.render())
            if args.wal_dir:
                raise SystemExit(
                    f"lint-self: {len(findings)} replay-determinism "
                    f"finding(s) in the WAL-logged modules — refusing to "
                    f"attach --wal-dir (recovery could not replay this "
                    f"binary deterministically)")
            print(f"lint-self: {len(findings)} finding(s) (no --wal-dir, "
                  f"continuing)")
        else:
            print("lint-self: WAL-logged modules are replay-deterministic")

    if args.recover:
        if not args.wal_dir:
            raise SystemExit("--recover requires --wal-dir")
        factory = _daemon_factory(args)
        heartbeat = _daemon_heartbeat(args, args.max_cores)
        rt, info = ServingRuntime.recover(args.wal_dir, factory,
                                          heartbeat=heartbeat)
        from ..serving.metrics import open_sink
        rt.controller.metrics = open_sink(args.metrics)
        src = (f"recovered from {args.wal_dir} (snapshot step "
               f"{info.snapshot_step}, {info.replayed_events} of "
               f"{info.logged_events} logged events to replay)")
        report = rt.run()
        print(f"daemon workload={args.workload} {src}")
        print(f"  replayed events    : {info.replayed_events}")
        print(f"  re-billed preprocess core-seconds: "
              f"{rt.replay_pre_core_s:.3f}")
    else:
        rt, factory, heartbeat = _build_daemon_runtime(args)
        if args.trace:
            with open(args.trace) as f:
                jobs = rt.submit_trace(json.load(f))
            src = f"trace {args.trace} ({len(jobs)} jobs)"
        else:
            rt.submit_poisson(args.num_jobs, args.arrival_rate,
                              queries=args.queries, deadline=args.deadline,
                              seed=args.seed)
            src = (f"poisson rate={args.arrival_rate}/s x {args.num_jobs} "
                   f"jobs (X={args.queries}, T={args.deadline}s)")
        if args.chaos:
            from ..ft.chaos import ChaosSchedule, ChaosSpec, drive_with_crashes

            spec = ChaosSpec.parse(args.chaos)
            schedule = ChaosSchedule.from_spec(spec, args.max_cores)
            schedule.apply(rt)
            src += (f" chaos[{args.chaos}]")
            if schedule.crashes:
                if not args.wal_dir:
                    raise SystemExit("--chaos with crashes requires "
                                     "--wal-dir")
                report, infos, rt = drive_with_crashes(
                    rt, args.wal_dir, factory, schedule.crashes,
                    heartbeat=heartbeat)
                src += f" ({len(infos)} recoveries)"
            else:
                report = rt.run()
        else:
            report = rt.run()
        print(f"daemon workload={args.workload} {src}")
    print_daemon_report(rt, report)
    if args.record_trace:
        records = rt.trace_records()
        with open(args.record_trace, "w") as f:
            json.dump(records, f, indent=2)
            f.write("\n")
        print(f"  trace              : {len(records)} completed jobs -> "
              f"{args.record_trace}")


def print_daemon_report(rt, report) -> None:
    """The daemon's report lines: pool, summary, saving against static
    Lemma 2, cache, mutations, lane occupancy and metrics. Read off the
    runtime given, which after a chaos crash is the recovered one (pool
    and cache included)."""
    pool, cache = rt.pool, rt.cache
    print(f"  pool               : {pool.total} cores "
          f"({pool.allocator.capacity} devices x {pool.lanes_per_device} "
          f"lanes)")
    print(f"  {report.summary()}")
    if report.lemma2_core_seconds:
        saved = 100.0 * (1.0 - report.core_seconds
                         / report.lemma2_core_seconds)
        print(f"  core-hours saved vs static Lemma-2: {saved:.1f}%")
    if cache is not None:
        print(f"  cache              : {len(cache)} entries "
              f"hit_rate={cache.hit_rate:.3f} "
              f"saved_core_s={cache.stats.saved_cost:.1f}")
        if cache.update_cadence is not None:
            print(f"  update cadence     : {cache.update_cadence:.3f}s "
                  f"(auto-TTL={cache.ttl})")
    if rt.mutations_applied:
        ratio = (100.0 * rt.refresh_core_s / rt.rebuild_core_s
                 if rt.rebuild_core_s else 0.0)
        print(f"  mutations          : {rt.mutations_applied} applied "
              f"(graph v{rt.graph_version}) "
              f"pending_refresh={rt.pending_refresh} "
              f"refresh/rebuild core-s={ratio:.1f}%")
    _print_occupancy(rt)
    metrics = getattr(rt.controller, "metrics", None)
    if metrics is not None:
        rows = getattr(metrics, "rows_emitted", None)
        if rows:
            print(f"  metrics            : {rows} rows -> "
                  f"{getattr(metrics, 'path', 'stdout')}")
        metrics.close()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=["ppr", "lm-decode", "din-serve"],
                    default="ppr")
    ap.add_argument("--dataset", default="web-stanford")
    ap.add_argument("--scale", type=int, default=256)
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--deadline", type=float, default=30.0)
    ap.add_argument("--max-cores", type=int, default=64)
    ap.add_argument("--epsilon", type=float, default=0.5)
    ap.add_argument("--block-size", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--fused", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="fused device-resident hot path; the port has no "
                         "other, so --no-fused is refused")
    ap.add_argument("--ell-layout", default="auto",
                    choices=["auto", "dense", "sliced"],
                    help="push-table layout (DESIGN.md §8)")
    ap.add_argument("--walk-safety", type=float, default=1.0,
                    help="walk-budget calibration headroom factor")
    ap.add_argument("--devices", type=int, default=1,
                    help="devices per slot: >1 runs every slot as a "
                         "node-sharded mesh of that many cards (of CPU "
                         "shards with --device cpu)")
    ap.add_argument("--max-lanes", type=int, default=0,
                    help="admission cap on query lanes per device for the "
                         "cores->mesh mapping (0 = uncapped)")
    ap.add_argument("--step-time", type=float, default=0.05)
    ap.add_argument("--cv", type=float, default=0.3)
    ap.add_argument("--d", type=float, default=0.9)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample-frac", type=float, default=0.05,
                    help="preprocessing sample fraction (paper §IV-A uses "
                         "5%%; was hardcoded)")
    ap.add_argument("--daemon", action="store_true",
                    help="continuous serving runtime (DESIGN.md §10) "
                         "instead of the one-shot pipeline")
    ap.add_argument("--engine", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="daemon: continuous-batching lane engine "
                         "(DESIGN.md §14) — the default; --no-engine "
                         "restores the slot-granted chunked path")
    ap.add_argument("--lane-pool", type=int, default=0,
                    help="daemon: engine lane-pool size (0 = one lane per "
                         "pool core)")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="daemon: Poisson arrival rate (jobs/second)")
    ap.add_argument("--num-jobs", type=int, default=16,
                    help="daemon: number of jobs to serve")
    ap.add_argument("--trace", default="",
                    help="daemon: replay a JSON trace "
                         '[{"at":,"queries":,"deadline":}, ...] instead of '
                         "Poisson arrivals")
    ap.add_argument("--record-trace", default="", metavar="PATH",
                    help="daemon: write completed-job arrival/deadline/"
                         "source records to PATH in the format --trace "
                         "consumes (capture -> replay -> identical "
                         "admission decisions)")
    ap.add_argument("--index-budget", type=int, default=0,
                    help="pre-drawn walk-endpoint lanes per node (FORA+ "
                         "walk index, DESIGN.md §11); 0 = off")
    ap.add_argument("--cache-size", type=int, default=0,
                    help="daemon: result-cache capacity in entries "
                         "(consulted before admission; 0 = off)")
    ap.add_argument("--cache-ttl", type=float, default=0.0,
                    help="daemon: result-cache TTL in virtual seconds "
                         "(0 = no expiry)")
    ap.add_argument("--graph-version", type=int, default=0,
                    help="BASE structure version for cache keys; with "
                         "--mutation-rate the live version advances from "
                         "the mutation log instead of this static tag")
    ap.add_argument("--mutation-rate", type=float, default=0.0,
                    help="daemon: streaming edge-update arrival rate "
                         "(batches/second, DESIGN.md §16); 0 = static "
                         "graph. PPR workload applies real device-side "
                         "delta batches; sim workloads model the churn")
    ap.add_argument("--mutations", type=int, default=8,
                    help="daemon: number of mutation batches to stream")
    ap.add_argument("--mutation-edges", type=int, default=8,
                    help="daemon: edges added/removed per mutation batch")
    ap.add_argument("--affected-frac", type=float, default=0.05,
                    help="daemon: modelled affected-source fraction per "
                         "batch for sim workloads (PPR uses the real "
                         "residency diff)")
    ap.add_argument("--refresh-budget", type=int, default=0,
                    help="daemon: walk-index rows refreshed per mutation "
                         "batch, hottest first (0 = refresh everything "
                         "immediately)")
    ap.add_argument("--cache-ttl-factor", type=float, default=0.0,
                    help="daemon: auto-tune the cache TTL to this multiple "
                         "of the observed update cadence (0 = static TTL)")
    ap.add_argument("--metrics", default="", metavar="PATH",
                    help="daemon: structured metrics sink (DESIGN.md §16) "
                         "— JSONL rows of occupancy/cache/mutation/"
                         "straggler telemetry; '-' = stdout, empty = off")
    ap.add_argument("--wal-dir", default="",
                    help="daemon: write-ahead log directory (DESIGN.md "
                         "§12) — every input and event is logged so a "
                         "crashed daemon recovers without losing an "
                         "accepted job")
    ap.add_argument("--snapshot-every", type=int, default=50,
                    help="daemon: full-state snapshot cadence in processed "
                         "events (0 = log-only; recovery then replays from "
                         "event zero)")
    ap.add_argument("--wal-compact-keep", type=int, default=0,
                    help="daemon: after each snapshot, retain this many "
                         "restorable snapshots and truncate the WAL prefix "
                         "they cover (0 = never compact; the log grows "
                         "unbounded but replay-from-zero stays possible)")
    ap.add_argument("--lint-self", action="store_true",
                    help="daemon: run the dnalint replay-determinism rule "
                         "over the WAL-logged serving modules before "
                         "starting; with --wal-dir, findings refuse "
                         "attachment")
    ap.add_argument("--recover", action="store_true",
                    help="daemon: resume from --wal-dir instead of "
                         "submitting new work; prints the replayed-event "
                         "count and the re-billed preprocess core-seconds")
    ap.add_argument("--chaos", default="", metavar="SPEC",
                    help="daemon: seeded chaos schedule, e.g. "
                         "'seed=7,failures=1,slowdowns=2,crashes=2,"
                         "horizon=18' — device failures, lane slowdowns "
                         "and process crashes (crashes need --wal-dir)")
    ap.add_argument("--heartbeat-timeout", type=float, default=0.0,
                    help="daemon: declare a device failed after this many "
                         "WALL-clock seconds without a heartbeat (0 = no "
                         "heartbeat monitor)")
    ap.add_argument("--stragglers", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="daemon: speculative re-issue of straggling lanes "
                         "on pool spares at slot boundaries (needs "
                         "--spares-fraction > 0 to ever fire)")
    ap.add_argument("--spares-fraction", type=float, default=0.0,
                    help="daemon: fraction of healthy devices held back "
                         "as re-issue spares (paper's fluctuation margin)")
    ap.add_argument("--autotune-cache", default="", metavar="PATH",
                    help="kernel tuning-cache JSON from "
                         "`python -m repro_torch.kernels.autotune` — "
                         "consulted at residency build for the sliced "
                         "table's pad_multiple/width and to seed the cost "
                         "model's walk share")
    ap.add_argument("--cold-compile", type=float, default=0.0,
                    help="daemon: compile surcharge (seconds) billed into "
                         "the first admitted job's c-core preprocess "
                         "reservation — waived under --warm-start")
    ap.add_argument("--warm-start", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="treat the kernel build as done (waive "
                         "--cold-compile); default auto-detects: warm iff "
                         "every CUDA kernel library of the port is built")
    return ap


def prepare(args) -> None:
    """Settle the parsed arguments in place before a serve: the device
    (``--device cuda`` raises without a card), the warm-start default (the
    port's kernel libraries already built) and the active tuning cache."""
    args.device = resolve_device(args.device)
    if args.warm_start is None:
        from ..kernels import _build

        args.warm_start = _build.built()
    if args.autotune_cache:
        from ..kernels import autotune

        if Path(args.autotune_cache).exists():
            autotune.set_cache(autotune.TuningCache.load(args.autotune_cache))
        else:
            print(f"autotune cache {args.autotune_cache} not found — "
                  "running with cold defaults")


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    prepare(args)
    if args.daemon:
        serve_daemon(args)
    elif args.workload == "ppr":
        serve_ppr(args)
    else:
        serve_sim(args)


if __name__ == "__main__":
    main()
