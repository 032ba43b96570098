#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            # one card, no arguments

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's main path, in phases:

1. every kernel against its plain PyTorch version on the card, on the
   push tables of the paths (K1: ``small_test_graph(n=2000)``, K2: the
   full-size Web-Stanford stand-in) at the batch widths the paths launch
   them with and at 8 and 64, with and without the fused threshold, and on
   the sliced table's edge cases. The plain version runs in float64 on the
   same float32 inputs; an output passes where
   ``|out - want| <= RTOL * |want| + ATOL_FRAC * max|want|``, and the
   printed ratio is the largest ``|out - want|`` over that limit. The
   check must also refuse two broken folds;
2. the dense path: ``fora_fused`` on ``small_test_graph(n=2000)``;
3. the paper path at real size: 256 FORA queries on the full-size
   Web-Stanford stand-in through ``ForaExecutor`` into ``dna_real``, with
   FORA checked against power iteration on three sources;
4. kernel times at the paths' shapes beside their bound, their plain
   version's time and one PyTorch library call's. Each time is device
   time: the card's kernel durations under ``torch.profiler``, summed and
   divided by the calls. The host's pace (CUDA events around back-to-back
   calls) is printed beside it.

The launch counts of each path are zeroed just before it and read just
after. Any failed phase exits non-zero; without a card, or without the
port's sources next to this script, it exits non-zero before any result.
The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
FP32_FLOPS_PER_S = 67e12           # H100 SXM float32 outside tensor cores
# kernel against its float64 plain version: every output within RTOL of
# the exact value, plus ATOL_FRAC of the output's largest entry. Both
# kernels sum nonnegative terms along chains of at most ~100 float32 adds
# (K2: 8 cells, two fold levels of 32, a root of at most 32), so their
# relative error stays under 100 * 2**-24 = 6e-6.
RTOL = 1e-5
ATOL_FRAC = 1e-6
LIBRARY_RTOL = 1e-3      # torch.sparse.mm's summation order is its own
DENSE_SOURCES = (0, 7, 42)     # phase 2's fora_fused sources
CHECK_SOURCES = 3              # phase 3's FORA check (a B=3 push)
REPLACES = {"ell_spmm": "src/repro/kernels/ell_spmv.py:141",
            "ell_spmm_sliced": "src/repro/kernels/ell_spmv.py:234"}
SOURCE = "src/repro_torch/kernels/csrc/ell_spmm.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def events_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` back-to-back
    calls, by CUDA events, after two warm calls. For a short kernel this is
    the host's launch pace, not the kernel's time."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds per call of ``fn``: the durations of every
    kernel and copy it ran on the card over ``reps`` calls, as
    ``torch.profiler`` records them, summed and divided by ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(sum(ts) for ts in device_us(prof).values())
    if busy_us <= 0:
        raise SmokeFailure("torch.profiler recorded no device time")
    return busy_us / reps / 1e3


def device_us(prof) -> dict[str, list[float]]:
    """Microseconds of each device event in a finished profile, by name."""
    from torch.autograd import DeviceType

    by_name: dict[str, list[float]] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    return by_name


def err_ratio(out, want, rtol: float) -> tuple[float, float]:
    """(max |out - want|, the largest |out - want| over its limit
    ``rtol * |want| + ATOL_FRAC * max|want|``); want is float64."""
    import torch

    diff = (out.double() - want).abs()
    limit = rtol * want.abs() + ATOL_FRAC * float(want.abs().max())
    ratio = diff / limit.clamp_min(torch.finfo(torch.float64).tiny)
    return float(diff.max()), float(ratio.max())


def f64(*ts):
    return [None if t is None else t.double() for t in ts]


def mass_rows(gen, B: int, n: int, device):
    """(B, n) float32 rows that each sum to 1 — the shape of a residual."""
    import torch

    u = torch.rand((B, n), generator=gen, device=device) ** 3
    return u / u.sum(dim=1, keepdim=True)


def spmm_cost(nnz: int, n: int, B: int, rows: int, fused: bool,
              sliced: bool) -> tuple[float, str]:
    """Least time (ms) for one SpMM on this input: every nonzero cell read
    once (int32 id + bool mask + f32 weight), x and the output once, the
    threshold and row_map once; two flops per nonzero and batch column."""
    nbytes = nnz * 9 + 2 * n * B * 4 + (n * 4 if fused else 0) \
        + (rows * 4 if sliced else 0)
    flops = 2 * nnz * B
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


def profile_queries(graph, count: int) -> None:
    """Where a paper-path query's time goes: ``count`` measured queries
    under ``torch.profiler``, device time summed by kernel name, and the
    share of the wall time the card was idle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ppr import ForaExecutor, ForaParams, PprWorkload

    ex = ForaExecutor(workload=PprWorkload(graph, count, seed=1),
                      params=ForaParams(epsilon=0.5), device="cuda")
    ex.warmup()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stats = ex(list(range(count)))
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = device_us(prof)
    busy = sum(sum(v) for v in by_name.values())
    print(f"  profile: {count} queries, wall {wall_us / 1e3:.2f} ms, "
          f"per query {stats.t_avg * 1e3:.3f} ms, device busy "
          f"{busy / 1e3:.2f} ms, idle share "
          f"{(1 - busy / wall_us) if wall_us else float('nan'):.3f}")
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:12]
    for name, ts in top:
        print(f"    {sum(ts) / 1e3:9.3f} ms {len(ts):7d}x "
              f"{sum(ts) / len(ts):8.2f} us  {name[:90]}")


def main() -> int:
    # the port must not need JAX or the JAX package
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {ROOT / 'src'}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.kernels import _build, ell_spmv, ref
    from repro_torch.ppr import (ForaExecutor, ForaParams, fora_fused, load,
                                 ppr_power_iteration, small_test_graph)
    from repro_torch.ppr.graph import Graph, _resolve_push_layout
    from repro_torch import quickstart

    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f}s")
    for name in libs:
        for line in _build.log_path(name).read_text().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator(device=dev).manual_seed(0)
    stats = {k: {"max_abs_err": 0.0, "ratio": 0.0} for k in REPLACES}
    small = small_test_graph(n=2000)
    web = load("web-stanford", scale=1)
    print(f"graphs: {small.summary()} | {web.summary()} "
          f"max_in_degree={web.max_in_degree}")
    # the batch widths the paths launch each kernel with: K1 at the dense
    # path's sources, K2 at the executor's block and the FORA check's batch
    path_B = {"ell_spmm": {len(DENSE_SOURCES)},
              "ell_spmm_sliced": {ForaExecutor.block_size, CHECK_SOURCES}}

    def thr_of(graph):
        return torch.from_numpy(
            (ForaParams(epsilon=0.5).resolve(graph).rmax
             * np.maximum(graph.out_degree, 1)).astype(np.float32)).to(dev)

    def table(graph, layout):
        lay = _resolve_push_layout(graph, layout)
        t = [torch.from_numpy(a).to(dev) for a in
             (lay.neighbors, lay.mask, lay.weights)]
        rm = None if lay.row_map is None else \
            torch.from_numpy(lay.row_map).to(dev)
        return t, rm, thr_of(graph)

    def sliced(graph, width, pad_multiple=8):
        sl = graph.ell_in_sliced(width=width, pad_multiple=pad_multiple)
        t = [torch.from_numpy(a).to(dev) for a in
             (sl.neighbors, sl.mask, sl.weights)]
        return t, torch.from_numpy(sl.row_map).to(dev), thr_of(graph)

    def plain(nbr, msk, w, rm, x, thr):
        """The kernel's plain version, or None for rm on a dense table."""
        if rm is None:
            return ref.ell_spmm_ref(nbr, msk, x, w, thr)
        return ref.ell_spmm_sliced_ref(nbr, msk, x, w, thr, rm)

    dense_t, _, dense_thr = table(small, "auto")
    check(dense_t[0].shape[0] == small.n, "small_test_graph must be dense")
    web_t, web_rm, web_thr = table(web, "auto")
    check(web_rm is not None, "web-stanford must take the sliced table")
    print(f"tables: dense {tuple(dense_t[0].shape)}, web-stanford sliced "
          f"{tuple(web_t[0].shape)} ({web_t[0].numel() * 9 / 2**20:.1f} MiB)")

    def compare(name, kernel, tables, rm, x, thr, label):
        """Hold one kernel launch against the float64 plain version."""
        nbr, msk, w = tables
        torch.cuda.synchronize()
        out = kernel()
        torch.cuda.synchronize()
        want = plain(nbr, msk, *f64(w), rm, *f64(x, thr))
        check(out.shape == want.shape, f"{name} {label}: shape "
              f"{tuple(out.shape)} != {tuple(want.shape)}")
        check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite")
        err, ratio = err_ratio(out, want, RTOL)
        st = stats[name]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["ratio"] = max(st["ratio"], ratio)
        check(bool(torch.equal(out, kernel())),
              f"{name} {label}: a second launch gave other bits")
        ok = ratio <= 1.0
        print(f"  {name:16s} {label:34s} max_abs_err={err:.3e} "
              f"max|want|={float(want.abs().max()):.3e} "
              f"err/limit={ratio:.4f} {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label}: error {err} above rtol {RTOL} "
              f"+ {ATOL_FRAC} * max|want| (ratio {ratio})")

    def must_refuse(name, tables, rm, broken_mask, zero_rows, label):
        """The tolerance must be tight enough to see a broken kernel: the
        plain version with ``broken_mask`` for the table's mask, or with
        the real rows ``zero_rows`` zeroed, must fail the check."""
        nbr, msk, w = tables
        x = mass_rows(gen, 1, int(zero_rows.shape[0]), dev)
        want = plain(nbr, msk, w.double(), rm, x.double(), None)
        broken = plain(nbr, broken_mask, w, rm, x, None)
        broken = broken.masked_fill(zero_rows[None], 0.0)
        _, ratio = err_ratio(broken, want, RTOL)
        print(f"  {name:16s} {'broken: ' + label:34s} err/limit="
              f"{ratio:.4g} {'refused' if ratio > 1 else 'PASSED'}")
        check(ratio > 1.0, f"{name}: the check passes a broken kernel "
              f"({label})")

    print("phase 1: kernels against their plain versions on the card "
          f"(rtol {RTOL}, atol {ATOL_FRAC} * max|want|, float64 plain)")
    for B in sorted(path_B["ell_spmm"] | {1, 8, 33, 64}):
        for fused in (False, True):
            x = mass_rows(gen, B, small.n, dev)
            thr = dense_thr if fused else None
            compare("ell_spmm",
                    lambda: ell_spmv.ell_spmm_cuda(*dense_t, x, thr),
                    dense_t, None, x, thr, f"small n=2000 B={B} thr={fused}")
    # a kernel that loses one neighbour of every row
    no_rows = torch.zeros(small.n, dtype=torch.bool, device=dev)
    short = dense_t[1].clone()
    short[:, 0] = False
    must_refuse("ell_spmm", dense_t, None, short, no_rows,
                "first cell of each row dropped")
    for B in sorted(path_B["ell_spmm_sliced"] | {1, 8, 64}):
        for fused in (False, True):
            x = mass_rows(gen, B, web.n, dev)
            thr = web_thr if fused else None
            compare("ell_spmm_sliced",
                    lambda: ell_spmv.ell_spmm_sliced_cuda(*web_t, web_rm, x,
                                                          thr),
                    web_t, web_rm, x, thr, f"web-stanford B={B} thr={fused}")
    # folds that lose part of a row: the last slice of every row that has
    # more than one, or every row with fewer than 256 in-edges
    last = torch.ones_like(web_rm, dtype=torch.bool)
    last[:-1] = web_rm[1:] != web_rm[:-1]
    multi = torch.zeros_like(last)
    multi[1:] = web_rm[1:] == web_rm[:-1]
    no_rows = torch.zeros(web.n, dtype=torch.bool, device=dev)
    must_refuse("ell_spmm_sliced", web_t, web_rm,
                web_t[1] & ~(last & multi)[:, None], no_rows,
                "last slice of multi-slice rows")
    must_refuse("ell_spmm_sliced", web_t, web_rm, web_t[1],
                torch.from_numpy(web.in_degree < 256).to(dev),
                "rows of in-degree < 256 zeroed")
    # sliced edge cases: rows without a virtual row, W = 1, a single
    # virtual row, and padding rows (row_map == n) that must be dropped
    hub = small_test_graph(n=300, avg_deg=3.0, seed=3)
    cases = [("small W=8 (deg-0 rows)", sliced(small, 8)),
             ("W=1", sliced(hub, 1, 1))]
    one = Graph.from_edges(5, np.array([0, 1, 2, 3]), np.array([4, 4, 4, 4]))
    cases.append(("single virtual row", sliced(one, 8)))
    (nbr_s, msk_s, w_s), rm_s, thr_s = sliced(small, 8)
    pad, width = 37, nbr_s.shape[1]
    nbr_p = torch.cat([nbr_s, torch.randint(
        0, small.n, (pad, width), generator=gen, device=dev,
        dtype=torch.int32)])
    msk_p = torch.cat([msk_s, torch.ones((pad, width), dtype=torch.bool,
                                         device=dev)])
    w_p = torch.cat([w_s, torch.ones((pad, width), device=dev)])
    rm_p = torch.cat([rm_s, torch.full((pad,), small.n, dtype=torch.int32,
                                       device=dev)])
    cases.append(("padding rows row_map=n", ((nbr_p, msk_p, w_p), rm_p,
                                             thr_s)))
    for label, ((nbr, msk, w), rm, thr) in cases:
        n = int(thr.shape[0])
        for B in (1, 3):
            x = mass_rows(gen, B, n, dev)
            compare("ell_spmm_sliced",
                    lambda: ell_spmv.ell_spmm_sliced_cuda(nbr, msk, w, rm, x,
                                                          thr),
                    (nbr, msk, w), rm, x, thr, f"{label} B={B}")
    # a padding row must not leak into the real rows
    x = mass_rows(gen, 1, small.n, dev)
    y_pad = ell_spmv.ell_spmm_sliced_cuda(nbr_p, msk_p, w_p, rm_p, x)
    y_ref = ell_spmv.ell_spmm_sliced_cuda(nbr_s, msk_s, w_s, rm_s, x)
    check(bool(torch.equal(y_pad, y_ref)), "padding rows changed output")
    for name, st in stats.items():
        print(f"  {name}: max_abs_err {st['max_abs_err']:.3e}, largest "
              f"err/limit {st['ratio']:.4f}")

    launches = {}
    print("phase 2: dense path, fora_fused on small_test_graph(n=2000)")
    dg = small.device("cuda")
    check(dg.layout == "dense", f"expected dense, got {dg.layout}")
    srcs = np.array(DENSE_SOURCES)
    exact = ppr_power_iteration(small, srcs, device="cuda")
    ell_spmv.reset_launches()
    res = fora_fused(dg, srcs, ForaParams(epsilon=0.5), seed=0)
    pi = res.pi.cpu().numpy()
    launches["ell_spmm"] = ell_spmv.LAUNCHES["ell_spmm"]
    mask = exact >= 1.0 / small.n
    rel = float((np.abs(pi - exact)[mask] / exact[mask]).max())
    print(f"  push sweeps={int(res.push_iters)} walk lanes="
          f"{res.walks_budget} max rel err={rel:.4f} "
          f"row sums={np.round(pi.sum(axis=1), 5).tolist()} "
          f"launches={dict(ell_spmv.LAUNCHES)}")
    check(pi.shape == (len(srcs), small.n) and np.isfinite(pi).all(),
          "dense path: bad output")
    check(np.allclose(pi.sum(axis=1), 1.0, atol=1e-3),
          "dense path: rows do not sum to 1")
    check(rel < 0.5, f"dense path: FORA rel err {rel} >= eps")
    check(launches["ell_spmm"] > 0, "dense path never launched K1")

    print("phase 3: paper path, ForaExecutor -> dna_real on the "
          "full-size web-stanford stand-in")
    ell_spmv.reset_launches()
    t0 = time.perf_counter()
    out = quickstart.run(scale=1, num_queries=256,
                         check_sources=CHECK_SOURCES, device="cuda",
                         log=lambda s: print(f"  {s}"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches["ell_spmm_sliced"] = ell_spmv.LAUNCHES["ell_spmm_sliced"]
    print(f"  paper path: {json.dumps(out)}")
    print(f"  wall {wall:.1f}s launches={dict(ell_spmv.LAUNCHES)}")
    check(out["graph"]["n"] == 281903, "not the full-size graph")
    check(out["layout"] == "sliced", "paper path must be sliced")
    check(out["accepted"], "dna_real result not accepted")
    check(out["fora_max_rel_err"] < 0.5,
          f"FORA rel err {out['fora_max_rel_err']} >= eps")
    check(launches["ell_spmm_sliced"] > 0, "paper path never launched K2")
    profile_queries(web, 8)

    print(f"phase 4: kernel times (device time by torch.profiler; events = "
          f"host pace of back-to-back calls), card {card}")

    def timed(name, nbr, msk, w, rm, thr, x, label, reps=200):
        n, B = x.shape[1], x.shape[0]
        is_sliced = rm is not None
        if is_sliced:
            kern = lambda: ell_spmv.ell_spmm_sliced_cuda(  # noqa: E731
                nbr, msk, w, rm, x, thr)
        else:
            kern = lambda: ell_spmv.ell_spmm_cuda(  # noqa: E731
                nbr, msk, w, x, thr)
        keep = msk.reshape(-1)
        dst = (torch.arange(nbr.shape[0], device=dev) if rm is None
               else rm.long())[:, None].expand(nbr.shape).reshape(-1)
        a = torch.sparse_coo_tensor(
            torch.stack([dst[keep], nbr.reshape(-1)[keep].long()]),
            w.reshape(-1)[keep], (n, n)).coalesce().to_sparse_csr()
        xT = x.t().contiguous()
        lib = lambda: torch.sparse.mm(a, xT)  # noqa: E731
        _, lib_ratio = err_ratio(lib().t(), plain(nbr, msk, *f64(w), rm,
                                                  *f64(x, None)),
                                 LIBRARY_RTOL)
        check(lib_ratio <= 1.0, f"library yardstick disagrees for {name}")
        ms = device_ms(kern, reps)
        plain_ms = device_ms(lambda: plain(nbr, msk, w, rm, x, thr),
                             max(5, reps // 20))
        lib_ms = device_ms(lib, reps)
        ev_ms = events_ms(kern, reps)
        bound, by = spmm_cost(int(msk.sum()), n, B, nbr.shape[0],
                              thr is not None, is_sliced)
        print(f"  {name:16s} {label:38s} kernel {ms * 1e3:9.2f} us "
              f"(events {ev_ms * 1e3:9.2f} us)  bound "
              f"{bound * 1e3:8.2f} us ({by})  plain {plain_ms * 1e3:10.2f}"
              f" us  torch.sparse.mm {lib_ms * 1e3:9.2f} us  [{card}]")
        return ms, plain_ms, bound, by, lib_ms

    # host cost of one launch through ctypes, beside the wrapper's
    x3 = mass_rows(gen, 3, small.n, dev)
    lib = ell_spmv._lib()
    xT3, y3 = x3.t().contiguous(), torch.empty((small.n, 3), device=dev)
    raw = [t.data_ptr() for t in (*dense_t, xT3, dense_thr, y3)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1000):
        lib.ell_spmm_dense_launch(*raw, small.n, dense_t[0].shape[1], 3,
                                  stream)
    torch.cuda.synchronize()
    raw_us = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for _ in range(1000):
        ell_spmv.ell_spmm_cuda(*dense_t, x3, dense_thr)
    torch.cuda.synchronize()
    wrap_us = (time.perf_counter() - t0) * 1e3
    print(f"  host: raw ctypes launch {raw_us:.2f} us/call, checked "
          f"wrapper {wrap_us:.2f} us/call (n=2000, B=3, host clock)")
    # K1 at the dense path's shape, K2 at the paper path's (the executor's
    # block), both with the fused threshold as the push runs them
    k1 = timed("ell_spmm", *dense_t, None, dense_thr,
               mass_rows(gen, len(DENSE_SOURCES), small.n, dev),
               f"dense path n=2000 B={len(DENSE_SOURCES)}")
    k2 = timed("ell_spmm_sliced", *web_t, web_rm, web_thr,
               mass_rows(gen, ForaExecutor.block_size, web.n, dev),
               f"paper path web-stanford B={ForaExecutor.block_size}")
    for B in (CHECK_SOURCES, 8, 64):
        timed("ell_spmm_sliced", *web_t, web_rm, web_thr,
              mass_rows(gen, B, web.n, dev), f"web-stanford B={B}", reps=50)
    uni = small_test_graph(n=web.n, avg_deg=web.m / web.n, seed=1)
    uni_t, _, uni_thr = table(uni, "dense")
    for B in (1, 64):
        timed("ell_spmm", *uni_t, None, uni_thr,
              mass_rows(gen, B, uni.n, dev),
              f"uniform n={uni.n} K={uni_t[0].shape[1]} B={B}", reps=50)
    summary = []
    for name, (ms, plain_ms, bound, by, lib_ms) in (("ell_spmm", k1),
                                                    ("ell_spmm_sliced", k2)):
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": stats[name]["max_abs_err"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": lib_ms})
    print(json.dumps({"kernels": summary}))

    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
