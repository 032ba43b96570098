#!/usr/bin/env python3
"""Probe the live endpoint fold and the walk starts' CDF on one card.

    python3 tools/fold_probe.py
    python3 tools/fold_probe.py --variants

Builds ``csrc/endpoint_fold.cu`` and prints, one line a case:

* the fold against its float64 plain version (``|out - want| <= 1e-5 *
  |want| + 1e-6 * max|want|``, printed as err/limit), whether it gives the
  bits of its emulation (``ref.endpoint_fold_fixed_ref``) and whether a
  second launch gives the same bits, over uniform endpoints, lanes past a
  row's active count (weight 0), every lane at one node, and a fifth of
  the lanes at one node, at shapes from one lane to the Pokec order's 2^22
  lanes;
* how often 20 calls of ``torch.cumsum`` over the same residual rows give
  the bits of the first, against the fixed-order scan the walks use on the
  card (``random_walk.scan_prefix_sums``), and the scan's largest relative
  difference from a float64 cumulative sum.

Exits non-zero on a case over its limit, off its emulation's bits, or a
launch that repeats other bits. Needs a card; prints the card's name and
power limit first.

With ``--variants`` it times the design choices of ``add_lanes`` instead:
the source as it is and copies of it edited in one place each (every
cell claiming a slot, no table, only a warp's shared cells claiming, a
lone lane claiming 1 in 4 or 1 in 8, a 64-bit shared atomicAdd), each
built with the port's nvcc flags into ``build/tools/`` and called through
the same C interface, on the paper path's walk endpoints (web-stanford at
full size, 2^20 lanes, the first 8 queries' rows, B = 1 and 8), uniform
endpoints and a hub. It prints the device µs of each kernel (under
``torch.profiler``, a mean over 10 calls) and whether the variant gives
the emulation's bits (each is an exact integer sum, so all must).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import _build, endpoint_fold, ref  # noqa: E402
from repro_torch.ppr.random_walk import scan_prefix_sums  # noqa: E402

SHAPES = [(1, 1, 5), (1, 100, 10), (3, 9000, 2000), (1, 1 << 20, 281_903),
          (3, 1 << 20, 281_903), (8, 1 << 20, 281_903), (1, 1 << 18, 2000),
          (2, 1 << 22, 1_632_803), (5, 8193, 513)]
CASES = ("uniform", "active", "hub", "skew")


def case_inputs(case: str, B: int, W: int, n: int, gen, dev):
    pos = torch.randint(0, n, (B, W), generator=gen, device=dev,
                        dtype=torch.int32)
    w = torch.rand((B, W), generator=gen, device=dev)
    if case == "active":
        act = torch.randint(1, W + 1, (B, 1), generator=gen, device=dev)
        w = torch.where(torch.arange(W, device=dev)[None] < act, w, 0.0)
    elif case == "hub":
        pos.fill_(n // 2)
    elif case == "skew":
        at = torch.rand((B, W), generator=gen, device=dev) < 0.2
        pos = torch.where(at, min(7, n - 1), pos).to(torch.int32)
    return pos.contiguous(), w.contiguous()


# one edit of csrc/endpoint_fold.cu each: (text as it is, text instead)
CLAIMS = ("    const bool claims =\n"
          "        count > 1 || (i * 2654435761u) >> (32 - kSampleBits) "
          "== 0u;")
VARIANTS = {
    "as built": (),
    "every cell claims": ((CLAIMS, "    const bool claims = true;"),),
    "no table": (("constexpr int kProbes = 32;",
                  "constexpr int kProbes = 0;"),),
    "warp-shared cells claim": ((CLAIMS,
                                 "    const bool claims = count > 1;"),),
    "lone lanes claim 1 in 4": (("constexpr int kSampleBits = 1;",
                                 "constexpr int kSampleBits = 2;"),),
    "lone lanes claim 1 in 8": (("constexpr int kSampleBits = 1;",
                                 "constexpr int kSampleBits = 3;"),),
    "64-bit shared atomicAdd": ((
        "  unsigned* word = reinterpret_cast<unsigned*>(value);\n"
        "  const unsigned lo = static_cast<unsigned>(q);\n"
        "  const unsigned old = atomicAdd(word, lo);\n"
        "  atomicAdd(word + 1, static_cast<unsigned>(q >> 32) + (old + lo < "
        "old));", "  atomicAdd(value, q);"),),
}


def build_variants() -> dict[str, ctypes.CDLL]:
    """Each variant's library, built in parallel into build/tools/."""
    src = (_build.CSRC / _build.SOURCES["endpoint_fold"]).read_text()
    out = _build.BUILD_DIR.parent / "tools"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its edit no longer "
                                   f"matches csrc/endpoint_fold.cu")
            text = text.replace(old, new)
        cu = out / f"fold_variant_{i}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} did not build:\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.endpoint_fold_launch.argtypes = (
            endpoint_fold._SIGNATURES["endpoint_fold_launch"][0])
        lib.endpoint_fold_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def variant_fold(lib, pos, w, n):
    B, W = pos.shape
    parts, log_w = endpoint_fold.fold_scratch(n, W)
    dev = pos.device
    sums = torch.empty((B, n), dtype=torch.int64, device=dev)
    maxima = torch.empty((B, parts), dtype=torch.int32, device=dev)
    shift = torch.empty((B,), dtype=torch.int32, device=dev)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    err = lib.endpoint_fold_launch(
        pos.data_ptr(), w.data_ptr(), sums.data_ptr(), maxima.data_ptr(),
        shift.data_ptr(), out.data_ptr(), n, W, B, parts, log_w,
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def kernel_us(fn, reps: int = 10) -> dict[str, float]:
    """Device µs a call of ``fn`` by kernel, under ``torch.profiler``."""
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
            name = e.name.removeprefix("(anonymous namespace)::")
            name = name.split("(")[0]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / reps
    return out


def paper_rows(dev, B: int):
    """The walk endpoints and weights of the paper path's first B queries
    at its calibrated lane count (phase 9 of chip_smoke.py)."""
    from repro_torch.ppr import (ForaExecutor, ForaParams, PprWorkload,
                                 QueryDraws, forward_push, load,
                                 sample_walk_starts, walk_endpoints,
                                 walk_length_for_tail)
    from repro_torch.ppr.forward_push import one_hot_seeds
    from repro_torch.ppr.random_walk import lane_weights

    web = load("web-stanford", scale=1)
    params = ForaParams(epsilon=0.5)
    ex = ForaExecutor(workload=PprWorkload(web, 256, seed=0), params=params,
                      device=dev)
    ex.warmup()
    W, dg = ex.current_walk_budget(), ex.device_graph
    rp = params.resolve(dg)
    push = forward_push(dg.in_neighbors, dg.in_mask, dg.in_weights,
                        dg.out_degree,
                        one_hot_seeds(ex.workload.sources[:B], web.n, dev),
                        alpha=rp.alpha, rmax=rp.rmax, row_map=dg.in_row_map,
                        fold=dg.in_fold)
    draws = QueryDraws(0, range(B), W, dev)
    starts, r_sum = sample_walk_starts(push.r.contiguous(),
                                       draws.start_uniforms())
    L = walk_length_for_tail(rp.alpha, rp.walk_tail)
    pos = walk_endpoints(dg.edge_dst, dg.out_offsets, dg.out_degree, starts,
                         (draws.step(t) for t in range(L)),
                         alpha=rp.alpha).contiguous()
    need = torch.clamp(torch.ceil(r_sum * rp.omega), min=1.0)
    w_eff = torch.clamp(torch.exp2(torch.ceil(torch.log2(need))), 1.0,
                        float(W)).to(torch.int32)
    return pos, lane_weights(r_sum, W, w_eff).contiguous(), web.n


def variants(dev) -> int:
    libs = build_variants()
    pos, weights, n = paper_rows(dev, 8)
    W = pos.shape[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    bad = 0
    for B in (1, 8):
        cases = {
            "paper": (pos[:B].contiguous(), weights[:B].contiguous()),
            "uniform": (torch.randint(0, n, (B, W), generator=gen, device=dev,
                                      dtype=torch.int32),
                        torch.rand((B, W), generator=gen, device=dev)),
            "hub": (torch.full((B, W), n // 2, dtype=torch.int32, device=dev),
                    torch.rand((B, W), generator=gen, device=dev))}
        for case, (p, w) in cases.items():
            want = ref.endpoint_fold_fixed_ref(p, w, n)
            for name, lib in libs.items():
                same = bool(torch.equal(variant_fold(lib, p, w, n), want))
                split = kernel_us(lambda: variant_fold(lib, p, w, n))
                bad += not same
                print(f"fold {case:7s} B={B} W={W} n={n} {name:24s} "
                      f"{sum(split.values()):9.2f} us ("
                      + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
                      + f"); emulation's bits {same}", flush=True)
    return 1 if bad else 0


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("fold_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if argv == ["--variants"]:
        return variants(torch.device("cuda", torch.cuda.current_device()))
    _build.build(["endpoint_fold"])
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(0)
    worst, bad = 0.0, 0
    for B, W, n in SHAPES:
        for case in CASES:
            pos, w = case_inputs(case, B, W, n, gen, dev)
            out = endpoint_fold.endpoint_fold_cuda(pos, w, n)
            want = ref.endpoint_fold_ref(pos, w.double(), n)
            limit = 1e-5 * want.abs() + 1e-6 * float(want.abs().max())
            ratio = float(((out.double() - want).abs()
                           / limit.clamp_min(1e-300)).max())
            same = bool(torch.equal(out, endpoint_fold.endpoint_fold_cuda(
                pos, w, n)))
            fixed = bool(torch.equal(out, ref.endpoint_fold_fixed_ref(
                pos, w, n)))
            worst = max(worst, ratio)
            bad += ratio > 1.0 or not same or not fixed
            print(f"fold {case:8s} B={B} W={W} n={n}: err/limit "
                  f"{ratio:.4f}, emulation's bits {fixed}, second launch "
                  f"same bits {same}")
    print(f"fold: {len(SHAPES) * len(CASES)} cases, largest err/limit "
          f"{worst:.4f}, {bad} failed")
    for B in (1, 3, 8):
        x = torch.rand((B, 281_903), generator=gen, device=dev) ** 3
        cums = [torch.cumsum(x, dim=-1) for _ in range(20)]
        scans = [scan_prefix_sums(x) for _ in range(20)]
        exact = torch.cumsum(x.double(), dim=-1)
        rel = float(((scans[0].double() - exact).abs() / exact).max())
        print(f"start CDF B={B} n=281903: torch.cumsum repeats its bits "
              f"{sum(torch.equal(cums[0], c) for c in cums)}/20, the scan "
              f"{sum(torch.equal(scans[0], s) for s in scans)}/20; scan vs "
              f"float64 max rel {rel:.3e}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
