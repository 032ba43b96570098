#!/usr/bin/env python3
"""Probe the live endpoint fold and the walk starts' CDF on one card.

    python3 tools/fold_probe.py

Builds ``csrc/endpoint_fold.cu`` and prints, one line a case:

* the fold against its float64 plain version (``|out - want| <= 1e-5 *
  |want| + 1e-6 * max|want|``, printed as err/limit) and whether a second
  launch gives the same bits, over uniform endpoints, lanes past a row's
  active count (weight 0), every lane at one node, and a fifth of the lanes
  at one node, at shapes from one lane to the Pokec order's 2^22 lanes;
* how often 20 calls of ``torch.cumsum`` over the same residual rows give
  the bits of the first, against the fixed-order scan the walks use on the
  card (``random_walk.scan_prefix_sums``), and the scan's largest relative
  difference from a float64 cumulative sum.

Exits non-zero on a case over its limit or a launch that repeats other
bits. Needs a card; prints the card's name and power limit first.
"""

from __future__ import annotations

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


def main() -> int:
    if not torch.cuda.is_available():
        print("fold_probe: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
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
            worst = max(worst, ratio)
            bad += ratio > 1.0 or not same
            print(f"fold {case:8s} B={B} W={W} n={n}: err/limit "
                  f"{ratio:.4f}, second launch same bits {same}")
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
    sys.exit(main())
