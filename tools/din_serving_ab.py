#!/usr/bin/env python3
"""DIN serving end to end on one NVIDIA card, for comparing two trees of
the port on the same card:

    python3 tools/din_serving_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (``.`` for this one); each runs in
its own process, in the order given, and prints one JSON line: DIN at its
full size (10M x 18 items, 100k x 18 categories, random float32 weights
from seed 0) answering 200 serve_p99 requests (B = 512, L = 100; p50 and
p99 ms, host clock to a device synchronisation) and 1,000,000 candidates
in blocks of 8,192, unfactored and factored (the median of 3 runs each, in
seconds); then 10 requests and one factored retrieval under
``torch.profiler``: wall, device time and the card's idle share, and K5's
device microseconds a launch and launches by kernel name (every kernel
whose name holds ``bag_``). The shapes are phase 7 of ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time

REQUESTS, PROFILED, RUNS, BLOCK = 200, 10, 3, 8192


def leg(tree: str) -> dict:
    sys.path.insert(0, f"{tree}/src")
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build

    _build.build(["embedding_bag"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    arch = get_arch("din")
    params = arch.init_params(gen, dev)
    serve_b = arch.make_inputs("serve_p99", gen, dev)
    ret_b = arch.make_inputs("retrieval_cand", gen, dev)
    serve = arch.build_step("serve_p99")
    steps = {"unfactored": arch.build_step("retrieval_cand", block=BLOCK),
             "factored": arch.build_step("retrieval_cand", block=BLOCK,
                                         factored=True)}

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    timed(lambda: serve(params, serve_b))                       # warm up
    lat = [timed(lambda: serve(params, serve_b)) * 1e3
           for _ in range(REQUESTS)]
    retrieval = {}
    for name, step in steps.items():
        timed(lambda: step(params, ret_b))                      # warm up
        retrieval[name] = float(np.median(
            [timed(lambda: step(params, ret_b)) for _ in range(RUNS)]))

    def profiled(fn, calls: int) -> dict:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = timed(lambda: [fn() for _ in range(calls)])
        ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in ev)
        k5: dict[str, list[float]] = {}
        for e in ev:
            m = re.search(r"\bbag_\w+", e.name)
            if m:
                k5.setdefault(m.group(0), []).append(
                    e.time_range.elapsed_us())
        return {"wall_ms": wall * 1e3 / calls,
                "device_ms": busy / 1e3 / calls,
                "idle": 1 - busy / (wall * 1e6),
                "k5_us": {k: sum(ts) / len(ts) for k, ts in k5.items()},
                "k5_launches": {k: len(ts) for k, ts in k5.items()}}

    return {"tree": tree, "card": torch.cuda.get_device_name(0),
            "serve_p50_ms": float(np.percentile(lat, 50)),
            "serve_p99_ms": float(np.percentile(lat, 99)),
            "retrieval_s": retrieval,
            "serve_profile": profiled(lambda: serve(params, serve_b),
                                      PROFILED),
            "retrieval_profile": profiled(
                lambda: steps["factored"](params, ret_b), 1)}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--leg":
        print(json.dumps(leg(argv[1])), flush=True)
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
